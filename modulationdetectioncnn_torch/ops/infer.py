"""int8 VT-CNN2 inference: the fused stages and the v7, v9 and v10 classifiers.

Counterpart of ``modulationdetectioncnn_tpu/ops/infer.py``'s v7, v9 and v10
paths. The three classifiers share the dense stage and differ in the conv
stage: v7 runs conv1 on integers, v9 and v10 run conv1 as a bf16 product
against requantize-folded weights (``quant.fold_conv1_weights``) and conv2
on int8 tensor cores; v10 also prefetches the next frame while the current
one's products run. Each stage has three pieces in this module:

- the wrapper (``conv_stage_int8_v7``, ``conv_stage_int8_v9``,
  ``conv_stage_int8_v10``, ``dense_argmax_int8``): on a CUDA
  tensor it launches the hand-written kernel of ``csrc/`` and counts the
  launch in its ``launches`` attribute, or raises; on a CPU tensor it runs
  the plain version. There is no fallback from one to the other.
- the plain version (``*_plain``): integer PyTorch ops, device-agnostic,
  used by the CPU tests and by ``chip_smoke.py`` to hold the kernel to the
  same inputs on the card. Integer products go through float64 matmuls,
  which are exact here (every partial sum is an integer below 2**53).
- the kernel's source note, at the top of its ``.cu`` file: the TPU kernel
  it replaces, its bound on the H100 and what its design does about it.

Shapes are the JAX package's public ones: frames (B, 2, 128) f32 in,
labels (B,) int32 out. The conv map is the compact (B, 124, 80) int8; the
TPU kernel's (B, 128, 128) layout padding is not reproduced. The kernels
take any B: a ragged batch needs no padding.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from modulationdetectioncnn_torch.ops import _build
from modulationdetectioncnn_torch.ops.requant import quantize_input, requantize
from modulationdetectioncnn_torch.quant import Int8Weights

# The widths the CUDA kernels are compiled for (the full-width VT-CNN2).
FRAME_LEN, C1, C2, DENSE, N_CLASSES = 128, 256, 80, 256, 11
T2 = FRAME_LEN - 4


def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8/int32 operands -> exact int32 product via float64."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


# ------------------------------------------------------------- conv stage


def conv1_int8_plain(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """(B, 2, T) f32 -> stacked (B, T-2, 2C) int8: quantize -> conv1 -> rq1,
    channel h*C + c for I/Q plane h (golden/quant.py::conv1_int8)."""
    xq = quantize_input(x, qw.inv_sx).to(torch.int32)          # (B, 2, T)
    t1 = x.shape[-1] - 2
    w1 = qw.w1.to(torch.int32)                                  # (3, C)
    acc1 = sum(xq[:, :, k:k + t1, None] * w1[k] for k in range(3))
    acc1 = acc1.permute(0, 2, 1, 3).reshape(x.shape[0], t1, -1)
    return requantize(acc1, qw.m1, qw.o1)


def conv_stage_int8_v7_plain(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """(B, 2, T) f32 -> (B, T-4, C2) int8: quantize -> conv1 -> rq1 ->
    conv2 -> rq2, the integer spec of golden/quant.py."""
    a1 = conv1_int8_plain(x, qw)                                # (B, t1, 2C)
    k1, t2 = a1.shape[-1], a1.shape[1] - 2
    acc2 = sum(_exact_matmul(a1[:, k:k + t2], qw.w2t[:, k * k1:(k + 1) * k1].T)
               for k in range(3))
    return requantize(acc2, qw.m2, qw.o2)


# The weights each CUDA entry point reads.
_KERNEL_WEIGHTS = {
    "conv_stage_int8_v7": ("w1", "m1", "o1", "w2t", "m2", "o2"),
    "conv_stage_int8_v9": ("w1f", "w2l", "m2", "o2"),
    "conv_stage_int8_v10": ("w1f", "w2l", "m2", "o2"),
    "dense_argmax_int8": ("w3t", "m3", "o3", "w4", "s4", "b4"),
}


def _check_cuda_args(name: str, tensors: dict, qw: Int8Weights) -> None:
    dev = next(iter(tensors.values())).device
    keys = _KERNEL_WEIGHTS[name]
    for key, t in {**tensors, **{k: getattr(qw, k) for k in keys}}.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, input on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: {key} must be 4-byte aligned")
    want = {"w1": (3, C1), "w2t": (C2, 6 * C1), "w1f": (16, 2 * C1),
            "w2l": (2 * C1, 3 * C2), "w3t": (DENSE, T2 * C2),
            "w4": (DENSE, N_CLASSES)}
    for key, shape in want.items():
        if key in keys and tuple(getattr(qw, key).shape) != shape:
            raise ValueError(f"{name}: the CUDA kernel is built for {key} "
                             f"{shape}, got {tuple(getattr(qw, key).shape)}")


def conv_stage_int8_v7(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """Fused conv stage, (B, 2, 128) f32 -> (B, 124, 80) int8. Launches
    ``csrc/conv_stage_int8.cu`` on a CUDA tensor; plain version on the CPU."""
    if x.device.type == "cpu":
        return conv_stage_int8_v7_plain(x, qw)
    if x.device.type != "cuda":
        raise ValueError(f"conv_stage_int8_v7: unsupported device {x.device}")
    if x.dtype != torch.float32 or tuple(x.shape[1:]) != (2, FRAME_LEN):
        raise ValueError(f"conv_stage_int8_v7: expected (B, 2, {FRAME_LEN}) "
                         f"float32, got {tuple(x.shape)} {x.dtype}")
    b = x.shape[0]
    out = torch.empty((b, T2, C2), dtype=torch.int8, device=x.device)
    if b == 0:
        return out
    _check_cuda_args("conv_stage_int8_v7", {"x": x}, qw)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        code = lib.amc_conv_stage_int8_v7(
            x.data_ptr(), b, qw.w1.data_ptr(), qw.m1.data_ptr(),
            qw.o1.data_ptr(), qw.w2t.data_ptr(), qw.m2.data_ptr(),
            qw.o2.data_ptr(), qw.inv_sx, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "conv_stage_int8_v7", code)
    conv_stage_int8_v7.launches += 1
    return out


conv_stage_int8_v7.launches = 0


def conv1_folded_plain(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """(B, 2, T) f32 -> stacked (B, T-2, 2C) int8 through the folded conv1:
    a float32 (m, 8) x (8, 2C) product of bf16-exact values, then
    ``clip(., 0, 127)`` truncated to int8. Equal to ``conv1_int8_plain``
    whenever ``quant.fold_conv1_weights`` accepted the model."""
    xq = quantize_input(x, qw.inv_sx).to(torch.float32)        # (B, 2, T)
    t1 = x.shape[-1] - 2
    taps = [xq[:, h, k:k + t1] for k in range(3) for h in range(2)]  # 2k+h
    ones = torch.ones_like(taps[0])
    a = torch.stack(taps + [ones, torch.zeros_like(ones)], dim=-1)  # (B, t1, 8)
    f = torch.matmul(a, qw.w1f[:8].to(torch.float32))           # exact in f32
    return f.clamp(0.0, 127.0).to(torch.int8)                   # truncation


def conv_stage_int8_folded_plain(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """The plain version of the v9 and v10 conv stages, (B, 2, T) f32 ->
    (B, T-4, C2) int8: folded conv1, then conv2 as one (m, 2C) x (2C, 3*C2)
    integer product against the taps-on-N weight and the shift-add
    ``s[t, co] = z[t, co] + z[t+1, C2+co] + z[t+2, 2*C2+co]``, then rq2."""
    a1 = conv1_folded_plain(x, qw)                              # (B, t1, 2C)
    c2, t2 = qw.m2.shape[0], a1.shape[1] - 2
    z = _exact_matmul(a1, qw.w2l)                               # (B, t1, 3*C2)
    s = sum(z[:, k:k + t2, k * c2:(k + 1) * c2] for k in range(3))
    return requantize(s, qw.m2, qw.o2)


def _launch_folded(wrapper, x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """Argument checks and launch of the v9/v10 CUDA entry point named after
    ``wrapper`` (``csrc/conv_stage_int8_v10.cu``), counted on ``wrapper``;
    returns the (B, 124, 80) int8 map."""
    name = wrapper.__name__
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32 or tuple(x.shape[1:]) != (2, FRAME_LEN):
        raise ValueError(f"{name}: expected (B, 2, {FRAME_LEN}) float32, "
                         f"got {tuple(x.shape)} {x.dtype}")
    b = x.shape[0]
    out = torch.empty((b, T2, C2), dtype=torch.int8, device=x.device)
    if b == 0:
        return out
    _check_cuda_args(name, {"x": x}, qw)
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned (cp.async)")
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        code = getattr(lib, f"amc_{name}")(
            x.data_ptr(), b, qw.w1f.data_ptr(), qw.w2l.data_ptr(),
            qw.m2.data_ptr(), qw.o2.data_ptr(), qw.inv_sx, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, name, code)
    wrapper.launches += 1
    return out


def conv_stage_int8_v9(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """v9 conv stage, (B, 2, 128) f32 -> (B, 124, 80) int8: folded bf16
    conv1 and int8 conv2 on the tensor cores, frame by frame. Launches
    ``csrc/conv_stage_int8_v10.cu``'s v9 entry on a CUDA tensor; plain
    version on the CPU."""
    if x.device.type == "cpu":
        return conv_stage_int8_folded_plain(x, qw)
    return _launch_folded(conv_stage_int8_v9, x, qw)


conv_stage_int8_v9.launches = 0


def conv_stage_int8_v10(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """v10 conv stage: v9's arithmetic, with the next frame's input
    prefetched (``cp.async``) while the current frame's products run.
    Launches ``csrc/conv_stage_int8_v10.cu``'s v10 entry on a CUDA tensor;
    plain version on the CPU."""
    if x.device.type == "cpu":
        return conv_stage_int8_folded_plain(x, qw)
    return _launch_folded(conv_stage_int8_v10, x, qw)


conv_stage_int8_v10.launches = 0


# ------------------------------------------------------- dense + argmax


def dense_argmax_int8_plain(h: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """(B, T2*C2) int8 -> (B,) int32 labels: dense1 -> rq3 -> dense2 ->
    f32 multiply, then add -> argmax with ties to the lowest index."""
    h = h.reshape(h.shape[0], -1)
    a3 = requantize(_exact_matmul(h, qw.w3t.T), qw.m3, qw.o3)
    acc4 = _exact_matmul(a3, qw.w4)
    logits = acc4.to(torch.float32) * qw.s4
    logits = logits + qw.b4
    mx = logits.max(dim=-1, keepdim=True).values
    lane = torch.arange(logits.shape[-1], device=h.device, dtype=torch.int32)
    idx = torch.where(logits >= mx, lane, torch.iinfo(torch.int32).max)
    return idx.min(dim=-1).values.to(torch.int32)


def dense_argmax_int8(h: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """Fused dense stage, (B, 124, 80) or (B, 9920) int8 -> (B,) int32.
    Launches ``csrc/dense_argmax_int8.cu`` on a CUDA tensor; plain version
    on the CPU."""
    if h.device.type == "cpu":
        return dense_argmax_int8_plain(h, qw)
    if h.device.type != "cuda":
        raise ValueError(f"dense_argmax_int8: unsupported device {h.device}")
    b = h.shape[0]
    if h.dtype != torch.int8 or math.prod(h.shape[1:]) != T2 * C2:
        raise ValueError(f"dense_argmax_int8: expected (B, {T2 * C2}) int8, "
                         f"got {tuple(h.shape)} {h.dtype}")
    out = torch.empty((b,), dtype=torch.int32, device=h.device)
    if b == 0:
        return out
    h = h.reshape(b, T2 * C2)
    _check_cuda_args("dense_argmax_int8", {"h": h}, qw)
    lib = _build.load_library()
    with torch.cuda.device(h.device):
        code = lib.amc_dense_argmax_int8(
            h.data_ptr(), b, qw.w3t.data_ptr(), qw.m3.data_ptr(),
            qw.o3.data_ptr(), qw.w4.data_ptr(), qw.s4.data_ptr(),
            qw.b4.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "dense_argmax_int8", code)
    dense_argmax_int8.launches += 1
    return out


dense_argmax_int8.launches = 0


KERNEL_WRAPPERS = (conv_stage_int8_v7, conv_stage_int8_v9, conv_stage_int8_v10,
                   dense_argmax_int8)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


# ------------------------------------------------------------ classifiers

CONV_STAGES = {"v7": conv_stage_int8_v7, "v9": conv_stage_int8_v9,
               "v10": conv_stage_int8_v10}


def _conv_stage_fn(version: str, qw: Int8Weights):
    """The conv stage of ``version``. For v9/v10 this also builds the
    folded conv1, so a model that breaks the fold's contract raises
    ``ValueError`` here rather than at its first batch."""
    if version not in CONV_STAGES:
        raise NotImplementedError(
            f"int8 kernel version {version!r} is not ported yet "
            f"(ROADMAP.md, Queue 2); use one of {'/'.join(CONV_STAGES)}")
    if version != "v7":
        qw.w1f
    return CONV_STAGES[version]


def _make_classifier(qw: Int8Weights, version: str):
    stage = _conv_stage_fn(version, qw)

    def classify(x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=qw.device, dtype=torch.float32)
        return dense_argmax_int8(stage(x.contiguous(), qw), qw)

    return classify


def make_int8_classifier_v7(qw: Int8Weights) -> Callable[[torch.Tensor], torch.Tensor]:
    """(B, 2, T) f32 -> (B,) int32 labels on the weights' device, through
    the two fused stages. Bit-exact against golden/quant.py."""
    return _make_classifier(qw, "v7")


def make_int8_classifier_v9(qw: Int8Weights) -> Callable[[torch.Tensor], torch.Tensor]:
    """As v7, with the v9 conv stage (folded conv1, tensor-core conv2)."""
    return _make_classifier(qw, "v9")


def make_int8_classifier_v10(qw: Int8Weights) -> Callable[[torch.Tensor], torch.Tensor]:
    """As v9, with the v10 conv stage (input prefetch across frames)."""
    return _make_classifier(qw, "v10")


def make_conv_stage(qw: Int8Weights, version: str = "v7"):
    """The conv stage alone: (B, 2, T) f32 -> (B, T-4, C2) int8."""
    stage = _conv_stage_fn(version, qw)

    def conv_stage(x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=qw.device, dtype=torch.float32)
        return stage(x.contiguous(), qw)

    return conv_stage


def make_int8_predict(qw: Int8Weights, version: str = "v7"):
    """Version-selectable int8 label predictor: v7, v9 or v10."""
    return _make_classifier(qw, version)
