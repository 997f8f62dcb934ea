"""int8 VT-CNN2 inference: the fused stages and the v1-v10 classifiers.

Counterpart of ``modulationdetectioncnn_tpu/ops/infer.py``'s int8 v1 to
v10 paths (its bf16 v4 classifier is ``ops/infer_bf16.py``). The
classifiers share the dense stage (v1, v2: the dense stage without the
argmax, which returns logits) and differ in the conv stage, which all
compute one function (the integer spec of ``golden/quant.py``) from
different inputs and with different conv1 arithmetic:

- v7: frames in, conv1 on integers (``__dp4a`` on the CUDA cores, built
  in shared memory by producer warps), conv2 on int8 ``wgmma``;
- v9, v10: frames in, conv1 as a bf16 product against requantize-folded
  weights (``quant.fold_conv1_weights``), conv2 on int8 tensor cores; v10
  also prefetches the next frame while the current one's products run;
- v5: frames in, v7's producers and consumer from the tap-plane conv1
  ``w1e`` and the taps-on-N conv2 ``w2l`` (the weights the TPU's v5 read);
- v1: v5's kernel body under its own entry point (the two TPU kernels
  differed only in how Mosaic scheduled conv1), feeding the dense stage
  that returns logits (``make_int8_forward``), whose argmax is the label;
- v4, v6: (B, 8, T) int8 tap planes in (quantize and ``tap_planes`` in
  plain torch first, as the JAX package did them in XLA), then v5's
  producers and consumer with the producers reading the planes (planes
  0..5 and each plane's own block of ``w1e``: the window of a row is its
  column of planes 3h..3h+2) in place of quantizing frames; one kernel
  body under both entry points (the two TPU kernels differed only in how
  Mosaic scheduled the chunk loop).
- v2, v3: (B, T-2, 8) int8 tap rows in (quantize and ``expand_taps`` in
  plain torch first, as in the JAX package), the transposed layout of the
  planes, then the tap-row body on ``csrc/conv_stage_int8_mma.cuh`` (conv1
  as an int8 ``mma.sync`` product, integer rq1, conv2 on ``mma.sync`` with
  the weight resident); v3 prefetches the next
  frame's rows and feeds the dense + argmax stage, v2 feeds the dense
  stage that returns logits (``make_int8_forward_v2``) and takes their
  argmax.

v2 to v6 need no fold, so a model that the fold refuses still gets a
tensor-core path. Each stage has three pieces in this module:

- the wrapper (``conv_stage_int8_v*``, ``dense_argmax_int8``,
  ``dense_int8``): on a CUDA
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
labels (B,) int32 (or v1/v2's (B, NC) f32 logits) out. The conv map is the
compact (B, 124, C2) int8; the TPU kernels' (B, 128, 128) layout padding and
v3's garbage rows are not reproduced. The kernels
are compiled for the full-width model; a narrower one runs padded to it
(``quant.pad_to_kernel_widths``), and the conv-stage wrappers return the
model's own ``[:, :, :c2]`` map. The kernels take any B: a ragged batch
needs no padding.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping

import torch

from modulationdetectioncnn_torch.ops import _build
from modulationdetectioncnn_torch.ops.requant import quantize_input, requantize
from modulationdetectioncnn_torch.quant import (
    C1, C2, DENSE, FRAME_LEN, N_CLASSES, T2, Int8Weights, QuantizedModel,
    int8_weights_from_numpy)


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


def _conv2_plain(a1: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """Stacked conv1 activations (B, t1, 2C) int8 -> (B, t1-2, C2) int8:
    conv2 over the three rows t..t+2, then rq2."""
    k1, t2 = a1.shape[-1], a1.shape[1] - 2
    acc2 = sum(_exact_matmul(a1[:, k:k + t2], qw.w2t[:, k * k1:(k + 1) * k1].T)
               for k in range(3))
    return requantize(acc2, qw.m2, qw.o2)


def conv_stage_int8_v7_plain(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """(B, 2, T) f32 -> (B, T-4, C2) int8: quantize -> conv1 -> rq1 ->
    conv2 -> rq2, the integer spec of golden/quant.py. C2 is the carried
    width (the kernels' for a padded model)."""
    return _conv2_plain(conv1_int8_plain(x, qw), qw)


def tap_planes(x: torch.Tensor, inv_sx: float) -> torch.Tensor:
    """The v4/v6 prologue, (B, 2, T) f32 -> (B, 8, T) int8 tap planes:
    quantize, then plane 3h+k holds ``xq[:, h, k:k+T-2]`` followed by two
    zeros; planes 6 and 7 are zero (the JAX package's quantize +
    ``expand_tap_planes``, which it ran in XLA). Plain torch ops."""
    xq = quantize_input(x, inv_sx)
    b, _, t = xq.shape
    planes = torch.zeros((b, 8, t), dtype=torch.int8, device=x.device)
    for h in range(2):
        for k in range(3):
            planes[:, 3 * h + k, :t - k] = xq[:, h, k:]
    planes[:, :6, t - 2:] = 0
    return planes


def conv_stage_int8_planes_plain(xp: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """The plain version of the v4/v6 conv stages, (B, 8, T) int8 tap
    planes -> (B, T-4, C2) int8: conv1 as one (m, 8) x (8, 2C) integer
    product of the planes against ``w1e``, rq1, then conv2 and rq2."""
    t1 = xp.shape[-1] - 2
    acc1 = _exact_matmul(xp.transpose(1, 2)[:, :t1], qw.w1e)   # (B, t1, 2C)
    return _conv2_plain(requantize(acc1, qw.m1, qw.o1), qw)


def tap_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, 2, T) -> (B, T-2, 8) of x's dtype: lane 3h+k of row t holds
    ``x[:, h, t+k]``, lanes 6 and 7 are zero (the JAX package's
    ``expand_taps``)."""
    t1 = x.shape[-1] - 2
    cols = [x[:, h, k:k + t1] for h in range(2) for k in range(3)]
    zero = torch.zeros_like(cols[0])
    return torch.stack(cols + [zero, zero], dim=-1)


def expand_taps(x: torch.Tensor, inv_sx: float) -> torch.Tensor:
    """The v2/v3 prologue, (B, 2, T) f32 -> (B, T-2, 8) int8 tap rows:
    quantize, then ``tap_rows`` (the JAX package's quantize +
    ``expand_taps``, which it ran in XLA; the transpose of ``tap_planes``
    without its two tail columns). Plain torch ops."""
    return tap_rows(quantize_input(x, inv_sx))


def conv_stage_int8_taps_plain(xe: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """The plain version of the v2 and v3 conv stages, (B, T-2, 8) int8 tap
    rows -> (B, T-4, C2) int8: conv1 as one (m, 8) x (8, 2C) integer product
    of the rows against ``w1e``, rq1, then conv2 and rq2."""
    acc1 = _exact_matmul(xe, qw.w1e)                            # (B, t1, 2C)
    return _conv2_plain(requantize(acc1, qw.m1, qw.o1), qw)


def conv_stage_int8_v5_plain(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """The plain version of the v5 conv stage, (B, 2, T) f32 -> (B, T-4, C2)
    int8: the tap planes the kernel builds from the quantized frame, then
    v4's arithmetic."""
    return conv_stage_int8_planes_plain(tap_planes(x, qw.inv_sx), qw)


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


# ------------------------------------------------------- dense + argmax


def dense_int8_plain(h: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """(B, T2*C2) int8 -> (B, NC) f32 logits: dense1 -> rq3 -> dense2 ->
    ``float(acc4) * s4``, then ``+ b4`` (two roundings, no fused
    multiply-add). NC is the carried width (11 for a padded model, whose
    padded classes read -inf)."""
    h = h.reshape(h.shape[0], -1)
    a3 = requantize(_exact_matmul(h, qw.w3t.T), qw.m3, qw.o3)
    acc4 = _exact_matmul(a3, qw.w4)
    logits = acc4.to(torch.float32) * qw.s4
    return logits + qw.b4


def argmax_lowest(logits: torch.Tensor) -> torch.Tensor:
    """(B, N) -> (B,) int32: the index of the largest value, ties to the
    lowest index (``jnp.argmax``; the dense kernel's strict ``>``)."""
    mx = logits.max(dim=-1, keepdim=True).values
    lane = torch.arange(logits.shape[-1], device=logits.device, dtype=torch.int32)
    idx = torch.where(logits >= mx, lane, torch.iinfo(torch.int32).max)
    return idx.min(dim=-1).values.to(torch.int32)


def dense_argmax_int8_plain(h: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """(B, T2*C2) int8 -> (B,) int32 labels: ``dense_int8_plain``'s logits,
    then the argmax with ties to the lowest index."""
    return argmax_lowest(dense_int8_plain(h, qw))


# ------------------------------------------------------ kernel launches

_FRAMES, _PLANES, _TAPS, _MAP = "frames", "planes", "taps", "map"
# Per C entry point: the weights it reads, in its argument order, and its
# input: (B, 2, 128) f32 frames (the entry also takes inv_sx), (B, 8, 128)
# int8 tap planes, (B, 126, 8) int8 tap rows, or the (B, 124, 80) int8 conv
# map.
_ENTRIES = {
    "conv_stage_int8_v7": (("w1", "m1", "o1", "w2t", "m2", "o2"), _FRAMES),
    "conv_stage_int8_v9": (("w1f", "w2l", "m2", "o2"), _FRAMES),
    "conv_stage_int8_v10": (("w1f", "w2l", "m2", "o2"), _FRAMES),
    "conv_stage_int8_v5": (("w1e", "m1", "o1", "w2l", "m2", "o2"), _FRAMES),
    "conv_stage_int8_v1": (("w1e", "m1", "o1", "w2l", "m2", "o2"), _FRAMES),
    "conv_stage_int8_v6": (("w1e", "m1", "o1", "w2l", "m2", "o2"), _PLANES),
    "conv_stage_int8_v4": (("w1e", "m1", "o1", "w2l", "m2", "o2"), _PLANES),
    "conv_stage_int8_v3": (("w1e", "m1", "o1", "w2l", "m2", "o2"), _TAPS),
    "conv_stage_int8_v2": (("w1e", "m1", "o1", "w2l", "m2", "o2"), _TAPS),
    "dense_argmax_int8": (("w3t", "m3", "o3", "w4", "s4", "b4"), _MAP),
    "dense_int8": (("w3t", "m3", "o3", "w4", "s4", "b4"), _MAP),
}
# The shapes the kernels are compiled for.
_WEIGHT_SHAPES = {"w1": (3, C1), "w1e": (8, 2 * C1), "w2t": (C2, 6 * C1),
                  "w1f": (16, 2 * C1), "w2l": (2 * C1, 3 * C2),
                  "w3t": (DENSE, T2 * C2), "w4": (DENSE, N_CLASSES)}
_INPUTS = {_FRAMES: ((2, FRAME_LEN), torch.float32),
           _PLANES: ((8, FRAME_LEN), torch.int8),
           _TAPS: ((FRAME_LEN - 2, 8), torch.int8),
           _MAP: ((T2 * C2,), torch.int8)}


def _launch(wrapper, inp: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """Check the arguments, launch the CUDA entry point named after
    ``wrapper`` on the current stream, count the launch on ``wrapper``;
    returns the (B, 124, 80) int8 map, the (B,) int32 labels or the
    (B, 11) f32 logits."""
    name = wrapper.__name__
    keys, kind = _ENTRIES[name]
    weights = {k: getattr(qw, k) for k in keys}
    for key, t in weights.items():
        want = _WEIGHT_SHAPES.get(key)
        if want and tuple(t.shape) != want:
            raise ValueError(f"{name}: the CUDA kernel is built for {key} "
                             f"{want}, got {tuple(t.shape)}; a model wider "
                             "than the kernels' widths runs on the CPU only")
    shape, dtype = _INPUTS[kind]
    b = inp.shape[0]
    if kind == _MAP and inp.dim() > 1:
        inp = inp.reshape(b, -1)
    if inp.dtype != dtype or tuple(inp.shape[1:]) != shape:
        raise ValueError(f"{name}: expected (B, {', '.join(map(str, shape))}) "
                         f"{dtype}, got {tuple(inp.shape)} {inp.dtype}")
    if inp.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {inp.device}")
    if name == "dense_int8":
        out = torch.empty((b, N_CLASSES), dtype=torch.float32, device=inp.device)
    elif kind == _MAP:
        out = torch.empty((b,), dtype=torch.int32, device=inp.device)
    else:
        out = torch.empty((b, T2, C2), dtype=torch.int8, device=inp.device)
    if b == 0:
        return out
    for key, t in {"input": inp, **weights}.items():
        if t.device != inp.device:
            raise ValueError(f"{name}: {key} is on {t.device}, input on {inp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % (16 if key in ("input", "w3t") else 4):
            raise ValueError(f"{name}: {key} is misaligned")
    lib = _build.load_library()
    args = [inp.data_ptr(), b, *(t.data_ptr() for t in weights.values())]
    if kind == _FRAMES:
        args.append(qw.inv_sx)
    with torch.cuda.device(inp.device):
        code = getattr(lib, f"amc_{name}")(
            *args, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, name, code)
    wrapper.launches += 1
    return out


def _run(wrapper, plain, inp: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """``plain`` on a CPU tensor, ``wrapper``'s kernel on a CUDA one."""
    if inp.device.type == "cpu":
        return plain(inp, qw)
    return _launch(wrapper, inp, qw)


def conv_stage_int8_v7(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """Fused conv stage, (B, 2, 128) f32 -> (B, 124, c2) int8. Launches
    ``csrc/conv_stage_int8.cu`` on a CUDA tensor; plain version on the CPU."""
    return _run(conv_stage_int8_v7, conv_stage_int8_v7_plain, x, qw)[..., :qw.c2]


def conv_stage_int8_v9(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """v9 conv stage, (B, 2, 128) f32 -> (B, 124, c2) int8: the folded bf16
    conv1 (``mma.sync``, f32 sums) built by producer warps into a ring in
    shared memory, int8 conv2 on ``wgmma`` with the weight resident.
    Launches ``csrc/conv_stage_int8_v10.cu``'s v9 entry on a CUDA tensor;
    plain version on the CPU."""
    return _run(conv_stage_int8_v9, conv_stage_int8_folded_plain, x, qw)[..., :qw.c2]


def conv_stage_int8_v10(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """v10 conv stage: v9's function and kernel (the TPU's v10 differs from
    its v9 only in how it overlaps its chunks, which the ring does for
    both here). Launches ``csrc/conv_stage_int8_v10.cu``'s v10 entry on a
    CUDA tensor; plain version on the CPU."""
    return _run(conv_stage_int8_v10, conv_stage_int8_folded_plain, x, qw)[..., :qw.c2]


def conv_stage_int8_v5(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """v5 conv stage, (B, 2, 128) f32 -> (B, 124, c2) int8: v7's kernel
    design (conv1 + rq1 built in shared memory by producer warps, conv2 on
    int8 ``wgmma``) from ``w1e`` and ``w2l``. Launches
    ``csrc/conv_stage_int8_v5.cu`` on a CUDA tensor; plain version on the
    CPU."""
    return _run(conv_stage_int8_v5, conv_stage_int8_v5_plain, x, qw)[..., :qw.c2]


def conv_stage_int8_v1(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """v1 conv stage, v5's function and kernel body: (B, 2, 128) f32 ->
    (B, 124, c2) int8. Launches ``csrc/conv_stage_int8_v5.cu``'s v1 entry
    on a CUDA tensor; plain version on the CPU."""
    return _run(conv_stage_int8_v1, conv_stage_int8_v5_plain, x, qw)[..., :qw.c2]


def conv_stage_int8_v6(xp: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """v6 conv stage, (B, 8, 128) int8 tap planes (``tap_planes``) ->
    (B, 124, c2) int8: v5's kernel design (conv1 + rq1 built in shared
    memory by producer warps, here from the planes and ``w1e``, conv2 on
    int8 ``wgmma`` from ``w2l``). Launches ``csrc/conv_stage_int8_v6.cu``'s
    v6 entry on a CUDA tensor; plain version on the CPU."""
    return _run(conv_stage_int8_v6, conv_stage_int8_planes_plain, xp, qw)[..., :qw.c2]


def conv_stage_int8_v4(xp: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """v4 conv stage, v6's function and kernel body: (B, 8, 128) int8 tap
    planes -> (B, 124, c2) int8. Launches ``csrc/conv_stage_int8_v6.cu``'s
    v4 entry on a CUDA tensor; plain version on the CPU."""
    return _run(conv_stage_int8_v4, conv_stage_int8_planes_plain, xp, qw)[..., :qw.c2]


def conv_stage_int8_v3(xe: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """v3 conv stage, (B, 126, 8) int8 tap rows (``expand_taps``) ->
    (B, 124, c2) int8: conv1 and conv2 on the int8 tensor cores, the next
    frame's rows prefetched (``cp.async``). Launches
    ``csrc/conv_stage_int8_v3.cu``'s v3 entry on a CUDA tensor; plain
    version on the CPU."""
    return _run(conv_stage_int8_v3, conv_stage_int8_taps_plain, xe, qw)[..., :qw.c2]


def conv_stage_int8_v2(xe: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """v2 conv stage: v3 without the prefetch. Launches
    ``csrc/conv_stage_int8_v3.cu``'s v2 entry on a CUDA tensor; plain
    version on the CPU."""
    return _run(conv_stage_int8_v2, conv_stage_int8_taps_plain, xe, qw)[..., :qw.c2]


def dense_int8(h: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """Fused dense stage without the argmax, the carried-width (B, 124, 80)
    or (B, 9920) int8 map -> (B, 11) f32 logits (v1's and v2's). Launches
    ``csrc/dense_argmax_int8.cu``'s logits entry on a CUDA tensor; plain
    version on the CPU."""
    return _run(dense_int8, dense_int8_plain, h, qw)


def dense_argmax_int8(h: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    """Fused dense stage, the carried-width (B, 124, 80) or (B, 9920) int8
    map -> (B,) int32. Launches ``csrc/dense_argmax_int8.cu`` on a CUDA
    tensor; plain version on the CPU."""
    return _run(dense_argmax_int8, dense_argmax_int8_plain, h, qw)


KERNEL_WRAPPERS = (conv_stage_int8_v7, conv_stage_int8_v9, conv_stage_int8_v10,
                   conv_stage_int8_v5, conv_stage_int8_v6, conv_stage_int8_v4,
                   conv_stage_int8_v3, conv_stage_int8_v2, conv_stage_int8_v1,
                   dense_argmax_int8, dense_int8)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launch_counts()


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


# ------------------------------------------------------------ classifiers


def _frames(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    return x


def _planes(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    return tap_planes(x, qw.inv_sx)


def _taps(x: torch.Tensor, qw: Int8Weights) -> torch.Tensor:
    return expand_taps(x, qw.inv_sx)


# version: (wrapper, its plain version, the prologue that makes its input)
CONV_STAGES = {
    "v7": (conv_stage_int8_v7, conv_stage_int8_v7_plain, _frames),
    "v9": (conv_stage_int8_v9, conv_stage_int8_folded_plain, _frames),
    "v10": (conv_stage_int8_v10, conv_stage_int8_folded_plain, _frames),
    "v5": (conv_stage_int8_v5, conv_stage_int8_v5_plain, _frames),
    "v6": (conv_stage_int8_v6, conv_stage_int8_planes_plain, _planes),
    "v4": (conv_stage_int8_v4, conv_stage_int8_planes_plain, _planes),
    "v3": (conv_stage_int8_v3, conv_stage_int8_taps_plain, _taps),
    "v2": (conv_stage_int8_v2, conv_stage_int8_taps_plain, _taps),
    "v1": (conv_stage_int8_v1, conv_stage_int8_v5_plain, _frames),
}


def _conv_stage_fn(version: str, qw: Int8Weights):
    """(B, 2, T) f32 -> the carried-width (B, T-4, C2) map of ``version``
    (prologue, then its kernel or plain version). For v9/v10 this also
    builds the folded conv1, so a model that breaks the fold's contract
    raises ``ValueError`` here rather than at its first batch."""
    if version not in CONV_STAGES:
        raise ValueError(f"unknown int8 kernel version {version!r}; "
                         f"use one of {'/'.join(CONV_STAGES)}")
    if version in ("v9", "v10"):
        qw.w1f
    wrapper, plain, prologue = CONV_STAGES[version]

    def stage(x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=qw.device, dtype=torch.float32)
        return _run(wrapper, plain, prologue(x.contiguous(), qw), qw)

    return stage


def carry_weights(qm, device: str | torch.device | None = None,
                  interpret: bool = False) -> Int8Weights:
    """The weights an int8 builder takes, carried to the port: an
    ``Int8Weights`` passes straight through; the port's ``QuantizedModel``,
    a mapping of NumPy arrays in the JAX package's layout (a JAX
    ``QuantizedModel``'s fields) or an object whose ``tree()`` gives one is
    carried by ``quant.int8_weights_from_numpy`` onto ``device`` (default:
    the card, which raises without one). ``interpret=True`` asks for the
    plain versions, the counterpart of Pallas's interpret mode, so the model
    is carried to the CPU; weights already on a card, or a ``device`` other
    than the CPU beside it, raise ``ValueError``: nothing moves silently."""
    if isinstance(qm, Int8Weights):
        if interpret and qm.device.type != "cpu":
            raise ValueError("interpret=True runs the plain versions on the CPU, but the "
                             f"Int8Weights are on {qm.device}; carry the model to the CPU")
        if device is not None and torch.device(device) != qm.device:
            raise ValueError(f"the Int8Weights are on {qm.device}, not on {device}")
        return qm
    if interpret:
        if device is not None and torch.device(device).type != "cpu":
            raise ValueError(f"interpret=True runs the plain versions on the CPU, not on {device}")
        device = "cpu"
    if not isinstance(qm, (QuantizedModel, Mapping)):
        if not callable(getattr(qm, "tree", None)):
            raise TypeError("expected Int8Weights, a QuantizedModel or a mapping of its "
                            f"arrays, got {type(qm).__name__}")
        qm = qm.tree()
    return int8_weights_from_numpy(qm, "cuda" if device is None else device)


def _make_logits_forward(qw: Int8Weights, version: str):
    stage = _conv_stage_fn(version, qw)

    def forward(x: torch.Tensor) -> torch.Tensor:
        return dense_int8(stage(x), qw)[:, :qw.nc]

    return forward


def make_int8_forward(qm, *, device: str | torch.device | None = None,
                      interpret: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """v1 int8 forward, (B, 2, T) f32 -> (B, nc) f32 logits of the model's
    own classes: the v1 conv stage, then the dense stage without the
    argmax (the JAX package's ``make_int8_forward``). ``qm``, ``device``
    and ``interpret`` as ``carry_weights`` takes them."""
    return _make_logits_forward(carry_weights(qm, device, interpret), "v1")


def make_int8_forward_v2(qm, *, device: str | torch.device | None = None,
                         interpret: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """v2 int8 forward, (B, 2, T) f32 -> (B, nc) f32 logits of the model's
    own classes: the v2 conv stage, then the dense stage without the
    argmax. ``qm``, ``device`` and ``interpret`` as ``carry_weights``
    takes them."""
    return _make_logits_forward(carry_weights(qm, device, interpret), "v2")


def make_int8_predict(qm, version: str = "v7", *, device: str | torch.device | None = None,
                      interpret: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """Version-selectable int8 label predictor, (B, 2, T) f32 -> (B,) int32
    labels on the weights' device: the conv stage of ``version`` (v3, v4,
    v5, v6, v7, v9 or v10), then the dense + argmax stage; for v1 and v2,
    the argmax of ``make_int8_forward``'s or ``make_int8_forward_v2``'s
    logits, ties to the lowest index as ``jnp.argmax`` gives. Bit-exact
    against golden/quant.py. Any other name raises ``ValueError``. ``qm``,
    ``device`` and ``interpret`` as ``carry_weights`` takes them."""
    qw = carry_weights(qm, device, interpret)
    if version in ("v1", "v2"):
        forward = _make_logits_forward(qw, version)
        return lambda x: argmax_lowest(forward(x))
    stage = _conv_stage_fn(version, qw)

    def classify(x: torch.Tensor) -> torch.Tensor:
        return dense_argmax_int8(stage(x), qw)

    return classify


def _classifier(version: str):
    def make(qm, *, device: str | torch.device | None = None,
             interpret: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
        return make_int8_predict(qm, version, device=device, interpret=interpret)

    make.__name__ = make.__qualname__ = f"make_int8_classifier_{version}"
    make.__doc__ = (f"The {version} int8 classifier, (B, 2, T) f32 -> (B,) int32 labels: "
                    f"``make_int8_predict(qm, {version!r}, ...)``, the JAX package's "
                    f"``make_int8_classifier_{version}``.")
    return make


make_int8_classifier_v3 = _classifier("v3")
make_int8_classifier_v4 = _classifier("v4")
make_int8_classifier_v5 = _classifier("v5")
make_int8_classifier_v6 = _classifier("v6")
make_int8_classifier_v7 = _classifier("v7")
make_int8_classifier_v9 = _classifier("v9")
make_int8_classifier_v10 = _classifier("v10")


def make_conv_stage(qm, version: str = "v10", *, device: str | torch.device | None = None,
                    interpret: bool = False):
    """The conv stage alone: (B, 2, T) f32 -> the model's (B, T-4, c2) int8
    map, through ``version``'s prologue and kernel (default v10, as in the
    JAX package). ``qm``, ``device`` and ``interpret`` as ``carry_weights``
    takes them."""
    qw = carry_weights(qm, device, interpret)
    stage = _conv_stage_fn(version, qw)

    def conv_stage(x: torch.Tensor) -> torch.Tensor:
        return stage(x)[..., :qw.c2]

    return conv_stage
