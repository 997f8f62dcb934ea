"""The bf16 VT-CNN2 forwards and classifier: float weights in, logits or
labels out.

Counterparts of the JAX package's bf16 family in ``ops/infer.py``:

- ``make_bf16_classifier_v4`` (the bench's ``pallas_bf16_v4`` backend):
  ``conv_stage_bf16_v4`` then ``dense_argmax_bf16``, labels out;
- ``make_bf16_forward_v2`` (the bench's ``pallas_bf16``): the plain-torch
  tap-row prologue ``expand_taps_bf16``, ``conv_stage_bf16_v2``, then
  ``dense_logits_bf16``, logits out;
- ``make_bf16_forward``: ``conv_stage_bf16`` then ``dense_logits_bf16``.

Each stage is a wrapper, a plain version and a CUDA kernel, as in
``ops/infer.py``:

- ``conv_stage_bf16_v4``: (B, 2, 128) f32 frames -> (B, 124, c2) bf16 map:
  the frame rounded to bf16, conv1 (its three taps and its bias, all bf16,
  summed in f32 in a fixed order) -> ReLU -> bf16 -> conv2 (bf16 products,
  f32 sums) -> shift-add + b2 -> ReLU -> bf16;
- ``conv_stage_bf16_v2``: the same function from (B, 126, 8) bf16 tap rows
  whose lane 6 carries 1.0 for conv1's bias (v4's map, bit for bit, on the
  rows of the same frames);
- ``conv_stage_bf16``: conv1 in f32 on the unrounded frame with f32 taps
  and bias (the JAX ``conv1_accumulate`` order), then v4's conv2
  (``csrc/conv_stage_bf16_v4.cu``, one body for the three conv stages);
- ``dense_argmax_bf16``: the map -> dense1 (f32 sums) + b3 -> ReLU -> bf16 ->
  dense2 + b4 -> classes >= nc masked to -inf -> argmax, ties to the lowest
  index; ``dense_logits_bf16`` stops at the masked logits
  (``csrc/dense_argmax_bf16.cu``, one body for the two).

On a CUDA tensor a wrapper launches its kernel and counts the launch in its
``launches`` attribute, or raises; on a CPU tensor it runs the plain
version. There is no fallback. The JAX package's TPU layout (the (B, 8, T)
bf16 tap planes v4's XLA prologue built, the (B, 128, 128) padded map, the
128 padded logits and the zero rows of ``pack_dense1_weights_v3``) is not
reproduced: the v4 and f32 conv kernels read the frames, every stage reads
the compact map, and the logits keep 11 classes.

The kernels are compiled for the full-width model (T = 128, conv1 256,
conv2 80, dense 256, 11 classes). A narrower model is zero-padded to those
widths when its weights are packed (``make_bf16_weights``): padded channels
and units compute exact zeros, and padded classes are masked. A wider model
is packed unchanged; its plain versions run on the CPU and the card's
wrappers raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from modulationdetectioncnn_torch.device import resolve_device
from modulationdetectioncnn_torch.ops import _build
from modulationdetectioncnn_torch.ops.infer import argmax_lowest, tap_rows
from modulationdetectioncnn_torch.quant import C1, C2, DENSE, FRAME_LEN, N_CLASSES, T2


@dataclasses.dataclass(frozen=True)
class Bf16Weights:
    """Device tensors in the kernels' layouts (``make_bf16_weights``)."""

    c2: int                  # the model's own conv2 filters (<= b2's length)
    nc: int                  # the model's own classes (<= b4's length)
    w1e: torch.Tensor        # (8, 2*C1) bf16: rows 3h+k taps, row 6 bias, row 7 zero
    w1p: torch.Tensor        # (3, C1) f32 conv1 taps (conv_stage_bf16)
    b1: torch.Tensor         # (2*C1,) f32 conv1 bias, duplicated over the planes
    w2t: torch.Tensor        # (3*C2, 2*C1) bf16, [k*C2 + co, h*C1 + c]
    b2: torch.Tensor         # (C2,) f32
    w3t: torch.Tensor        # (D, T2*C2) bf16, dense1 transposed, K in t*C2+c order
    b3: torch.Tensor         # (D,) f32
    w4: torch.Tensor         # (D, NC) bf16
    b4: torch.Tensor         # (NC,) f32

    @property
    def device(self) -> torch.device:
        return self.w1e.device


def _flax_tree(params: Any) -> Mapping[str, Mapping[str, np.ndarray]]:
    """A ``VTCNN2`` state dict, or a Flax tree (``{"params": ...}`` or its
    inner dict), as the Flax-layout NumPy tree."""
    from modulationdetectioncnn_torch.models.vtcnn2 import flax_params

    if "conv1.weight" in params:
        return flax_params(params)
    p = params.get("params", params)
    return {layer: {k: np.asarray(v, np.float32) for k, v in p[layer].items()}
            for layer in ("Conv1", "Conv2", "Dense1", "Dense2")}


def make_bf16_weights(params: Any, device: str | torch.device = "cuda") -> Bf16Weights:
    """Pack a float VT-CNN2 (state dict or Flax tree) for the bf16 stages, as
    the JAX package's ``make_bf16_classifier_v4``, ``make_bf16_forward_v2``
    and ``make_bf16_forward`` do: conv1's taps in the (8, 2*C1) tap-plane
    layout with its bias as row 6 in bf16 (v4, v2), and as (3, C1) f32 taps
    with the bias duplicated to (2*C1,) f32 (``conv_stage_bf16``); conv2's
    and the dense weights rounded to bf16 (round to nearest even), the
    biases b2, b3, b4 in f32. A model narrower than the kernels' widths is
    zero-padded to them."""
    dev = resolve_device(device)
    p = _flax_tree(params)
    w1 = np.asarray(p["Conv1"]["kernel"], np.float32).reshape(3, -1)   # (3, c1)
    b1 = np.asarray(p["Conv1"]["bias"], np.float32)
    w2 = np.asarray(p["Conv2"]["kernel"], np.float32)                  # (2, 3, c1, c2)
    b2 = np.asarray(p["Conv2"]["bias"], np.float32)
    w3 = np.asarray(p["Dense1"]["kernel"], np.float32)                 # (t2*c2, d)
    b3 = np.asarray(p["Dense1"]["bias"], np.float32)
    w4 = np.asarray(p["Dense2"]["kernel"], np.float32)                 # (d, nc)
    b4 = np.asarray(p["Dense2"]["bias"], np.float32)
    c1, c2, d, nc = w1.shape[1], w2.shape[3], w3.shape[1], w4.shape[1]
    t2 = w3.shape[0] // c2
    if (t2 == T2 and c1 <= C1 and c2 <= C2 and d <= DENSE and nc <= N_CLASSES):
        c1p, c2p, dp, ncp = C1, C2, DENSE, N_CLASSES
    else:
        c1p, c2p, dp, ncp = c1, c2, d, nc      # runs on the CPU only

    def pad(a, shape):
        out = np.zeros(shape, np.float32)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    w1, b1 = pad(w1, (3, c1p)), pad(b1, (c1p,))
    w1e = np.zeros((8, 2 * c1p), np.float32)
    for h in range(2):
        w1e[3 * h:3 * h + 3, h * c1p:(h + 1) * c1p] = w1
    w1e[6] = np.concatenate([b1, b1])
    w2 = pad(w2, (2, 3, c1p, c2p))
    w2t = w2.transpose(1, 3, 0, 2).reshape(3 * c2p, 2 * c1p)           # [k*C2+co, h*C1+c]
    w3 = pad(w3.reshape(t2, c2, d), (t2, c2p, dp)).reshape(t2 * c2p, dp)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    return Bf16Weights(
        c2=c2, nc=nc, w1e=t(w1e, torch.bfloat16), w1p=t(w1, torch.float32),
        b1=t(np.concatenate([b1, b1]), torch.float32), w2t=t(w2t, torch.bfloat16),
        b2=t(pad(b2, (c2p,)), torch.float32), w3t=t(w3.T, torch.bfloat16),
        b3=t(pad(b3, (dp,)), torch.float32), w4=t(pad(w4, (dp, ncp)), torch.bfloat16),
        b4=t(pad(b4, (ncp,)), torch.float32))


# ------------------------------------------------------- plain versions


def expand_taps_bf16(x: torch.Tensor) -> torch.Tensor:
    """The v2 prologue, (B, 2, T) f32 -> (B, T-2, 8) bf16 tap rows: the
    frame rounded to bf16, ``tap_rows``, lane 6 set to 1.0 (conv1's bias
    lane) and lane 7 zero -- the XLA ops ``make_bf16_forward_v2`` runs
    before its kernel. Plain torch ops."""
    xe = tap_rows(x.to(torch.bfloat16))
    xe[..., 6] = 1.0
    return xe


def conv1_bf16_rows_plain(xe: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """(B, T-2, 8) bf16 tap rows -> (B, T-2, 2*C1) bf16, channel h*C1 + c:
    per channel ``((xe[3h]*w0 + xe[3h+1]*w1) + xe[3h+2]*w2) + xe[6]*b`` in
    f32 (each product of two bf16 values is exact), ReLU, bf16 -- the order
    the kernel sums in, and the order of the JAX kernel's K = 8 dot, whose
    other lanes meet zeros of the block-diagonal ``w1e`` and add exact
    zeros."""
    xf = xe.to(torch.float32)
    w = bw.w1e.to(torch.float32)
    c1 = w.shape[1] // 2
    halves = []
    for h in range(2):
        wh = w[:, h * c1:(h + 1) * c1]
        acc = xf[..., 3 * h, None] * wh[3 * h]
        acc = acc + xf[..., 3 * h + 1, None] * wh[3 * h + 1]
        acc = acc + xf[..., 3 * h + 2, None] * wh[3 * h + 2]
        halves.append(acc + xf[..., 6, None] * wh[6])
    return torch.relu(torch.cat(halves, dim=-1)).to(torch.bfloat16)


def conv1_bf16_plain(x: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """(B, 2, T) f32 -> (B, T-2, 2*C1) bf16: v4's conv1, the rows of the
    frame rounded to bf16 through ``conv1_bf16_rows_plain`` (lane 6 is 1.0,
    so the bias adds as it is)."""
    return conv1_bf16_rows_plain(expand_taps_bf16(x), bw)


def conv1_f32_plain(x: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """(B, 2, T) f32 -> (B, T-2, 2*C1) f32 before ReLU, channel h*C1 + c:
    conv1 of ``conv_stage_bf16`` on the unrounded frame with the f32 taps,
    ``((x[t]*w0 + x[t+1]*w1) + x[t+2]*w2) + b1``, each product and sum
    rounded on its own (the JAX ``conv1_accumulate`` then ``+ b1``)."""
    w = bw.w1p
    t1 = x.shape[-1] - 2
    halves = []
    for h in range(2):
        acc = x[:, h, 0:t1, None] * w[0]
        acc = acc + x[:, h, 1:1 + t1, None] * w[1]
        halves.append(acc + x[:, h, 2:2 + t1, None] * w[2])
    return torch.cat(halves, dim=-1) + bw.b1


def _conv2_plain(a1: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """(B, T-2, 2*C1) bf16 -> (B, T-4, C2) bf16 at the packed width: per tap
    k the f32 product ``z_k = a1 . w2[k]``, ``z0[t] + z1[t+1] + z2[t+2] +
    b2``, ReLU, bf16 (the JAX kernels' order)."""
    a1 = a1.to(torch.float32)
    c2, t2 = bw.b2.shape[0], a1.shape[1] - 2
    w2 = bw.w2t.to(torch.float32)
    z = [torch.matmul(a1[:, k:k + t2], w2[k * c2:(k + 1) * c2].T) for k in range(3)]
    return torch.relu(z[0] + z[1] + z[2] + bw.b2).to(torch.bfloat16)


def conv_stage_bf16_v4_plain(x: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """The plain version of the bf16 v4 conv stage, (B, 2, T) f32 ->
    (B, T-4, C2) bf16 at the packed width: ``conv1_bf16_plain``, then
    conv2."""
    return _conv2_plain(conv1_bf16_plain(x, bw), bw)


def conv_stage_bf16_v2_plain(xe: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """The plain version of the bf16 v2 conv stage, (B, T-2, 8) bf16 tap
    rows -> (B, T-4, C2) bf16 at the packed width: ``conv1_bf16_rows_plain``,
    then conv2. On ``expand_taps_bf16(x)`` it equals
    ``conv_stage_bf16_v4_plain(x)`` bit for bit."""
    return _conv2_plain(conv1_bf16_rows_plain(xe, bw), bw)


def conv_stage_bf16_plain(x: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """The plain version of the bf16 conv stage of ``make_bf16_forward``,
    (B, 2, T) f32 -> (B, T-4, C2) bf16 at the packed width:
    ``conv1_f32_plain``, ReLU, bf16, then conv2."""
    return _conv2_plain(torch.relu(conv1_f32_plain(x, bw)).to(torch.bfloat16), bw)


def dense1_bf16_plain(h: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """(B, T2*C2) or (B, T2, C2) bf16 map -> (B, D) dense1 activations,
    bf16 values as f32: dense1 (f32 product) + b3, ReLU, bf16."""
    d1 = torch.relu(torch.matmul(h.flatten(1).to(torch.float32),
                                 bw.w3t.to(torch.float32).T) + bw.b3)
    return d1.to(torch.bfloat16).to(torch.float32)


def dense_logits_bf16_plain(h: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """The plain version of the bf16 dense stage: (B, T2*C2) or (B, T2, C2)
    bf16 map -> (B, NC) f32 logits at the packed width, classes >= nc at
    -inf: ``dense1_bf16_plain``, then dense2 (f32 product) + b4."""
    logits = torch.matmul(dense1_bf16_plain(h, bw), bw.w4.to(torch.float32)) + bw.b4
    lane = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(lane < bw.nc, logits, float("-inf"))


def dense_argmax_bf16_plain(h: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """The plain version of the bf16 dense + argmax stage: (B,) int32 labels,
    the argmax of ``dense_logits_bf16_plain`` with ties to the lowest index."""
    return argmax_lowest(dense_logits_bf16_plain(h, bw))


# ------------------------------------------------------ kernel launches

# Per wrapper: its C entry point, the weights it reads in argument order,
# its input's trailing shape and dtype, and its output's.
_MAP_IN = ((T2 * C2,), torch.bfloat16)
_MAP_OUT = ((T2, C2), torch.bfloat16)
_ENTRIES = {
    "conv_stage_bf16_v4": ("amc_conv_stage_bf16_v4", ("w1e", "w2t", "b2"),
                           ((2, FRAME_LEN), torch.float32), _MAP_OUT),
    "conv_stage_bf16_v2": ("amc_conv_stage_bf16_v2", ("w1e", "w2t", "b2"),
                           ((FRAME_LEN - 2, 8), torch.bfloat16), _MAP_OUT),
    "conv_stage_bf16": ("amc_conv_stage_bf16", ("w1p", "b1", "w2t", "b2"),
                        ((2, FRAME_LEN), torch.float32), _MAP_OUT),
    "dense_argmax_bf16": ("amc_dense_argmax_bf16", ("w3t", "b3", "w4", "b4"),
                          _MAP_IN, ((), torch.int32)),
    "dense_logits_bf16": ("amc_dense_bf16", ("w3t", "b3", "w4", "b4"),
                          _MAP_IN, ((N_CLASSES,), torch.float32)),
}
# The shapes the kernels are compiled for.
_WEIGHT_SHAPES = {"w1e": (8, 2 * C1), "w1p": (3, C1), "b1": (2 * C1,),
                  "w2t": (3 * C2, 2 * C1), "b2": (C2,), "w3t": (DENSE, T2 * C2),
                  "b3": (DENSE,), "w4": (DENSE, N_CLASSES), "b4": (N_CLASSES,)}
_WEIGHT_DTYPES = {"w1e": torch.bfloat16, "w1p": torch.float32, "b1": torch.float32,
                  "w2t": torch.bfloat16, "b2": torch.float32, "w3t": torch.bfloat16,
                  "b3": torch.float32, "w4": torch.bfloat16, "b4": torch.float32}


def _launch(wrapper, inp: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """Check the arguments, launch ``wrapper``'s CUDA entry point on the
    current stream, count the launch on ``wrapper``; returns the
    (B, 124, 80) bf16 map, the (B,) int32 labels or the (B, 11) f32
    logits."""
    name = wrapper.__name__
    entry, keys, (shape, dtype), (out_shape, out_dtype) = _ENTRIES[name]
    weights = {k: getattr(bw, k) for k in keys}
    for key, t in weights.items():
        if tuple(t.shape) != _WEIGHT_SHAPES[key] or t.dtype != _WEIGHT_DTYPES[key]:
            raise ValueError(f"{name}: the CUDA kernel is built for {key} "
                             f"{_WEIGHT_SHAPES[key]} {_WEIGHT_DTYPES[key]}, got "
                             f"{tuple(t.shape)} {t.dtype}; a model wider than the "
                             "kernels' widths runs on the CPU only")
    b = inp.shape[0]
    if (shape, dtype) == _MAP_IN and inp.dim() > 2:
        inp = inp.reshape(b, -1)
    if inp.dtype != dtype or tuple(inp.shape[1:]) != shape:
        raise ValueError(f"{name}: expected (B, {', '.join(map(str, shape))}) "
                         f"{dtype}, got {tuple(inp.shape)} {inp.dtype}")
    if inp.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {inp.device}")
    out = torch.empty((b, *out_shape), dtype=out_dtype, device=inp.device)
    if b == 0:
        return out
    for key, t in {"input": inp, **weights}.items():
        if t.device != inp.device:
            raise ValueError(f"{name}: {key} is on {t.device}, input on {inp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is misaligned")
    lib = _build.load_library()
    args = [inp.data_ptr(), b, *(t.data_ptr() for t in weights.values())]
    if name.startswith("dense"):
        args.append(bw.nc)
    with torch.cuda.device(inp.device):
        code = getattr(lib, entry)(*args, out.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, name, code)
    wrapper.launches += 1
    return out


def _run(wrapper, plain, inp: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """``plain`` on a CPU tensor, ``wrapper``'s kernel on a CUDA one."""
    if inp.device.type == "cpu":
        return plain(inp, bw)
    return _launch(wrapper, inp, bw)


def conv_stage_bf16_v4(x: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """bf16 v4 conv stage, (B, 2, 128) f32 -> (B, 124, c2) bf16. Launches
    ``csrc/conv_stage_bf16_v4.cu``'s v4 entry on a CUDA tensor; plain
    version on the CPU."""
    return _run(conv_stage_bf16_v4, conv_stage_bf16_v4_plain, x, bw)[..., :bw.c2]


def conv_stage_bf16_v2(xe: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """bf16 v2 conv stage, (B, 126, 8) bf16 tap rows (``expand_taps_bf16``)
    -> (B, 124, c2) bf16. Launches ``csrc/conv_stage_bf16_v4.cu``'s v2 entry
    on a CUDA tensor; plain version on the CPU."""
    return _run(conv_stage_bf16_v2, conv_stage_bf16_v2_plain, xe, bw)[..., :bw.c2]


def conv_stage_bf16(x: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """bf16 conv stage of ``make_bf16_forward``, (B, 2, 128) f32 -> (B, 124,
    c2) bf16, conv1 in f32. Launches ``csrc/conv_stage_bf16_v4.cu``'s f32
    entry on a CUDA tensor; plain version on the CPU."""
    return _run(conv_stage_bf16, conv_stage_bf16_plain, x, bw)[..., :bw.c2]


def dense_argmax_bf16(h: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """bf16 dense + argmax stage, the packed-width (B, 124, 80) or (B, 9920)
    bf16 map -> (B,) int32 labels. Launches ``csrc/dense_argmax_bf16.cu`` on
    a CUDA tensor; plain version on the CPU."""
    return _run(dense_argmax_bf16, dense_argmax_bf16_plain, h, bw)


def dense_logits_bf16(h: torch.Tensor, bw: Bf16Weights) -> torch.Tensor:
    """bf16 dense stage, the packed-width (B, 124, 80) or (B, 9920) bf16 map
    -> (B, 11) f32 logits, classes >= nc at -inf. Launches
    ``csrc/dense_argmax_bf16.cu``'s logits entry on a CUDA tensor; plain
    version on the CPU."""
    return _run(dense_logits_bf16, dense_logits_bf16_plain, h, bw)


KERNEL_WRAPPERS = (conv_stage_bf16_v4, dense_argmax_bf16, conv_stage_bf16_v2,
                   dense_logits_bf16, conv_stage_bf16)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launch_counts()


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def _frames(x, bw: Bf16Weights) -> torch.Tensor:
    return torch.as_tensor(x).to(device=bw.device, dtype=torch.float32).contiguous()


def make_bf16_classifier_v4(params: Any, device: str | torch.device = "cuda"
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The fused bf16 classifier, (B, 2, T) f32 -> (B,) int32 labels on
    ``device``, from a float VT-CNN2 (state dict or Flax tree): the conv
    stage, then the dense + argmax stage, each a CUDA kernel on the card."""
    bw = make_bf16_weights(params, device)

    def classify(x: torch.Tensor) -> torch.Tensor:
        x = _frames(x, bw)
        return dense_argmax_bf16(
            _run(conv_stage_bf16_v4, conv_stage_bf16_v4_plain, x, bw), bw)

    return classify


def make_bf16_forward_v2(params: Any, device: str | torch.device = "cuda"
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The bf16 forward of the bench's ``pallas_bf16`` backend, (B, 2, T)
    f32 -> (B, nc) f32 logits on ``device``, from a float VT-CNN2 (state
    dict or Flax tree): the tap rows (plain torch), the v2 conv stage, then
    the dense stage, each a CUDA kernel on the card."""
    bw = make_bf16_weights(params, device)

    def forward(x: torch.Tensor) -> torch.Tensor:
        xe = expand_taps_bf16(_frames(x, bw))
        conv = _run(conv_stage_bf16_v2, conv_stage_bf16_v2_plain, xe, bw)
        return dense_logits_bf16(conv, bw)[:, :bw.nc]

    return forward


def make_bf16_forward(params: Any, device: str | torch.device = "cuda"
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The bf16 forward with conv1 in f32, (B, 2, T) f32 -> (B, nc) f32
    logits on ``device``, from a float VT-CNN2 (state dict or Flax tree):
    the f32-conv1 conv stage, then the dense stage, each a CUDA kernel on
    the card."""
    bw = make_bf16_weights(params, device)

    def forward(x: torch.Tensor) -> torch.Tensor:
        conv = _run(conv_stage_bf16, conv_stage_bf16_plain, _frames(x, bw), bw)
        return dense_logits_bf16(conv, bw)[:, :bw.nc]

    return forward
