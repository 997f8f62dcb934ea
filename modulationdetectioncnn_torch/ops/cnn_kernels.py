"""The stand-alone conv kernels of the VT-CNN2 topology, and the weight
packing the quantizer uses.

Counterpart of ``modulationdetectioncnn_tpu/ops/cnn_kernels.py`` with its
public names and signatures: ``conv1_stacked`` and ``conv2_stacked`` (float:
conv + bias + ReLU), ``conv1_stacked_int8`` and ``conv2_stacked_int8``
(int8, with the fixed-point ``requantize``), the shared ``conv1_accumulate``
and the NumPy packing helpers. Layouts are the JAX module's: conv1 writes the
"stacked" (B, T-2, 2C) map, channel h*C + c for I/Q plane h, which conv2
reads; conv2's weight is tap-packed, ``w2p[h*Cin + cin, k*Co + co]``.

Each of the four has three pieces, as in ``ops/infer.py``:

- the wrapper: on a CUDA tensor it checks the arguments and launches its
  hand-written kernel in ``csrc/cnn_kernels.cu`` (counting the launch in its
  ``launches`` attribute), or raises; on a CPU tensor it runs the plain
  version. There is no fallback from one to the other;
- the plain version (``*_plain``), plain PyTorch on any device;
- the kernel's note at the top of ``csrc/cnn_kernels.cu``: the TPU kernel it
  replaces, its bound on the H100 and what its design does about it.

conv2 has three bodies on the card, and ``conv2_route`` picks one from the
widths, the dtype and the alignment (a dispatch by shape, not a fallback):
the Hopper route for bf16 and int8 (TMA, ``wgmma``, the weight resident per
block), the FFMA route for float32 (TMA, the weight streamed beside the
map, outer products on the CUDA cores) or the general route. The int8
conv1 has two, picked by ``conv1_int8_route`` from the widths: the dp4a
route (a thread's 16 channels and their taps in registers, one ``__dp4a``
a channel, one 16-byte store a row) or the general route. The routed
wrappers count their launches per route in ``route_launches`` beside
``launches``.

Unlike the classifiers' kernels, these take the widths at run time: any B,
T, C, Cin and Co, and return the caller's own shape. ``block_b`` is the TPU
kernels' batch tile; it is accepted (>= 1) and does not change the result.
The CUDA kernels take float32 frames and conv1 weights, a bf16 or float32
conv2 input with a weight of the same type, float32 biases, int32 shifts
and offsets, and write bf16 or float32 (``out_dtype``); the plain versions
also take what the JAX functions promote.
"""
from __future__ import annotations

import numpy as np
import torch

from modulationdetectioncnn_torch.ops import _build
from modulationdetectioncnn_torch.ops import requant
from modulationdetectioncnn_torch.ops.infer import _exact_matmul


def pack_conv1_weights(w1: np.ndarray) -> np.ndarray:
    """Flax Conv1 kernel (1, 3, 1, C) -> (3, C)."""
    return np.asarray(w1).reshape(3, -1)


def pack_conv2_weights(w2: np.ndarray) -> np.ndarray:
    """Flax Conv2 kernel (2, 3, Cin, Co) -> (2*Cin, 3*Co) tap-packed:
    W2p[h*Cin + cin, k*Co + co] = w2[h, k, cin, co]."""
    w2 = np.asarray(w2)
    kh, kw, cin, co = w2.shape
    return w2.transpose(0, 2, 1, 3).reshape(kh * cin, kw * co)


def float_conv_weights(state: dict, device) -> tuple:
    """(w1p (3, C1), b1, w2p (2*C1, 3*C2) tap-packed, b2), float32 on
    ``device``, from a VT-CNN2 state dict: ``w1p[k, c] = conv1[c, 0, 0, k]``,
    ``w2p[h*C1 + cin, k*C2 + co] = conv2[co, cin, h, k]``."""
    w2 = state["conv2.weight"]
    return tuple(t.contiguous().float().to(device) for t in (
        state["conv1.weight"][:, 0, 0, :].T, state["conv1.bias"],
        w2.permute(2, 1, 3, 0).reshape(2 * w2.shape[1], 3 * w2.shape[0]),
        state["conv2.bias"]))


def conv1_accumulate(x: torch.Tensor, w: torch.Tensor, t_out: int,
                     acc_dtype: torch.dtype) -> torch.Tensor:
    """The shared conv1 sum: x (B, 2, T), w (3, C) -> stacked (B, t_out, 2C)
    in ``acc_dtype``, ``acc = 0``, then ``acc + x[:, h, k:k+t_out] * w[k]``
    for k = 0, 1, 2, each product and sum rounded on its own (the JAX
    function's order)."""
    halves = []
    for h in range(2):
        acc = torch.zeros((x.shape[0], t_out, w.shape[1]), dtype=acc_dtype,
                          device=x.device)
        for k in range(3):
            acc = acc + x[:, h, k:k + t_out, None].to(acc_dtype) * w[k].to(acc_dtype)
        halves.append(acc)
    return torch.cat(halves, dim=-1)


def _is_floating(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.is_floating_point()
    return bool(np.issubdtype(np.asarray(a).dtype, np.floating))


def requantize(acc: torch.Tensor, shift, offset, *, relu: bool = True) -> torch.Tensor:
    """Per-channel int32 -> int8 (the requantize spec).

    ``relu=True`` (every int8 path): ``clip((acc + offset) >> shift, 0,
    127)``, an arithmetic shift by the int32 per-channel ``shift``, the
    int32 ``offset`` folding the bias and the +0.5 rounding term
    (``ops/requant.py``). ``relu=False`` is the legacy form, off every path:
    ``clip(round_half_even(float(acc) * shift + offset), -127, 127)`` with
    a float ``shift`` multiplier; an integer ``shift`` raises ``TypeError``,
    as in the JAX package (the fixed-point shift counts would scale the
    accumulator by the count)."""
    if relu:
        return requant.requantize(acc, torch.as_tensor(shift, device=acc.device),
                                  torch.as_tensor(offset, device=acc.device))
    if not _is_floating(shift):
        raise TypeError("requantize(relu=False) expects legacy f32 (mult, offset); got "
                        f"integer shift {getattr(shift, 'dtype', type(shift))} -- use the "
                        "relu=True fixed-point path or dequantize explicitly")
    v = torch.round(acc.to(torch.float32) * torch.as_tensor(shift, dtype=torch.float32,
                                                            device=acc.device)
                    + torch.as_tensor(offset, dtype=torch.float32, device=acc.device))
    return v.clamp(-127.0, 127.0).to(torch.int8)


def _shift_add(z: torch.Tensor, co: int) -> torch.Tensor:
    """z (B, T, 3*Co) -> z[t, co] + z[t+1, Co+co] + z[t+2, 2*Co+co], (B, T-2, Co)."""
    t_out = z.shape[1] - 2
    return (z[:, 0:t_out, 0:co] + z[:, 1:t_out + 1, co:2 * co]
            + z[:, 2:t_out + 2, 2 * co:3 * co])


# ------------------------------------------------------------ plain versions


def conv1_stacked_plain(x: torch.Tensor, w1p: torch.Tensor, b1: torch.Tensor,
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """ReLU conv1, stacked: x (B, 2, T), w1p (3, C), b1 (C,) -> (B, T-2, 2C)
    ``out_dtype``, in float32: ``conv1_accumulate``, + the bias of channel
    c on both planes, ReLU, one rounding to ``out_dtype``."""
    t_out = x.shape[-1] - 2
    acc = conv1_accumulate(x.to(torch.float32), w1p.to(torch.float32), t_out,
                           torch.float32)
    out = acc + torch.cat([b1, b1]).to(torch.float32)
    return torch.clamp_min(out, 0.0).to(out_dtype)


def conv2_stacked_plain(a1s: torch.Tensor, w2p: torch.Tensor, b2: torch.Tensor,
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """ReLU conv2 on stacked activations: a1s (B, T, 2Cin), w2p (2Cin, 3Co),
    b2 (Co,) -> (B, T-2, Co) ``out_dtype``: z = a1s . w2p in float32 (bf16
    values are exact there), then ``z0[t] + z1[t+1] + z2[t+2] + b2``, ReLU,
    one rounding."""
    co = w2p.shape[1] // 3
    z = torch.matmul(a1s.to(torch.float32), w2p.to(torch.float32))
    out = _shift_add(z, co) + b2.to(torch.float32)
    return torch.clamp_min(out, 0.0).to(out_dtype)


def conv1_stacked_int8_plain(x_i8: torch.Tensor, w1p_i8: torch.Tensor,
                             mult: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """int8 conv1, stacked: x (B, 2, T) int8, w1p (3, C) int8, shift and
    offset (2C,) int32 -> (B, T-2, 2C) int8: the exact int32 sum, then
    ``requantize``."""
    acc = conv1_accumulate(x_i8.to(torch.int32), w1p_i8.to(torch.int32),
                           x_i8.shape[-1] - 2, torch.int32)
    return requantize(acc, mult, offset)


def conv2_stacked_int8_plain(a1s_i8: torch.Tensor, w2p_i8: torch.Tensor,
                             mult: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """int8 conv2: a1s (B, T, 2Cin) int8, w2p (2Cin, 3Co) int8, shift and
    offset (Co,) int32 -> (B, T-2, Co) int8: the exact int32 tap-packed
    product, the shift-add, then ``requantize``."""
    z = _exact_matmul(a1s_i8, w2p_i8)
    return requantize(_shift_add(z, w2p_i8.shape[1] // 3), mult, offset)


# ------------------------------------------------------- kernel launches

_OUT_DTYPES = (torch.bfloat16, torch.float32)
CONV2_ROUTES = ("wgmma", "ffma", "general")
WGMMA_MAX_K = 512      # the resident weight's budget: 3 * 80 int8 or 3 * 40 bf16 columns


def conv2_route(k: int, co: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The conv2 body a launch on the card takes, from the widths and the
    dtype of ``a1s`` (B and T do not matter). Each needs ``co`` a multiple
    of 4 (its stores) and ``aligned`` (``a1s`` and ``w2p`` start on 16-byte
    boundaries), and ``k`` times the element size a multiple of 16 bytes
    (the rows a TMA box may stride):

    - ``"wgmma"`` (``amc_conv2_stacked_wgmma``, ``amc_conv2_stacked_int8_wgmma``)
      when ``a1s`` is bf16 or int8 and ``k <= 512`` (the weight resident in
      a block);
    - ``"ffma"`` (``amc_conv2_stacked_ffma``) when ``a1s`` is float32, at
      any ``k`` (the weight is streamed beside the map);
    - ``"general"`` (the tile body of ``amc_conv2_stacked``,
      ``amc_conv2_stacked_int8``) otherwise.

    The default widths (K 512, Co 80) take ``"wgmma"`` in bf16 and int8 and
    ``"ffma"`` in float32."""
    es = {torch.bfloat16: 2, torch.int8: 1, torch.float32: 4}.get(dtype)
    if es is None or not aligned or k < 1 or k * es % 16 or co < 4 or co % 4:
        return "general"
    if dtype == torch.float32:
        return "ffma"
    return "wgmma" if k <= WGMMA_MAX_K else "general"


CONV1_INT8_ROUTES = ("dp4a", "general")
DP4A_MIN_C, DP4A_MAX_C = 16, 2048    # a thread's 16 channels; at most 256 threads a row
DP4A_MAX_T = 8192                    # two frames staged in 32 KB of shared memory


def conv1_int8_route(t: int, c: int) -> str:
    """The int8 conv1 body a launch on the card takes, from the frame
    length and the channels (B does not matter): ``"dp4a"``
    (``amc_conv1_stacked_int8_dp4a``) when ``c`` is a multiple of 16 in
    [16, 2048] and 3 <= ``t`` <= 8192, which covers the default widths (T
    128, C 256); ``"general"`` (``amc_conv1_stacked_int8``) otherwise."""
    if c % 16 == 0 and DP4A_MIN_C <= c <= DP4A_MAX_C and 3 <= t <= DP4A_MAX_T:
        return "dp4a"
    return "general"


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _check(name: str, args: dict, ndims: dict, dtypes: dict) -> torch.device:
    """Raise ``ValueError`` on what the kernel does not take: a rank or a
    dtype (before anything else), a device other than one CUDA device, a
    tensor that is not contiguous. Returns the device."""
    for key, t in args.items():
        if not isinstance(t, torch.Tensor) or t.dim() != ndims[key] \
                or t.dtype not in dtypes[key]:
            got = (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else type(t)
            raise ValueError(f"{name}: expected {key} of rank {ndims[key]} and dtype "
                             f"{' or '.join(map(str, dtypes[key]))}, got {got}")
    dev = next(iter(args.values())).device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for key, t in args.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, input on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return dev


def _call(wrapper, entry: str, dev: torch.device, *args, route: str | None = None) -> None:
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, wrapper.__name__, code)
    wrapper.launches += 1
    if route is not None:
        wrapper.route_launches[route] += 1


def _check_block_b(block_b: int) -> None:
    if int(block_b) < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")


def _check_out_dtype(name: str, out_dtype: torch.dtype) -> None:
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{name}: expected out_dtype bfloat16 or float32, got {out_dtype}")


def conv1_stacked(x: torch.Tensor, w1p: torch.Tensor, b1: torch.Tensor, *,
                  block_b: int = 16, out_dtype: torch.dtype = torch.bfloat16
                  ) -> torch.Tensor:
    """ReLU conv1, stacked output: x (B, 2, T) f32, w1p (3, C), b1 (C,) ->
    (B, T-2, 2C) ``out_dtype``, ``[b, t, h*C + c] = relu(conv1)[b, h, t, c]``.
    Launches ``csrc/cnn_kernels.cu``'s conv1 on a CUDA tensor (float32
    inputs; bf16 or float32 out); the plain version on the CPU."""
    _check_block_b(block_b)
    if x.device.type == "cpu":
        return conv1_stacked_plain(x, w1p, b1, out_dtype)
    name = "conv1_stacked"
    f32 = (torch.float32,)
    dev = _check(name, {"x": x, "w1p": w1p, "b1": b1}, {"x": 3, "w1p": 2, "b1": 1},
                 {"x": f32, "w1p": f32, "b1": f32})
    _check_out_dtype(name, out_dtype)
    b, two, t = x.shape
    c = w1p.shape[1]
    if two != 2 or t < 3 or w1p.shape[0] != 3 or tuple(b1.shape) != (c,):
        raise ValueError(f"{name}: expected x (B, 2, T>=3), w1p (3, C), b1 (C,); got "
                                 f"{tuple(x.shape)}, {tuple(w1p.shape)}, {tuple(b1.shape)}")
    out = torch.empty((b, t - 2, 2 * c), dtype=out_dtype, device=dev)
    if out.numel():
        _call(conv1_stacked, "amc_conv1_stacked", dev, x.data_ptr(), b, t, c,
              w1p.data_ptr(), b1.data_ptr(), int(out_dtype == torch.float32),
              out.data_ptr())
    return out


def conv2_stacked(a1s: torch.Tensor, w2p: torch.Tensor, b2: torch.Tensor, *,
                  block_b: int = 16, out_dtype: torch.dtype = torch.bfloat16
                  ) -> torch.Tensor:
    """ReLU conv2 on stacked activations: a1s (B, T, 2Cin), w2p (2Cin, 3Co),
    b2 (Co,) -> (B, T-2, Co) ``out_dtype``. Launches
    ``csrc/cnn_kernels.cu``'s conv2 on a CUDA tensor (a1s and w2p both bf16,
    on the tensor cores, or both float32, on the CUDA cores; b2 float32);
    the plain version on the CPU. On the card the body is
    ``conv2_route(2Cin, Co, a1s.dtype, aligned)``'s, with Co a multiple of
    4 and a1s and w2p 16-byte aligned: the Hopper route (``"wgmma"``) for
    bf16 with 2Cin a multiple of 8 and at most 512, the FFMA route
    (``"ffma"``) for float32 with 2Cin a multiple of 4; the general route
    otherwise. A launch that fails raises; no route retries on another."""
    _check_block_b(block_b)
    if a1s.device.type == "cpu":
        return conv2_stacked_plain(a1s, w2p, b2, out_dtype)
    name = "conv2_stacked"
    floats = (torch.bfloat16, torch.float32)
    dev = _check(name, {"a1s": a1s, "w2p": w2p, "b2": b2}, {"a1s": 3, "w2p": 2, "b2": 1},
                 {"a1s": floats, "w2p": (a1s.dtype,), "b2": (torch.float32,)})
    _check_out_dtype(name, out_dtype)
    b, t, k = a1s.shape
    co = w2p.shape[1] // 3
    if t < 3 or w2p.shape[0] != k or w2p.shape[1] != 3 * co or co < 1 \
            or tuple(b2.shape) != (co,):
        raise ValueError(f"{name}: expected a1s (B, T>=3, K), w2p (K, 3Co), b2 (Co,); got "
                                 f"{tuple(a1s.shape)}, {tuple(w2p.shape)}, {tuple(b2.shape)}")
    out = torch.empty((b, t - 2, co), dtype=out_dtype, device=dev)
    if out.numel():
        route = conv2_route(k, co, a1s.dtype, _aligned(a1s, w2p))
        out_f32 = int(out_dtype == torch.float32)
        if route in ("wgmma", "ffma"):
            _call(conv2_stacked, f"amc_conv2_stacked_{route}", dev, a1s.data_ptr(), b, t, k,
                  co, w2p.data_ptr(), b2.data_ptr(), out_f32, out.data_ptr(), route=route)
        else:
            vec = int(k * a1s.element_size() % 16 == 0 and a1s.data_ptr() % 16 == 0)
            _call(conv2_stacked, "amc_conv2_stacked", dev, a1s.data_ptr(), b, t, k, co,
                  w2p.data_ptr(), b2.data_ptr(), int(a1s.dtype == torch.float32),
                  out_f32, vec, out.data_ptr(), route=route)
    return out


def conv1_stacked_int8(x_i8: torch.Tensor, w1p_i8: torch.Tensor, mult: torch.Tensor,
                       offset: torch.Tensor, *, block_b: int = 16) -> torch.Tensor:
    """int8 conv1, stacked int8 output: x (B, 2, T) int8, w1p (3, C) int8,
    shift and offset (2C,) int32 (duplicated over the planes, so each
    channel of each plane keeps its own) -> (B, T-2, 2C) int8. Launches
    ``csrc/cnn_kernels.cu``'s int8 conv1 on a CUDA tensor, the body of
    ``conv1_int8_route(T, C)``: the dp4a route for C a multiple of 16 in
    [16, 2048] and T <= 8192, the general route otherwise (a launch that
    fails raises; no route retries on another); the plain version on the
    CPU."""
    _check_block_b(block_b)
    if x_i8.device.type == "cpu":
        return conv1_stacked_int8_plain(x_i8, w1p_i8, mult, offset)
    name = "conv1_stacked_int8"
    i8, i32 = (torch.int8,), (torch.int32,)
    dev = _check(name, {"x": x_i8, "w1p": w1p_i8, "mult": mult, "offset": offset},
                 {"x": 3, "w1p": 2, "mult": 1, "offset": 1},
                 {"x": i8, "w1p": i8, "mult": i32, "offset": i32})
    b, two, t = x_i8.shape
    c = w1p_i8.shape[1]
    if two != 2 or t < 3 or w1p_i8.shape[0] != 3 or tuple(mult.shape) != (2 * c,) \
            or tuple(offset.shape) != (2 * c,):
        raise ValueError(f"{name}: expected x (B, 2, T>=3), w1p (3, C), shift and offset (2C,); "
                                 f"got {tuple(x_i8.shape)}, {tuple(w1p_i8.shape)}, "
                                 f"{tuple(mult.shape)}, {tuple(offset.shape)}")
    out = torch.empty((b, t - 2, 2 * c), dtype=torch.int8, device=dev)
    if out.numel():
        route = conv1_int8_route(t, c)
        entry = "amc_conv1_stacked_int8_dp4a" if route == "dp4a" else "amc_conv1_stacked_int8"
        _call(conv1_stacked_int8, entry, dev, x_i8.data_ptr(), b, t, c, w1p_i8.data_ptr(),
              mult.data_ptr(), offset.data_ptr(), out.data_ptr(), route=route)
    return out


def conv2_stacked_int8(a1s_i8: torch.Tensor, w2p_i8: torch.Tensor, mult: torch.Tensor,
                       offset: torch.Tensor, *, block_b: int = 16) -> torch.Tensor:
    """int8 conv2: a1s (B, T, 2Cin) int8, w2p (2Cin, 3Co) int8, shift and
    offset (Co,) int32 -> (B, T-2, Co) int8. Launches
    ``csrc/cnn_kernels.cu``'s int8 conv2 on a CUDA tensor; the plain
    version on the CPU. On the card the body is ``conv2_route``'s: the
    Hopper route for 2Cin a multiple of 16 and at most 512, Co a multiple
    of 4, a1s and w2p 16-byte aligned; the general route otherwise."""
    _check_block_b(block_b)
    if a1s_i8.device.type == "cpu":
        return conv2_stacked_int8_plain(a1s_i8, w2p_i8, mult, offset)
    name = "conv2_stacked_int8"
    i8, i32 = (torch.int8,), (torch.int32,)
    dev = _check(name, {"a1s": a1s_i8, "w2p": w2p_i8, "mult": mult, "offset": offset},
                 {"a1s": 3, "w2p": 2, "mult": 1, "offset": 1},
                 {"a1s": i8, "w2p": i8, "mult": i32, "offset": i32})
    b, t, k = a1s_i8.shape
    co = w2p_i8.shape[1] // 3
    if t < 3 or w2p_i8.shape[0] != k or w2p_i8.shape[1] != 3 * co or co < 1 \
            or tuple(mult.shape) != (co,) or tuple(offset.shape) != (co,):
        raise ValueError(f"{name}: expected a1s (B, T>=3, K), w2p (K, 3Co), shift and offset "
                                 f"(Co,); got {tuple(a1s_i8.shape)}, {tuple(w2p_i8.shape)}, "
                                 f"{tuple(mult.shape)}, {tuple(offset.shape)}")
    out = torch.empty((b, t - 2, co), dtype=torch.int8, device=dev)
    if out.numel():
        route = conv2_route(k, co, torch.int8, _aligned(a1s_i8, w2p_i8))
        args = (a1s_i8.data_ptr(), b, t, k, co, w2p_i8.data_ptr(), mult.data_ptr(),
                offset.data_ptr())
        if route == "wgmma":
            _call(conv2_stacked_int8, "amc_conv2_stacked_int8_wgmma", dev, *args,
                  out.data_ptr(), route=route)
        else:
            vec = int(k % 16 == 0 and a1s_i8.data_ptr() % 16 == 0)
            _call(conv2_stacked_int8, "amc_conv2_stacked_int8", dev, *args, vec,
                  out.data_ptr(), route=route)
    return out


KERNEL_WRAPPERS = (conv1_stacked, conv2_stacked, conv1_stacked_int8, conv2_stacked_int8)
ROUTED_WRAPPERS = {conv2_stacked: CONV2_ROUTES, conv2_stacked_int8: CONV2_ROUTES,
                   conv1_stacked_int8: CONV1_INT8_ROUTES}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn, routes in ROUTED_WRAPPERS.items():
        fn.route_launches = dict.fromkeys(routes, 0)


reset_launch_counts()


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def route_launch_counts() -> dict[str, dict[str, int]]:
    """{routed wrapper (conv2 and int8 conv1): {route: launches}}."""
    return {fn.__name__: dict(fn.route_launches) for fn in ROUTED_WRAPPERS}
