"""Post-training int8 quantization (PTQ) of the torch VT-CNN2.

Counterpart of ``modulationdetectioncnn_tpu/train/quant.py``: per-channel
symmetric int8 weights, per-tensor activation scales from a percentile of
calibration activations, and every hot-chain requantize scale constrained
to a power of two, so inference does only
``clip((acc + offset) >> shift, 0, 127)``. The weight arithmetic is the JAX
package's, in NumPy float64 on the Flax-layout parameters
(``models.vtcnn2.flax_params``), so from the same parameters and scales the
13 arrays are equal to the JAX quantizer's. The result is the port's
``quant.QuantizedModel``.

Calibration runs the model on its own device. ``torch.quantile`` refuses
inputs above 2**24 elements, so ``percentile`` sorts and interpolates itself,
with ``jnp.percentile``'s float32 index arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2, flax_params
from modulationdetectioncnn_torch.ops.cnn_kernels import (
    pack_conv1_weights, pack_conv2_weights)
from modulationdetectioncnn_torch.quant import QuantizedModel


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile of all elements of ``x``, as a 0-d float32
    tensor on ``x``'s device, at any size. Linear interpolation between the
    two neighbouring order statistics, with the rank ``q/100 * (n-1)`` and
    the weights computed in float32 as ``jnp.percentile`` computes them
    (above 2**24 elements that rank is rounded to float32's grid)."""
    v = torch.sort(x.reshape(-1).to(torch.float32)).values
    n = torch.tensor(float(v.numel()), dtype=torch.float32)
    pos = torch.tensor(q, dtype=torch.float32) / 100 * (n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1 - w_hi
    lo = int(lo.clamp(0, n - 1))
    hi = int(hi.clamp(0, n - 1))
    return v[lo] * w_lo.to(v.device) + v[hi] * w_hi.to(v.device)


_percentile = percentile   # for the functions whose `percentile` keyword shadows it


def _per_channel_scale(w: np.ndarray, reduce_axes: tuple[int, ...]) -> np.ndarray:
    s = np.abs(w).max(axis=reduce_axes) / 127.0
    return np.maximum(s, 1e-12)


def _quant_w(w: np.ndarray, scale: np.ndarray, bcast) -> np.ndarray:
    q = np.round(w / scale[bcast])
    return np.clip(q, -127, 127).astype(np.int8)


def _pow2_requant(s_in, s_w, s_out, bias, significand_bits=None):
    """Requantize constants on a power-of-two grid: ``s_in*s_w[c]/s_out`` is
    snapped up to ``2**-shift[c]`` (the re-quantized weights never clip), and
    the offset folds the bias and the +0.5 rounding term as an int32 on the
    same grid, optionally snapped to ``significand_bits`` (conv1's offset is
    snapped to 8 bits so the v9/v10 bias lane is bf16-exact)."""
    e = np.ceil(np.log2(np.maximum(s_in * s_w / s_out, 1e-30)))
    if not np.all(e <= 0):
        raise ValueError("requantize scale >= 1 unsupported")
    shift = (-e).astype(np.int32)
    s_w_eff = (2.0 ** e) * s_out / s_in
    off = (bias / s_out + 0.5) * 2.0 ** (-e)
    if significand_bits is not None:
        mag = np.maximum(np.abs(off), 1e-30)
        grid = 2.0 ** np.maximum(
            np.floor(np.log2(mag)) - (significand_bits - 1), 0.0)
        off = np.round(off / grid) * grid
    off = np.round(off)
    if not np.all(np.abs(off) < 2 ** 28):
        raise ValueError("bias too large for int32 fold")
    return shift, off.astype(np.int32), s_w_eff


@torch.no_grad()
def calibrate_activations(model: VTCNN2, calib_x: np.ndarray,
                          percentile: float = 99.99) -> dict[str, float]:
    """Run the model (eval mode, its own device and compute dtype) on the
    calibration frames; return the input absmax scale and the percentile
    scales of the post-ReLU Conv1 / Conv2 / Dense1 activations. The
    quantizer is VT-CNN2's: another model raises ValueError."""
    if not isinstance(model, VTCNN2):
        raise ValueError(f"the int8 quantizer takes a VT-CNN2 (model.arch=vtcnn2), "
                         f"not a {type(model).__name__}")
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        inter: dict[str, torch.Tensor] = {}
        model(torch.from_numpy(np.asarray(calib_x, np.float32)).to(dev), inter)
        a = [float(_percentile(inter[k].to(torch.float32).clamp_min(0.0),
                               percentile))
             for k in ("Conv1", "Conv2", "Dense1")]
    finally:
        model.train(was_training)
    return {
        "s_x": float(np.abs(calib_x).max()) / 127.0,
        "a1": a[0] / 127.0,
        "a2": a[1] / 127.0,
        "a3": a[2] / 127.0,
    }


def quantize_params(p: dict, scales: dict[str, float]) -> QuantizedModel:
    """Flax-layout float parameters + activation scales -> the int8 artifact."""
    s_x, s_a1, s_a2, s_a3 = scales["s_x"], scales["a1"], scales["a2"], scales["a3"]

    # conv1: kernel (1,3,1,C1); offset snapped to an 8-bit significand.
    w1 = np.asarray(p["Conv1"]["kernel"]).astype(np.float64)
    b1 = np.asarray(p["Conv1"]["bias"]).astype(np.float64)
    s_w1 = _per_channel_scale(w1, (0, 1, 2))
    sh1, o1_half, s_w1_eff = _pow2_requant(s_x, s_w1, s_a1, b1, significand_bits=8)
    w1p = pack_conv1_weights(_quant_w(w1, s_w1_eff, (None, None, None, slice(None))))
    m1 = np.concatenate([sh1, sh1])
    o1 = np.concatenate([o1_half, o1_half])

    # conv2: kernel (2,3,C1,C2); one scale per output channel across taps.
    w2 = np.asarray(p["Conv2"]["kernel"]).astype(np.float64)
    b2 = np.asarray(p["Conv2"]["bias"]).astype(np.float64)
    s_w2 = _per_channel_scale(w2, (0, 1, 2))
    m2, o2, s_w2_eff = _pow2_requant(s_a1, s_w2, s_a2, b2)
    w2p = pack_conv2_weights(_quant_w(w2, s_w2_eff, (None, None, None, slice(None))))

    # dense1: (T2*C2, D)
    w3 = np.asarray(p["Dense1"]["kernel"]).astype(np.float64)
    b3 = np.asarray(p["Dense1"]["bias"]).astype(np.float64)
    s_w3 = _per_channel_scale(w3, (0,))
    m3, o3, s_w3_eff = _pow2_requant(s_a2, s_w3, s_a3, b3)
    w3q = _quant_w(w3, s_w3_eff, (None, slice(None)))

    # dense2: logits dequantized to f32 (the argmax needs the true affine).
    w4 = np.asarray(p["Dense2"]["kernel"]).astype(np.float64)
    b4 = np.asarray(p["Dense2"]["bias"]).astype(np.float64)
    s_w4 = _per_channel_scale(w4, (0,))
    w4q = _quant_w(w4, s_w4, (None, slice(None)))
    s4 = (s_a3 * s_w4).astype(np.float32)

    return QuantizedModel(
        s_x=np.float32(s_x), w1p=w1p, m1=m1, o1=o1, w2p=w2p, m2=m2, o2=o2,
        w3=w3q, m3=m3, o3=o3, w4=w4q, s4=s4, b4=b4.astype(np.float32))


def quantize(model: VTCNN2, calib_x: np.ndarray,
             percentile: float = 99.99) -> QuantizedModel:
    """Float torch model -> packed int8 deployment artifact."""
    scales = calibrate_activations(model, calib_x, percentile)
    return quantize_params(flax_params(model), scales)
