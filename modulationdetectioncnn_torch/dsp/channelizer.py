"""Polyphase filter-bank channelizer on I/Q planes.

Counterpart of the JAX ``dsp/channelizer.py``: splits a wideband stream into
M critically-sampled subbands. The layout stays real I/Q planes
``(..., 2, T)`` float32, as in the JAX package, so the port's public shapes
match the reference's. The per-phase FIR is a short loop of shifted
multiply-adds and the M-point DFT two real matmuls, left to PyTorch's own
operators (the JAX package leaves them to XLA; no kernel is written here).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from modulationdetectioncnn_torch.device import host_constant


def design_prototype(num_subbands: int, taps_per_branch: int,
                     beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed-sinc lowpass prototype for the PFB channelizer.

    Length M*taps, cutoff 1/(2M) (critically sampled), unit DC gain. A copy
    of ``golden/dsp.py::design_prototype``."""
    m, t = num_subbands, taps_per_branch
    n = np.arange(m * t, dtype=np.float64)
    center = (m * t - 1) / 2.0
    arg = (n - center) / m  # sinc argument in units of the subband rate
    h = np.sinc(arg) * np.kaiser(m * t, beta)
    return h / h.sum()


def design_interp(n_phases: int, taps_per_phase: int = 8,
                  beta: float = 8.0) -> np.ndarray:
    """Polyphase fractional-delay interpolator prototype (timing correction,
    ``dsp/normalize.py::correct_timing``): a Kaiser-windowed sinc at the
    ``n_phases``-times-upsampled rate, odd length P*taps+1 (integer centre,
    so an exact zero-delay phase), unit gain for that phase. A copy of
    ``golden/dsp.py::design_interp``."""
    p, t = n_phases, taps_per_phase
    ln = p * t + 1
    n = np.arange(ln, dtype=np.float64)
    center = (ln - 1) / 2.0
    h = np.sinc((n - center) / p) * np.kaiser(ln, beta)
    return h / h[int(center)]


@functools.lru_cache(maxsize=16)
def dft_matrices(m: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag parts of the M-point DFT matrix F[p, k] = exp(-2pi*i*pk/M)."""
    pk = np.outer(np.arange(m), np.arange(m)).astype(np.float64)
    ang = -2.0 * np.pi * pk / m
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def dft_iq(v: torch.Tensor) -> torch.Tensor:
    """M-point DFT over the last axis of I/Q planes: (..., 2, N, M) ->
    (..., 2, N, M), out[..., 0] + i*out[..., 1] = FFT(v[..., 0] + i*v[..., 1])."""
    fr, fi = (host_constant(a, v.device) for a in dft_matrices(v.shape[-1]))
    vr, vi = v[..., 0, :, :], v[..., 1, :, :]
    zr = vr @ fr - vi @ fi
    zi = vr @ fi + vi @ fr
    return torch.stack([zr, zi], dim=-3)


def channelize(x: torch.Tensor, h: np.ndarray, num_subbands: int) -> torch.Tensor:
    """Critically-sampled PFB analysis: (..., 2, T) f32, T % M == 0 ->
    (..., 2, T//M, M); subband k is centred at k/M cycles/sample."""
    m = num_subbands
    taps = len(h) // m
    t_len = x.shape[-1]
    if x.shape[-2] != 2:
        raise ValueError(f"expected I/Q planes (..., 2, T), got {tuple(x.shape)}")
    if t_len % m:
        raise ValueError(f"stream length {t_len} is not a multiple of {m}")
    n_blocks = t_len // m
    xp = x.reshape(x.shape[:-1] + (n_blocks, m))             # (..., 2, NB, M)
    h_poly = host_constant(np.asarray(h, np.float32).reshape(taps, m), x.device)
    # Causal FIR along the block axis: v[n, p] = sum_t h_poly[t, p] xp[n-t, p].
    xpad = F.pad(xp, (0, 0, taps - 1, 0))
    v = torch.zeros_like(xp)
    for t in range(taps):
        start = taps - 1 - t                                  # xp[n-t]
        v = v + h_poly[t] * xpad[..., start:start + n_blocks, :]
    return dft_iq(v)


def subband_center_freqs(num_subbands: int) -> np.ndarray:
    """Centre frequency of each subband in cycles/sample (FFT convention)."""
    f = np.arange(num_subbands) / num_subbands
    f[f > 0.5] -= 1.0
    return f
