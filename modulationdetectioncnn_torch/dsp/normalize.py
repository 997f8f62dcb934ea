"""Per-frame power and carrier (CFO) normalization on I/Q planes.

Counterpart of ``power_normalize``, ``estimate_cfo`` and ``correct_cfo`` of
the JAX ``dsp/normalize.py``, with the same arithmetic in the same order:
CFO by the FFT-of-x^4 method (a padded DFT as two real matmuls), parabolic
peak refinement. Timing estimation and correction (off by default) are not
ported yet.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _cmul(ar, ai, br, bi):
    """Complex multiply on planes: (ar+i*ai)*(br+i*bi)."""
    return ar * br - ai * bi, ar * bi + ai * br


@functools.lru_cache(maxsize=16)
def _padded_dft_matrices(t: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """cos/sin of the (T, n) padded-DFT matrix: F[t, f] = exp(-2pi*i*t*f/n)."""
    tf = np.outer(np.arange(t), np.arange(n)).astype(np.float64)
    ang = -2.0 * np.pi * tf / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def power_normalize(x: torch.Tensor) -> torch.Tensor:
    """Unit average power per frame (mean |x|^2 of the complex frame).
    x: (..., 2, T) f32."""
    x = x.to(torch.float32)
    p = (x ** 2).sum(dim=-2, keepdim=True).mean(dim=-1, keepdim=True) + 1e-30
    return x / torch.sqrt(p)


def estimate_cfo(x: torch.Tensor, order: int = 4, pad_factor: int = 4) -> torch.Tensor:
    """CFO in cycles/sample for each frame. x: (..., 2, T) f32 -> (...)."""
    xr, xi = x[..., 0, :].to(torch.float32), x[..., 1, :].to(torch.float32)
    # x**order by repeated squaring on planes.
    pr, pi = torch.ones_like(xr), torch.zeros_like(xi)
    br, bi = xr, xi
    o = order
    while o > 0:
        if o & 1:
            pr, pi = _cmul(pr, pi, br, bi)
        o >>= 1
        if o:
            br, bi = _cmul(br, bi, br, bi)
    t = x.shape[-1]
    n = t * pad_factor
    cos_m, sin_m = (torch.from_numpy(a).to(x.device)
                    for a in _padded_dft_matrices(t, n))
    zr = pr @ cos_m - pi @ sin_m
    zi = pi @ cos_m + pr @ sin_m
    spec2 = zr * zr + zi * zi                     # |Z|^2: same argmax as |Z|
    k = torch.argmax(spec2, dim=-1)               # first index of the maximum

    def mag_at(idx):
        return torch.sqrt(torch.gather(spec2, -1, (idx % n)[..., None])[..., 0])

    alpha, beta, gamma = mag_at(k - 1), mag_at(k), mag_at(k + 1)
    denom = alpha - 2 * beta + gamma
    delta = torch.where(denom.abs() > 1e-30, 0.5 * (alpha - gamma) / denom,
                        torch.zeros_like(denom))
    freq = (k.to(torch.float32) + delta) / n
    freq = torch.where(freq > 0.5, freq - 1.0, freq)
    return freq / order


def correct_cfo(x: torch.Tensor, cfo: torch.Tensor) -> torch.Tensor:
    """Remove the estimated CFO: x * exp(-2pi*i*cfo*t) on planes; cfo
    broadcasts over the leading axes of x (..., 2, T)."""
    t = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    ang = -2.0 * math.pi * cfo[..., None] * t
    c, s = torch.cos(ang), torch.sin(ang)
    yr, yi = _cmul(x[..., 0, :], x[..., 1, :], c, s)
    return torch.stack([yr, yi], dim=-2).to(torch.float32)
