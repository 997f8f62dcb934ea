"""Plain reference of the stream front end: wideband I/Q -> normalized frames.

Written from the front end's published arithmetic, whole-stream (no
overlap-save blocks, whose halo makes blocked streaming equal to this):

- polyphase channelizer: a Kaiser-windowed-sinc prototype of M * taps
  coefficients (beta 9, unit DC gain), branch p filtering every M-th sample,
  then an M-point DFT, subband k at k/M cycles per sample;
- frames of ``frame_len`` subband samples every ``hop``;
- per frame: unit mean power; carrier offset by the DFT (``pad`` times the
  frame) of x**4, its first largest bin refined by a parabola through the
  magnitudes, divided by 4, and removed; optionally symbol timing by the
  Oerder & Meyr square-law estimate, then a fractional delay by one phase of
  a ``phases`` x 8-tap Kaiser-windowed-sinc interpolator (beta 8) applied as
  a 17-tap FIR.

Every product and sum runs in ``dtype`` (float64 for the reference, float32
for the control); the DFTs are matrix products, so TF32, where it is on,
reaches them as it would reach the program's. Plain torch and NumPy only.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def prototype(m: int, taps: int, beta: float = 9.0) -> np.ndarray:
    n = np.arange(m * taps, dtype=np.float64)
    h = np.sinc((n - (m * taps - 1) / 2.0) / m) * np.kaiser(m * taps, beta)
    return h / h.sum()


def interpolator_bank(phases: int, taps: int = 8, beta: float = 8.0) -> np.ndarray:
    """(phases, taps + 1): phase p holds h[i * phases + p] of the odd-length
    prototype h (length phases * taps + 1, unit gain at its centre)."""
    ln = phases * taps + 1
    n = np.arange(ln, dtype=np.float64)
    c = (ln - 1) / 2.0
    h = np.sinc((n - c) / phases) * np.kaiser(ln, beta)
    h = h / h[int(c)]
    g = np.zeros((phases, taps + 1))
    for p in range(phases):
        g[p, :len(h[p::phases])] = h[p::phases]
    return g


def _dft(n_in: int, n_out: int, dtype, device):
    ang = -2.0 * np.pi * np.outer(np.arange(n_in), np.arange(n_out)) / n_out
    return (torch.tensor(np.cos(ang), dtype=dtype, device=device),
            torch.tensor(np.sin(ang), dtype=dtype, device=device))


def channelize(x: torch.Tensor, m: int, taps: int) -> torch.Tensor:
    """(2, T) -> (M, 2, T // M): subband k's I/Q stream, zero history."""
    re, im = x[0].reshape(-1, m), x[1].reshape(-1, m)          # (N, M)
    h = torch.tensor(prototype(m, taps).reshape(taps, m), dtype=x.dtype,
                     device=x.device)
    vr, vi = torch.zeros_like(re), torch.zeros_like(im)
    n = re.shape[0]
    for t in range(taps):
        vr[t:] += h[t] * re[:n - t]
        vi[t:] += h[t] * im[:n - t]
    c, s = _dft(m, m, x.dtype, x.device)
    zr, zi = vr @ c - vi @ s, vr @ s + vi @ c                    # (N, M)
    return torch.stack([zr.T, zi.T], dim=1)


def frames(sub: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """(M, 2, N) -> (M, F, 2, frame_len)."""
    return sub.unfold(-1, frame_len, hop).transpose(1, 2)


def power_normalize(fr: torch.Tensor) -> torch.Tensor:
    p = (fr[..., 0, :] ** 2 + fr[..., 1, :] ** 2).mean(-1) + 1e-30
    return fr / torch.sqrt(p)[..., None, None]


def carrier_offset(fr: torch.Tensor, pad: int) -> torch.Tensor:
    """(..., 2, T) -> (...) cycles per sample."""
    z = torch.complex(fr[..., 0, :], fr[..., 1, :])
    z = z * z
    z = z * z
    t = fr.shape[-1]
    n = t * pad
    c, s = _dft(t, n, fr.dtype, fr.device)
    yr = z.real @ c - z.imag @ s
    yi = z.imag @ c + z.real @ s
    mag2 = yr * yr + yi * yi
    k = torch.argmax(mag2, dim=-1)

    def mag(i):
        return torch.sqrt(torch.gather(mag2, -1, (i % n)[..., None])[..., 0])

    a, b, g = mag(k - 1), mag(k), mag(k + 1)
    den = a - 2 * b + g
    delta = torch.where(den.abs() > 1e-30, 0.5 * (a - g) / den, torch.zeros_like(den))
    f = (k.to(fr.dtype) + delta) / n
    f = torch.where(f > 0.5, f - 1.0, f)
    return f / 4


def rotate(fr: torch.Tensor, cycles: torch.Tensor) -> torch.Tensor:
    """Multiply each frame by exp(-2 pi i cycles t)."""
    t = torch.arange(fr.shape[-1], dtype=fr.dtype, device=fr.device)
    ang = -2.0 * math.pi * cycles[..., None] * t
    c, s = torch.cos(ang), torch.sin(ang)
    re, im = fr[..., 0, :], fr[..., 1, :]
    return torch.stack([re * c - im * s, re * s + im * c], dim=-2)


def _wrap(a: torch.Tensor, m: float) -> torch.Tensor:
    """a modulo m, with the sign of m."""
    r = torch.fmod(a, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def timing_offset(fr: torch.Tensor, sps: int) -> torch.Tensor:
    e = fr[..., 0, :] ** 2 + fr[..., 1, :] ** 2
    t = torch.arange(fr.shape[-1], dtype=fr.dtype, device=fr.device)
    ang = -2.0 * math.pi * t / sps
    cr, ci = (e * torch.cos(ang)).sum(-1), (e * torch.sin(ang)).sum(-1)
    return _wrap(-torch.atan2(ci, cr) / (2 * math.pi) * sps, sps)


def retime(fr: torch.Tensor, tau: torch.Tensor, sps: int, phases: int,
           taps: int = 8) -> torch.Tensor:
    """Delay each frame by -tau (wrapped to [-sps/2, sps/2)) with the
    interpolator phase nearest tau * phases (ties to even)."""
    tau_c = _wrap(tau + sps / 2.0, sps) - sps / 2.0
    s = torch.round(tau_c * phases).long() + phases * taps // 2
    d = torch.div(s, phases, rounding_mode="floor")
    p = torch.remainder(s, phases)
    bank = torch.tensor(interpolator_bank(phases, taps)[:, ::-1].copy(),
                        dtype=fr.dtype, device=fr.device)
    w = bank[p]                                                  # (..., taps+1)
    n_big, t_len = 2 * taps + 1, fr.shape[-1]
    j = torch.arange(n_big, device=fr.device)
    idx = (j - d[..., None]).clamp(0, taps)
    cbig = torch.where((j >= d[..., None]) & (j <= d[..., None] + taps),
                       torch.gather(w, -1, idx), torch.zeros((), dtype=fr.dtype,
                                                             device=fr.device))
    xp = torch.nn.functional.pad(fr, (taps, taps))
    out = torch.zeros_like(fr)
    for k in range(n_big):
        out = out + xp[..., k:k + t_len] * cbig[..., None, k:k + 1]
    return out


def stream_frames(x: torch.Tensor, sc: dict, dtype=torch.float64) -> torch.Tensor:
    """Wideband (2, T) -> (M, F, 2, frame_len) normalized frames in ``dtype``.
    ``sc`` holds the front end's settings: num_subbands, taps_per_branch,
    frame_len, frame_hop, cfo_pad_factor, normalize_timing, sps,
    timing_phases."""
    x = x.to(dtype)
    sub = channelize(x, sc["num_subbands"], sc["taps_per_branch"])
    fr = power_normalize(frames(sub, sc["frame_len"], sc["frame_hop"]))
    fr = rotate(fr, carrier_offset(fr, sc["cfo_pad_factor"]))
    if sc["normalize_timing"]:
        fr = retime(fr, timing_offset(fr, sc["sps"]), sc["sps"], sc["timing_phases"])
    return fr
