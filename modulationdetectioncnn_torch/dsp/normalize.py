"""Per-frame power, carrier (CFO) and symbol-timing normalization on I/Q
planes.

Counterpart of the JAX ``dsp/normalize.py``, with the same arithmetic in
the same order: CFO by the FFT-of-x^4 method (a padded DFT as two real
matmuls) with parabolic peak refinement; timing by the Oerder & Meyr
square-law estimate and a polyphase fractional-delay correction (off by
default, ``StreamConfig.normalize_timing``). The correction's per-frame
17-tap FIR, a Pallas kernel in the JAX package, is the hand-written CUDA
kernel ``csrc/correct_timing.cu`` on the card (``correct_timing_fir``: a
register-window body for the stream's 128-sample frames, a shared-memory
body for other widths, ``correct_timing_fir_route``), with its plain
version beside it (``correct_timing_fir_plain``).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from modulationdetectioncnn_torch.device import host_constant
from modulationdetectioncnn_torch.dsp.channelizer import design_interp
from modulationdetectioncnn_torch.ops import _build


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
    cos_m, sin_m = (host_constant(a, x.device) for a in _padded_dft_matrices(t, n))
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


def estimate_timing(x: torch.Tensor, sps: int) -> torch.Tensor:
    """Oerder & Meyr symbol-timing estimate in samples, range [0, sps).
    x: (..., 2, T) f32 -> (...)."""
    e = x[..., 0, :] ** 2 + x[..., 1, :] ** 2
    t = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    ang = -2.0 * math.pi * t / sps
    cr = (e * torch.cos(ang)).sum(dim=-1)
    ci = (e * torch.sin(ang)).sum(dim=-1)
    tau = (-torch.atan2(ci, cr) / (2 * math.pi)) * sps
    return _floor_mod(tau, sps)


def _floor_mod(a: torch.Tensor, m: float) -> torch.Tensor:
    """``a % m`` with the sign of ``m``, computed as ``jnp.remainder`` does:
    the exact ``fmod``, then ``+ m`` where the signs differ."""
    r = torch.fmod(a, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


@functools.lru_cache(maxsize=8)
def _interp_bank(n_phases: int, taps_per_phase: int) -> np.ndarray:
    """(P, taps+1) causal phase filters g_p[i] = h[i*P + p] of the
    interpolator prototype (``design_interp``), zero-padded."""
    p_n, t_n = n_phases, taps_per_phase
    h = design_interp(p_n, t_n)
    g = np.zeros((p_n, t_n + 1), dtype=np.float64)
    for p in range(p_n):
        gp = h[p::p_n]
        g[p, :len(gp)] = gp
    return g.astype(np.float32)


def timing_filters(tau: torch.Tensor, sps: int, n_phases: int = 32,
                   taps_per_phase: int = 8) -> torch.Tensor:
    """The per-frame filters of ``correct_timing``, tau (...) samples ->
    (frames, 2*taps+1) float32, frames = tau.numel(). Each frame uses ONE
    phase filter of the interpolator bank, the phase nearest tau_c*P with
    tau_c = tau wrapped to [-sps/2, sps/2); its taps+1 weights, shifted by
    the frame's integer delay d, make the filter ``cbig[j] = w[j - d]``,
    added lane by lane as the JAX package adds it. Plain torch ops."""
    p_n, t_n = n_phases, taps_per_phase
    c = (p_n * t_n) // 2                       # centre of the P*taps+1 prototype
    tau = torch.as_tensor(tau, dtype=torch.float32).reshape(-1)
    tau_c = _floor_mod(tau + sps / 2.0, sps) - sps / 2.0
    s = torch.round(tau_c * p_n).to(torch.int32) + c   # half to even
    d = torch.div(s, p_n, rounding_mode="floor")[:, None]   # integer delay
    p = torch.remainder(s, p_n)                             # phase
    grev = host_constant(np.ascontiguousarray(
        _interp_bank(p_n, t_n)[:, ::-1]), tau.device)       # (P, taps+1)
    w = grev[p.long()]                                      # (frames, taps+1)
    n_big = 2 * t_n + 1
    jlane = torch.arange(n_big, dtype=torch.int32, device=tau.device)[None, :]
    cbig = torch.zeros((tau.shape[0], n_big), dtype=torch.float32, device=tau.device)
    for i in range(t_n + 1):
        cbig = cbig + torch.where(jlane == d + i, w[:, i:i + 1], 0.0)
    return cbig


def correct_timing(x: torch.Tensor, tau: torch.Tensor, sps: int,
                   n_phases: int = 32, taps_per_phase: int = 8) -> torch.Tensor:
    """Per-frame symbol-timing correction: y[n] ~= x(n + tau_c), with tau_c =
    tau wrapped to [-sps/2, sps/2). x: (..., 2, T) f32 planes; tau: (...)
    samples (float32), on x's device. The JAX package's formulation: the
    per-frame filters of ``timing_filters`` ((frames, 17) for the default 8
    taps per phase), applied to both planes by the fractional-delay FIR
    ``correct_timing_fir``."""
    t_len = x.shape[-1]
    lead = x.shape[:-2]
    b = math.prod(lead)
    cbig = timing_filters(tau, sps, n_phases, taps_per_phase)
    if cbig.shape[0] != b:
        raise ValueError(f"tau {tuple(tau.shape)} does not match frames {tuple(lead)}")
    out = correct_timing_fir(x.reshape(b, 2, t_len).to(torch.float32).contiguous(), cbig)
    return out.reshape(lead + (2, t_len))


def correct_timing_fir_plain(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The plain version of the timing FIR: x (B, 2, T) f32, c (B, taps) f32
    per-frame weights (taps odd) -> (B, 2, T) f32,
    ``out[b, h, n] = sum_j x_pad[b, h, n + j] * c[b, j]`` with x_pad = x and
    (taps-1)/2 zeros on each side, accumulated ``acc = acc + x * c[j]`` for
    j = 0, 1, ... (a rounded multiply, then a rounded add), as the JAX
    kernel does."""
    taps, t_len = c.shape[-1], x.shape[-1]
    xp = F.pad(x, ((taps - 1) // 2, (taps - 1) // 2))
    acc = torch.zeros_like(x)
    for j in range(taps):
        acc = acc + xp[..., j:j + t_len] * c[:, None, j:j + 1]
    return acc


# The general route keeps each row of the warp it runs on in 48 KB of
# static shared memory at most: 8 warps x (T + 2*taps - 1) floats.
_FIR_WARPS = 8
_FIR_SMEM_LIMIT = 48 * 1024
FIR_ROUTES = ("window", "general")
WINDOW_T = 128            # the window route's frame length
WINDOW_MAX_TAPS = 17      # its largest filter: (taps - 1) / 2 <= 8


def correct_timing_fir_route(t_len: int, taps: int, aligned: bool = True) -> str:
    """The timing FIR body a launch on the card takes, from the frame length,
    the (odd) filter length and whether ``x`` starts on a 16-byte boundary
    (B does not matter): ``"window"`` (``amc_correct_timing_fir_window``:
    one warp a frame, the window and the taps in registers) for T = 128 and
    taps <= 17, aligned, which covers the stream's frames and 17 taps;
    ``"general"`` (``amc_correct_timing_fir``) otherwise."""
    if aligned and t_len == WINDOW_T and taps % 2 == 1 and taps <= WINDOW_MAX_TAPS:
        return "window"
    return "general"


def correct_timing_fir(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The per-frame fractional-delay FIR of ``correct_timing``, (B, 2, T)
    f32 and (B, taps) f32 -> (B, 2, T) f32. Launches
    ``csrc/correct_timing.cu`` on a CUDA tensor, the body of
    ``correct_timing_fir_route`` (counted in ``launches`` and per route in
    ``route_launches``; a failure raises, no route retries on another),
    bit-exact against ``correct_timing_fir_plain``; the plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return correct_timing_fir_plain(x, c)
    name = "correct_timing_fir"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3 or x.shape[1] != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name}: expected (B, 2, T) float32 frames, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, _, t_len = x.shape
    if (c.dtype != torch.float32 or c.dim() != 2 or c.shape[0] != b
            or c.shape[1] % 2 == 0):
        raise ValueError(f"{name}: expected (B, taps) float32 weights with odd "
                         f"taps, got {tuple(c.shape)} {c.dtype}")
    taps = c.shape[1]
    for key, t in (("x", x), ("c", c)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on {x.device}")
    route = correct_timing_fir_route(t_len, taps, x.data_ptr() % 16 == 0)
    if route == "general" and _FIR_WARPS * (t_len + 2 * taps - 1) * 4 > _FIR_SMEM_LIMIT:
        raise ValueError(f"{name}: frame length {t_len} with {taps} taps "
                         "exceeds the kernel's shared memory")
    out = torch.empty_like(x)
    if b == 0:
        return out
    lib = _build.load_library()
    entry = lib.amc_correct_timing_fir_window if route == "window" else lib.amc_correct_timing_fir
    with torch.cuda.device(x.device):
        code = entry(x.data_ptr(), 2 * b, t_len, c.data_ptr(), taps, out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
    _build.check(lib, name, code)
    correct_timing_fir.launches += 1
    correct_timing_fir.route_launches[route] += 1
    return out


def reset_launch_counts() -> None:
    """The timing FIR's launch counts, in all and per route, to 0."""
    correct_timing_fir.launches = 0
    correct_timing_fir.route_launches = dict.fromkeys(FIR_ROUTES, 0)


reset_launch_counts()
