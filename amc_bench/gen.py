"""The benchmark's one traffic generator.

A traffic file (``traffic/<name>.json``) holds parameters only; this module
reads them and makes the inputs on the device from the seed, with one
``torch.Generator`` there, in a fixed order of draws. Every seed gets the
same sizes (samples, frames, occupied subbands, frames per class); the seed
picks the classes, SNRs, carrier offsets, phases, symbols and noise.

Two kinds:

- ``stream``: a pool of wideband captures, (2, T) float32 I/Q planes. Each
  holds ``occupied`` carriers in distinct subbands of a ``subbands``-way
  critically sampled grid, each a class of the 11 RadioML 2016.10a
  modulations at ``sps`` samples a symbol, its SNR (carrier power over the
  noise power in its subband) from the ``snr_db`` grid, a carrier offset
  N(0, cfo_sigma) clipped to +-max_cfo cycles a subband sample, and a random
  phase, synthesized by a polyphase filter bank over unit-variance complex
  white noise.
- ``frames``: a pool of (2, frame_len) float32 frames, the same modulations
  cut from one continuous signal per class, each frame with its own SNR,
  offset and phase, shuffled.
"""
from __future__ import annotations

import math

import numpy as np
import torch

CLASSES = ("8PSK", "AM-DSB", "AM-SSB", "BPSK", "CPFSK", "GFSK",
           "PAM4", "QAM16", "QAM64", "QPSK", "WBFM")


def _constellation(name: str) -> np.ndarray:
    if name in ("BPSK", "QPSK", "8PSK"):
        m = {"BPSK": 2, "QPSK": 4, "8PSK": 8}[name]
        return np.exp(1j * (2 * np.pi * np.arange(m) / m + (np.pi / 4 if m == 4 else 0.0)))
    if name == "PAM4":
        pts = (2 * np.arange(4) - 3).astype(np.complex128)
    else:
        side = int(math.isqrt(16 if name == "QAM16" else 64))
        re, im = np.meshgrid(np.arange(side), np.arange(side))
        pts = ((2 * re - side + 1) + 1j * (2 * im - side + 1)).reshape(-1)
    return pts / np.sqrt((np.abs(pts) ** 2).mean())


def _rrc(beta: float, sps: int, span: int) -> np.ndarray:
    """Root-raised-cosine pulse, unit energy."""
    t = np.arange(-span * sps, span * sps + 1) / sps
    h = np.empty_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-10:
            h[i] = 1 - beta + 4 * beta / np.pi
        elif abs(abs(4 * beta * ti) - 1) < 1e-10:
            h[i] = beta / np.sqrt(2) * ((1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                                        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            h[i] = ((np.sin(np.pi * ti * (1 - beta)) + 4 * beta * ti * np.cos(np.pi * ti * (1 + beta)))
                    / (np.pi * ti * (1 - (4 * beta * ti) ** 2)))
    return h / np.sqrt((h ** 2).sum())


def _gaussian(bt: float, sps: int, span: int = 3) -> np.ndarray:
    t = np.arange(-span * sps, span * sps + 1) / sps
    alpha = np.sqrt(np.log(2) / 2) / bt
    h = np.exp(-((np.pi * t / alpha) ** 2))
    return h / h.sum()


def _lowpass(taps: int, cutoff: float) -> np.ndarray:
    n = np.arange(taps) - (taps - 1) / 2
    h = np.sinc(2 * cutoff * n) * np.hamming(taps)
    return h / h.sum()


def _fir(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """Causal FIR along the last axis, output as long as ``x``."""
    ht = torch.tensor(h, dtype=torch.float64 if x.dtype in (torch.float64, torch.complex128)
                      else torch.float32, device=x.device)
    y = torch.zeros_like(x)
    n = x.shape[-1]
    for j in range(len(h)):
        y[..., j:] += ht[j] * x[..., :n - j]
    return y


def baseband(name: str, n: int, sps: int, g: torch.Generator, device) -> torch.Tensor:
    """``n`` complex64 samples of one modulation at ``sps`` samples a symbol,
    unit mean power."""
    if name in ("BPSK", "QPSK", "8PSK", "PAM4", "QAM16", "QAM64"):
        span = 8
        const = torch.tensor(_constellation(name), dtype=torch.complex64, device=device)
        n_sym = -(-n // sps) + 2 * span + 2
        up = torch.zeros(n_sym * sps, dtype=torch.complex64, device=device)
        up[::sps] = const[torch.randint(len(const), (n_sym,), generator=g, device=device)]
        x = _fir(up, _rrc(0.35, sps, span))[span * sps:span * sps + n]
    elif name in ("CPFSK", "GFSK"):
        span = 3 if name == "GFSK" else 0
        n_sym = -(-n // sps) + 2 * span + 2
        bits = torch.randint(2, (n_sym,), generator=g, device=device) * 2 - 1
        freq = bits.repeat_interleave(sps).to(torch.float64)
        if name == "GFSK":
            freq = _fir(freq, _gaussian(0.3, sps, span))
        phase = torch.remainder(torch.pi * 0.5 * torch.cumsum(freq, 0) / sps, 2 * torch.pi)
        x = torch.polar(torch.ones_like(phase), phase)[span * sps:span * sps + n]
    else:
        # voice-like source: low-passed noise and a tone, unit RMS
        m = n + 64
        src = _fir(torch.randn(m, generator=g, device=device), _lowpass(63, 0.06))[64:]
        f0 = 0.002 + 0.028 * torch.rand((), generator=g, device=device)
        ph = 2 * torch.pi * torch.rand((), generator=g, device=device)
        t = torch.arange(n, device=device, dtype=torch.float32)
        src = src + 0.5 * torch.sin(2 * torch.pi * f0 * t + ph)
        src = src / src.square().mean().sqrt()
        if name == "AM-DSB":
            x = torch.complex(1.0 + 0.5 * src, torch.zeros_like(src))
        elif name == "AM-SSB":
            spec = torch.fft.fft(src.to(torch.complex64))
            w = torch.zeros(n, device=device)
            w[0] = 1.0
            w[1:(n + 1) // 2] = 2.0
            if n % 2 == 0:
                w[n // 2] = 1.0
            x = torch.fft.ifft(spec * w)
        elif name == "WBFM":
            phase = torch.remainder(2 * torch.pi * 0.15 * torch.cumsum(src.to(torch.float64), 0),
                                    2 * torch.pi)
            x = torch.polar(torch.ones_like(phase), phase)
        else:
            raise ValueError(f"unknown modulation {name!r}")
    x = x.to(torch.complex64)
    return x / x.abs().square().mean().sqrt()


def _offset(n: int, cycles: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """exp(i (2 pi cycles t + phase)) for t = 0..n-1 along the last axis,
    the angle taken modulo 2 pi in float64."""
    t = torch.arange(n, dtype=torch.float64, device=cycles.device)
    ang = torch.remainder(2 * torch.pi * cycles[..., None].double() * t + phase[..., None].double(),
                          2 * torch.pi)
    return torch.polar(torch.ones_like(ang), ang).to(torch.complex64)


def _draws(spec: dict, n: int, g: torch.Generator, device):
    """SNR (dB), carrier offset and phase for ``n`` signals."""
    lo, hi, step = spec["snr_db"]
    grid = torch.arange(lo, hi + 1, step, dtype=torch.float32, device=device)
    snr = grid[torch.randint(len(grid), (n,), generator=g, device=device)]
    cfo = (torch.randn(n, generator=g, device=device) * spec["cfo_sigma"]).clamp(
        -spec["max_cfo"], spec["max_cfo"])
    phase = 2 * torch.pi * torch.rand(n, generator=g, device=device)
    return snr, cfo, phase


def _synthesis_prototype(m: int, taps: int) -> np.ndarray:
    n = np.arange(m * taps, dtype=np.float64)
    h = np.sinc((n - (m * taps - 1) / 2.0) / m) * np.kaiser(m * taps, 9.0)
    return h / h.sum()


def capture(spec: dict, g: torch.Generator, device) -> torch.Tensor:
    """One wideband capture, (2, T) float32."""
    m, t_len = spec["subbands"], spec["capture_samples"]
    n = t_len // m
    occ = torch.randperm(m, generator=g, device=device)[:spec["occupied"]].tolist()
    cls = torch.randint(len(CLASSES), (len(occ),), generator=g, device=device).tolist()
    snr, cfo, phase = _draws(spec, len(occ), g, device)
    sub = torch.zeros((m, n), dtype=torch.complex64, device=device)
    amp = torch.sqrt(10.0 ** (snr / 10.0) / m)
    for i, (k, c) in enumerate(zip(occ, cls)):
        s = baseband(CLASSES[c], n, spec["sps"], g, device)
        sub[k] = s * _offset(n, cfo[i], phase[i]) * amp[i]
    # Subband k at k/M cycles a wideband sample: at t = n*M + p its mixer is
    # exp(2 pi i k p / M), so branch p filters sum_k exp(2 pi i k p / M) s_k.
    kp = np.outer(np.arange(m), np.arange(m)) / m
    mix = torch.tensor(np.exp(2j * np.pi * kp), dtype=torch.complex64, device=device)
    u = mix.T @ sub                                             # (branch p, n)
    taps = spec["synthesis_taps_per_branch"]
    h = _synthesis_prototype(m, taps).reshape(taps, m) * m      # [j, p]
    hp = torch.tensor(h, dtype=torch.float32, device=device)
    w = torch.zeros_like(u)
    for j in range(taps):
        w[:, j:] += hp[j][:, None] * u[:, :n - j]
    x = w.T.reshape(-1)
    x = x + torch.complex(torch.randn(t_len, generator=g, device=device),
                          torch.randn(t_len, generator=g, device=device)) * math.sqrt(0.5)
    return torch.stack([x.real, x.imag]).contiguous()


def frames(spec: dict, g: torch.Generator, device) -> torch.Tensor:
    """The frame pool, (N, 2, frame_len) float32."""
    n_all, f = spec["pool_frames"], spec["frame_len"]
    counts = [n_all // len(CLASSES) + (i < n_all % len(CLASSES)) for i in range(len(CLASSES))]
    out = []
    for name, cnt in zip(CLASSES, counts):
        s = baseband(name, cnt * f, spec["sps"], g, device).reshape(cnt, f)
        snr, cfo, phase = _draws(spec, cnt, g, device)
        s = s / s.abs().square().mean(-1, keepdim=True).sqrt()
        s = s * _offset(f, cfo, phase)
        noise = torch.complex(torch.randn(cnt, f, generator=g, device=device),
                              torch.randn(cnt, f, generator=g, device=device))
        out.append(s + noise * torch.sqrt(10.0 ** (-snr / 10.0) / 2)[:, None])
    x = torch.cat(out)[torch.randperm(n_all, generator=g, device=device)]
    return torch.stack([x.real, x.imag], dim=1).contiguous()


def make(spec: dict, seed: int, device) -> list[torch.Tensor]:
    """The pool a traffic file describes, from ``seed``: ``pool`` captures
    for a stream, or ``pool_frames // batch`` batches (views of one frame
    pool, taken in order) for frames."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if spec["kind"] == "stream":
        return [capture(spec, g, device) for _ in range(spec["pool"])]
    if spec["kind"] == "frames":
        pool = frames(spec, g, device)
        b = spec["batch"]
        return [pool[i:i + b] for i in range(0, spec["pool_frames"] - b + 1, b)]
    raise ValueError(f"unknown traffic kind {spec['kind']!r}")
