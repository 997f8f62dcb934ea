"""Polyphase FIR filtering and rational resampling on I/Q planes.

Counterpart of the JAX ``dsp/fir.py``: the wideband up/down resampler in
front of the channelizer (``StreamConfig.resample_up/down``). The layout is
real I/Q planes ``(..., 2, T)`` float32, I and Q filtered alike.

The resampler is the JAX package's windows-matmul form: outputs come in
tiles of ``r_tile*up`` from overlapping input windows of ``k_pad`` samples,
as one float32 product against a precomputed polyphase weight matrix. A
degenerate geometry (taps too long for the tile) keeps the direct form:
zero-stuffing and a strided depthwise ``conv1d``. The JAX package leaves
both to XLA (``dot_general``, ``conv_general_dilated``), so they stay plain
torch ops here (``torch.matmul``, ``conv1d``). Golden reference:
``golden/dsp.py::fir_resample`` / ``fir_filter`` of the JAX package (causal,
zero initial state).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as sp_signal

from modulationdetectioncnn_torch.device import host_constant


def design_lowpass(num_taps: int, cutoff: float, beta: float = 6.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass; cutoff in cycles/sample (0..0.5)."""
    return sp_signal.firwin(num_taps, cutoff * 2, window=("kaiser", beta)).astype(
        np.float64)


def _conv_iq(xiq: torch.Tensor, h: np.ndarray, up: int, down: int) -> torch.Tensor:
    """Causal depthwise conv on (..., 2, T) real I/Q with zero-stuffing by
    ``up`` and stride ``down``: exactly ceil(T*up/down) outputs (right-padded
    so the strided window count matches the golden's truncate-then-decimate
    definition)."""
    taps = len(h)
    t_in = xiq.shape[-1]
    out_len = -(-t_in * up // down)
    dilated = (t_in - 1) * up + 1
    pad_right = max(0, down * (out_len - 1) + 1 - dilated)
    lead = xiq.shape[:-2]
    b = math.prod(lead)
    x = xiq.reshape(b, 2, t_in).to(torch.float32)
    stuffed = x.new_zeros((b, 2, dilated))
    stuffed[..., ::up] = x
    stuffed = F.pad(stuffed, (taps - 1, pad_right))
    # conv1d is a cross-correlation: the reversed taps give the direct-form
    # convolution. cuDNN would run a float32 conv in TF32 by default.
    w = host_constant(np.ascontiguousarray(np.asarray(h, np.float32)[::-1]),
                      x.device).expand(2, 1, taps)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv1d(stuffed, w, stride=down, groups=2)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out.reshape(lead + (2, out.shape[-1]))


def fir_filter_iq(xiq: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """Causal FIR on I/Q planes (..., 2, T), output length == input length."""
    return _conv_iq(xiq, h, up=1, down=1)


@functools.lru_cache(maxsize=16)
def _resample_window_matrix(h: tuple, up: int, down: int, r_tile: int,
                            k_pad: int, halo: int) -> np.ndarray:
    """Polyphase weights (k_pad, r_tile*up) for the windows-matmul resampler:
    W[k, q] = h[q*down + (halo - k)*up] (zero outside the tap range), so that
    y[m*R*up + q] = sum_k W[k, q] * x[m*R*down - halo + k]. ``h`` is a tuple
    so the matrix is cached per filter."""
    taps = len(h)
    w = np.zeros((k_pad, r_tile * up), np.float32)
    for q in range(r_tile * up):
        for k in range(k_pad):
            tap = q * down + (halo - k) * up
            if 0 <= tap < taps:
                w[k, q] = h[tap]
    return w


def resample_geometry(taps: int, up: int, down: int) -> tuple[int, int, int]:
    """(halo, k_pad, r_tile) of the windows-matmul form: ``halo`` causal
    history samples, windows of ``k_pad`` inputs, ``r_tile*up`` outputs per
    window; ``r_tile`` 0 marks the degenerate geometry (conv form)."""
    halo = -(-(taps - 1) // up)
    k_pad = 256 if (128 + halo) <= 256 else -(-(128 + halo) // 128) * 128
    r_tile = (k_pad - halo) // down
    if r_tile < 1 or k_pad - r_tile * down > r_tile * down:
        r_tile = 0
    return halo, k_pad, r_tile


def fir_resample_iq(xiq: torch.Tensor, h: np.ndarray, up: int, down: int) -> torch.Tensor:
    """Rational up/down resampling on I/Q planes (..., 2, T). Output length
    ceil(T*up/down), matching the golden (full conv truncated to T*up, then
    ::down).

    Outputs are produced in tiles of R*up from overlapping input windows of
    K = k_pad samples (R*down new ones plus the causal history), as ONE
    float32 (n_tiles*rows, K) x (K, R*up) product against the polyphase
    weight matrix. The windows are two shifted reshapes of the zero-padded
    stream: zero left-padding is the golden's zero history, and the right
    padding only feeds outputs past the truncation point."""
    taps = len(h)
    t_in = xiq.shape[-1]
    out_len = -(-t_in * up // down)                           # ceil
    halo, k_pad, r_tile = resample_geometry(taps, up, down)
    if r_tile == 0:
        return _conv_iq(xiq, h, up, down)[..., :out_len]
    s = r_tile * down
    n_tiles = -(-out_len // (r_tile * up))
    lead = xiq.shape[:-1]
    b = math.prod(lead)
    x = xiq.reshape(b, t_in).to(torch.float32)
    total = (n_tiles + 1) * s
    x_pad = F.pad(x, (halo, total - halo - t_in))
    w1 = x_pad[:, :n_tiles * s].reshape(b, n_tiles, s)
    w2 = x_pad[:, s:(n_tiles + 1) * s].reshape(b, n_tiles, s)[:, :, :k_pad - s]
    windows = torch.cat([w1, w2], dim=-1).reshape(b * n_tiles, k_pad)
    wmat = host_constant(_resample_window_matrix(
        tuple(np.asarray(h, np.float64).tolist()), up, down, r_tile, k_pad,
        halo), x.device)
    y = torch.matmul(windows, wmat).reshape(b, n_tiles * r_tile * up)
    return y[:, :out_len].reshape(lead + (out_len,))


def _to_iq(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return torch.stack([x.real, x.imag], dim=-2).to(torch.float32)


def _from_iq(xiq: torch.Tensor) -> torch.Tensor:
    return torch.complex(xiq[..., 0, :], xiq[..., 1, :]).to(torch.complex64)


def fir_filter(x, h: np.ndarray) -> torch.Tensor:
    """Complex (..., T) -> complex64 (..., T): ``fir_filter_iq`` on the
    I/Q planes of ``x`` (a complex tensor or array)."""
    return _from_iq(fir_filter_iq(_to_iq(x), h))


def fir_resample(x, h: np.ndarray, up: int, down: int) -> torch.Tensor:
    """Complex (..., T) -> complex64 (..., ceil(T*up/down)):
    ``fir_resample_iq`` on the I/Q planes of ``x``."""
    return _from_iq(fir_resample_iq(_to_iq(x), h, up, down))
