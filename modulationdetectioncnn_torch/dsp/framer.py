"""Overlap-save framer on I/Q planes (counterpart of the JAX ``dsp/framer.py``).

The continuous-stream -> blocks transform that makes streamed classification
equal whole-stream classification: each block carries ``halo`` samples of
history, so filtering a block and dropping its halo gives exactly the
samples the whole stream would.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def overlap_save_blocks(x: torch.Tensor, block_len: int, halo: int) -> torch.Tensor:
    """(..., T) -> (..., ceil(T/B), halo + B). Zero history for block 0; the
    last partial block is zero-padded on the right."""
    t_len = x.shape[-1]
    n_blocks = -(-t_len // block_len)
    padded = F.pad(x, (halo, n_blocks * block_len - t_len))
    return padded.unfold(-1, halo + block_len, block_len)


def trim_halo(blocks: torch.Tensor, halo: int) -> torch.Tensor:
    """Drop the (invalid after filtering) halo prefix of each block."""
    return blocks[..., halo:]


def concat_blocks(blocks: torch.Tensor, out_len: int) -> torch.Tensor:
    """Inverse of ``overlap_save_blocks`` then ``trim_halo``: (..., NB, B)
    -> the stream (..., out_len)."""
    return blocks.reshape(blocks.shape[:-2] + (-1,))[..., :out_len]


def frames_from_stream(x: torch.Tensor, frame_len: int,
                       hop: int | None = None) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_len), frame i starting at i*hop;
    n_frames = (T - frame_len) // hop + 1 and the remainder is dropped.
    Default hop = frame_len (non-overlapping)."""
    hop = hop or frame_len
    if x.shape[-1] < frame_len:
        return x.new_zeros(x.shape[:-1] + (0, frame_len))
    return x.unfold(-1, frame_len, hop)


def iq_frames(frames: torch.Tensor) -> torch.Tensor:
    """Complex frames (..., N, T) -> float32 (..., N, 2, T) classifier input."""
    return torch.stack([frames.real, frames.imag], dim=-2).to(torch.float32)


def to_planes(x, device: str | torch.device = "cpu") -> torch.Tensor:
    """Complex (..., T) -> I/Q planes (..., 2, T) float32 (host boundary)."""
    x = np.asarray(x)
    planes = np.stack([x.real, x.imag], axis=-2).astype(np.float32)
    return torch.from_numpy(planes).to(device)


def from_planes(xiq) -> np.ndarray:
    """I/Q planes (..., 2, T) -> complex64 (..., T) on the host."""
    xiq = xiq.cpu().numpy() if isinstance(xiq, torch.Tensor) else np.asarray(xiq)
    return (xiq[..., 0, :] + 1j * xiq[..., 1, :]).astype(np.complex64)
