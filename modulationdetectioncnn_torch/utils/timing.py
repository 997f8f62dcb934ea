"""Chained device timing for the bench.

Counterpart of ``modulationdetectioncnn_tpu/utils/timing.py``'s
``measure_per_iter_chained_samples``. Each iteration's input depends on the
previous iteration's output (``body(carry) -> carry``), so no two
iterations can overlap on the device, and the time of two run lengths is
differenced so that the constant cost of starting and ending a run cancels.

On a CUDA device each run is timed with CUDA events recorded on the current
stream around it; on the CPU (only when the caller asked for it) with the
host clock. The result always belongs to the device the carry lives on.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch


def _run_seconds(body: Callable[[Any], Any], carry0: torch.Tensor, n: int) -> float:
    if carry0.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        c = carry0
        start.record()
        for _ in range(n):
            c = body(c)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    c = carry0
    for _ in range(n):
        c = body(c)
    return time.perf_counter() - t0


def measure_per_iter_chained_samples(body: Callable[[Any], Any],
                                     carry0: torch.Tensor, n1: int = 4,
                                     n2: int = 20, repeats: int = 3) -> list[float]:
    """Seconds per ``body`` application, one estimate per (n1, n2) pair of
    runs, ``repeats`` pairs interleaved after one warm-up run of n2 (it
    also grows the caching allocator to the run's working set)."""
    if n2 <= n1:
        raise ValueError(f"n2 ({n2}) must exceed n1 ({n1})")
    with torch.no_grad():
        _run_seconds(body, carry0, n2)
        samples = []
        for _ in range(repeats):
            t1 = _run_seconds(body, carry0, n1)
            t2 = _run_seconds(body, carry0, n2)
            samples.append((t2 - t1) / (n2 - n1))
    return samples


def launch_ms_samples(fn: Callable[[], Any], iters: int = 20, warmup: int = 3,
                      reps: int = 5) -> list[float]:
    """Milliseconds per call of ``fn`` on the card, one sample per run of
    ``iters`` back-to-back calls between two CUDA events on the current
    stream (``reps`` runs after ``warmup`` calls). Stream order runs the
    calls one after another; a sample is the longer of the device's time
    and the host's time to issue the calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("launch timing needs a CUDA device")
    with torch.no_grad():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            stop.record()
            stop.synchronize()
            samples.append(start.elapsed_time(stop) / iters)
    return samples
