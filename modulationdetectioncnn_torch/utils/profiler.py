"""Profiling hooks and roofline accounting for the port.

Counterpart of ``modulationdetectioncnn_tpu/utils/profiler.py``: ``trace()``
writes a region's Chrome/Perfetto trace (``torch.profiler``), and
``roofline()`` turns a rate into shares of the NVIDIA H100 SXM's data-sheet
peaks (dense, no sparsity, at the 700 W power limit): 989 TFLOP/s bf16 and
1,979 TOP/s int8. A card set below 700 W (``nvidia-smi
--query-gpu=power.limit``) runs below them.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from dataclasses import dataclass

H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_INT8_OPS = 1979e12

# VT-CNN2 per-frame multiply-accumulates: conv1 0.39M (2 rows), conv2
# 15.2M, dense1 2.54M, dense2 2.8K.
MACS_PER_FRAME = 18_127_696
SAMPLES_PER_FRAME = 128


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``with trace('/tmp/tb'):`` -> a Chrome/Perfetto trace of the region.

    ``logdir or $AMC_TRACE_DIR`` decides, as in the JAX package. Without a
    directory the region runs with no profiler and nothing is written.
    With one, the directory is made and the region runs under
    ``torch.profiler``: CPU activity, and CUDA activity when a card is
    present (synchronised before the profiler stops, where the process
    uses it, so the region's kernels are in the trace). On exit, also by an
    exception, which propagates unchanged, one
    ``<host>_<pid>.<time_ns>.pt.trace.json`` is written there, so two
    regions never overwrite each other. A trace is one region and is not
    taken again: where the profiler drops device records (late in a long
    process, PERF.md section 7), the file holds fewer kernels than ran;
    ``device_records`` retries for that reason."""
    logdir = logdir or os.environ.get("AMC_TRACE_DIR")
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))
    prof.start()
    try:
        yield
    finally:
        if cuda and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"))


@dataclass
class Roofline:
    samples_per_sec: float
    ops_per_sec: float
    pct_of_bf16_peak: float
    pct_of_int8_peak: float

    def as_dict(self):
        return {
            "samples_per_sec": round(self.samples_per_sec),
            "tops_per_sec": round(self.ops_per_sec / 1e12, 2),
            "pct_of_bf16_peak": round(self.pct_of_bf16_peak, 1),
            "pct_of_int8_peak": round(self.pct_of_int8_peak, 1),
            "peaks": "H100 SXM data sheet: 989 TFLOP/s bf16, 1979 TOP/s int8",
        }


def roofline(samples_per_sec: float) -> Roofline:
    ops = samples_per_sec / SAMPLES_PER_FRAME * MACS_PER_FRAME * 2
    return Roofline(
        samples_per_sec=samples_per_sec,
        ops_per_sec=ops,
        pct_of_bf16_peak=100 * ops / H100_PEAK_BF16_FLOPS,
        pct_of_int8_peak=100 * ops / H100_PEAK_INT8_OPS,
    )


def device_events(prof) -> list:
    """The entries of ``prof.key_averages()`` that are work on the card
    (kernels, copies, memsets), each counted once, as torch's own total
    counts them: an operator's entry repeats the device time of the kernels
    it launched, so a sum over every entry counts those twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def device_records(fn, iters: int, tries: int = 6) -> list:
    """``device_events`` of ``iters`` calls of ``fn`` under ``torch.profiler``
    after a warm-up. The profiler at times drops some or all of a run's
    device records on the card (an entry then counts fewer launches than the
    calls made, or none is there), several runs in a row late in a long
    process; a run without entries or with an entry whose count is not a
    multiple of ``iters`` is taken again, up to ``tries`` runs. [] when none
    is whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            events = device_events(prof)
            if events and all(e.count % iters == 0 for e in events):
                return events
    return []


def device_ms_per_call(fn, iters: int = 10) -> float | None:
    """The card's busy time per call of ``fn``: the device time of every
    kernel and copy under ``torch.profiler`` over ``iters`` calls after a
    warm-up (``device_records``), per call. None when the profiler records
    no whole run (it then cannot see the card)."""
    total_us = sum(e.self_device_time_total for e in device_records(fn, iters))
    return total_us / iters / 1e3 if total_us > 0 else None
