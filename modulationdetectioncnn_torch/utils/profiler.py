"""Profiling hooks, spans and counters, and roofline accounting for the port.

Counterpart of ``modulationdetectioncnn_tpu/utils/profiler.py``: ``trace()``
writes a region's Chrome/Perfetto trace (``torch.profiler``), and
``roofline()`` turns a rate into shares of the NVIDIA H100 SXM's data-sheet
peaks (dense, no sparsity, at the 700 W power limit): 989 TFLOP/s bf16 and
1,979 TOP/s int8. A card set below 700 W (``nvidia-smi
--query-gpu=power.limit``) runs below them.

``span(name)`` and ``count(name)`` mark the program's own layers (the names
start with ``amc.``). With no ``torch.profiler`` running they cost one check
and record nothing. Under a profiler a span is a ``record_function`` range
in the same trace as the device work, and is also kept in memory with its
start and end on the Unix clock (``time.time_ns``, the clock of the trace's
``ts`` plus its ``baseTimeNanoseconds``), its parent span and the id of its
root (one id a request). ``spans()``, ``counters()`` and ``self_ms(name)``
read the current session: it starts anew at the first span recorded under a
profiler after any span was entered without one (a warm-up before a traced
window), or at ``reset()``.
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.autograd import _profiler_enabled

H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_INT8_OPS = 1979e12

# VT-CNN2 per-frame multiply-accumulates at its published widths: conv1
# 193,536 (256 x 3 taps x 2 rows x 126), conv2 15,237,120 (80 x 256 x 2 x 3
# x 124), dense1 2,539,520 (9,920 x 256), dense2 2,816 (256 x 11).
MACS_PER_FRAME = 17_972_992
SAMPLES_PER_FRAME = 128


class SpanRecord(NamedTuple):
    """One span of a profiling session; times in ns on the Unix clock."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None    # id of the enclosing span; None for a root
    request: int          # id of the root span: shared by every span of one call


class _Session:
    """The spans and counters recorded under the profiler since the session
    began, and the spans open now."""

    def __init__(self):
        self.spans: list[SpanRecord] = []
        self.counters: dict[str, int] = {}
        self.open: list[_Span] = []
        self.next_id = 0
        self.stale = False     # a span was entered without a profiler

    def clear(self) -> None:
        self.spans, self.counters, self.stale = [], {}, False

    def begin(self) -> None:
        """Called under a profiler before recording: a stale session ends."""
        if self.stale:
            self.clear()


_SESSION = _Session()


class _Span:
    """A span under the profiler: a ``record_function`` range, and a
    ``SpanRecord`` when it closes. Opening the range takes tens of
    microseconds under the profiler, and the trace stamps its start about
    midway, so the start is the midpoint of clock reads on either side; the
    trace stamps the end at the close's last step, so the end is read just
    after it. Both then fall within a few tens of microseconds of the trace's
    stamps, unless a collection pause or a preemption falls inside the
    opening or the closing."""

    __slots__ = ("name", "rf", "start", "id", "parent", "request")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        s = _SESSION
        s.begin()
        self.rf = torch.profiler.record_function(self.name)
        t0 = time.time_ns()
        self.rf.__enter__()
        self.start = (t0 + time.time_ns()) // 2
        outer = s.open[-1] if s.open else None
        self.id, s.next_id = s.next_id, s.next_id + 1
        self.parent = outer.id if outer is not None else None
        self.request = outer.request if outer is not None else self.id
        s.open.append(self)
        return self

    def __exit__(self, *exc):
        s = _SESSION
        s.open.pop()
        self.rf.__exit__(*exc)
        s.spans.append(SpanRecord(self.name, self.start, time.time_ns(), self.id,
                                  self.parent, self.request))
        return False


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("amc.<layer>"):`` marks a layer of the program. Without a
    profiler: no record, no clock read, no device work."""
    if not _profiler_enabled():
        _SESSION.stale = True
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the session's counter ``name``; nothing without a
    profiler."""
    if not _profiler_enabled():
        return
    _SESSION.begin()
    _SESSION.counters[name] = _SESSION.counters.get(name, 0) + n


def reset() -> None:
    """Starts a new session: no spans, no counters."""
    _SESSION.clear()


def spans() -> list[SpanRecord]:
    """The session's closed spans, in the order they closed."""
    return list(_SESSION.spans)


def counters() -> dict[str, int]:
    """The session's counters."""
    return dict(_SESSION.counters)


def self_ms(name: str) -> float:
    """Self time of the session's spans ``name``, summed, in ms: each span's
    duration less the durations of its child spans (which never overlap)."""
    recs = _SESSION.spans
    ids = {r.id for r in recs if r.name == name}
    ns = sum(r.end_ns - r.start_ns for r in recs if r.id in ids)
    ns -= sum(r.end_ns - r.start_ns for r in recs if r.parent in ids)
    return ns / 1e6


def span_summary() -> dict:
    """The session by span name (calls, total ms, self ms), and its counters."""
    by_name = {}
    for r in _SESSION.spans:
        calls, total = by_name.get(r.name, (0, 0))
        by_name[r.name] = (calls + 1, total + r.end_ns - r.start_ns)
    return {"spans": {n: {"calls": c, "total_ms": t / 1e6, "self_ms": self_ms(n)}
                      for n, (c, t) in sorted(by_name.items())},
            "counters": counters()}


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
    regions never overwrite each other. A region that recorded spans or
    counts (``span``, ``count``) also gets ``<same stem>.spans.json`` beside
    it: ``span_summary()`` of the region's session. A trace is one region
    and is not taken again: where the profiler drops device records (late
    in a long process, PERF.md section 7), the file holds fewer kernels than
    ran; ``device_records`` retries for that reason."""
    logdir = logdir or os.environ.get("AMC_TRACE_DIR")
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))
    prof.start()
    reset()
    try:
        yield
    finally:
        if cuda and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        stem = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}")
        prof.export_chrome_trace(stem + ".pt.trace.json")
        summary = span_summary()
        if summary["spans"] or summary["counters"]:
            with open(stem + ".spans.json", "w") as f:
                json.dump(summary, f, indent=1)


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
