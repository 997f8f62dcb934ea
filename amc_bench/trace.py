"""Reduction of a ``torch.profiler`` Chrome trace to what the readers need.

The traced run writes one trace of its whole window under ``$TMPDIR`` and
reads it back here. Device work is every kernel, copy and set on the card
(``kernel``, ``gpu_memcpy``, ``gpu_memset``). Each is attributed to the
benchmark span (``system.py``) in which the host launched it, found by its
correlation id; busy time is the union of their intervals inside the
window, and the idle gaps are what the window leaves between them.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function")
NAME_CHARS = 120


@dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    span: str            # the benchmark span the host launched it in, or ""


@dataclass
class Summary:
    window_s: float
    busy_s: float
    ops: list = field(default_factory=list)         # DeviceOp inside the window
    gaps: list = field(default_factory=list)        # [name, seconds], longest first

    def device_s(self, span: str | None = None, name_has: str | None = None) -> tuple[float, int]:
        """(seconds, count) of the device ops launched in ``span`` and/or
        whose name contains ``name_has``."""
        sel = [o for o in self.ops if (span is None or o.span == span)
               and (name_has is None or name_has in o.name)]
        return sum(o.dur_us for o in sel) * 1e-6, len(sel)

    def top_ops(self, n: int = 10) -> list:
        tot = defaultdict(float)
        for o in self.ops:
            tot[o.name[:NAME_CHARS]] += o.dur_us * 1e-6
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]


def _span_at(spans: list, starts: list, t: float) -> str:
    """The name of the span (start, end, name) holding ``t``; the spans do
    not overlap and are sorted by start, ``starts`` their starts."""
    i = bisect.bisect_right(starts, t) - 1
    return spans[i][2] if i >= 0 and spans[i][1] >= t else ""


def _innermost(intervals: list, starts: list, t: float) -> str:
    """The name of the shortest interval (start, end, name) holding ``t``;
    ``intervals`` sorted by start, ``starts`` their starts."""
    best, best_len = "", float("inf")
    for s, e, name in intervals[:bisect.bisect_right(starts, t)]:
        if s <= t <= e and e - s < best_len:
            best, best_len = name, e - s
    return best


def summarize(path: str, window_span: str, spans: tuple[str, ...]) -> Summary:
    """Read the trace at ``path``: the window is the ``window_span``
    annotation; device ops are attributed to the one of ``spans`` (which
    follow each other and never nest) their launch fell in."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ann = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("cat") == "user_annotation" and e["name"] in spans + (window_span,)]
    win = [a for a in ann if a[2] == window_span]
    if not win:
        raise RuntimeError(f"the trace holds no {window_span!r} range")
    w0, w1, _ = win[0]
    ann = sorted(a for a in ann if a[2] in spans)
    ann_starts = [a[0] for a in ann]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, d = e["ts"], e.get("dur", 0.0)
        if s + d < w0 or s > w1:
            continue
        t_launch = launch.get(e.get("args", {}).get("correlation"))
        span = "" if t_launch is None else _span_at(ann, ann_starts, t_launch)
        ops.append(DeviceOp(e["name"], s, d, span))
    # busy: the union of device intervals clipped to the window
    iv = sorted((max(o.start_us, w0), min(o.start_us + o.dur_us, w1)) for o in ops)
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [x for m in merged for x in m] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in HOST_CATS)
    host_starts = [h[0] for h in host]
    named = []
    for length, t in gaps:
        span = _span_at(ann, ann_starts, t) or window_span
        op = _innermost(host, host_starts, t)
        named.append([f"{span}:{op}"[:NAME_CHARS] if op else span, length * 1e-6])
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, ops=ops, gaps=named)
