"""The system under test and the closed loop that drives it.

The program is ``modulationdetectioncnn_torch``. From it the benchmark takes
the product's predictor (``dsp/pipeline.py::_make_predictor``, built from
the configuration's and the cell's settings) and, for a stream, the
product's stream call (``classify_stream_blocked``). It hands them only the
generated inputs. Around those calls it records its own spans: the time
from the stream call to the predictor's start (the front end), the
predictor's call (the classifier), and the rest until the labels are on
the host; under the profiler they are ``record_function`` ranges.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

SPAN_FRONTEND = "amc_bench.frontend"
SPAN_CLASSIFIER = "amc_bench.classifier"
SPAN_LABELS = "amc_bench.labels"
SPAN_WINDOW = "amc_bench.window"


def program_config(cell, device: str):
    from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides

    from amc_bench.spec import ROOT

    return apply_overrides(AmcConfig(), [f"device={device}"]
                           + [o.format(root=ROOT) for o in cell.overrides()])


@dataclass
class Tally:
    """What one window did: per item handed over, its pool index, its
    labels on the host and its latency; the front end's host time; the
    frames the classifier took; the program's frames kept for the check."""
    pool_index: list = field(default_factory=list)
    labels: list = field(default_factory=list)
    latency_s: list = field(default_factory=list)
    in_window: list = field(default_factory=list)
    failed: int = 0
    errors: list = field(default_factory=list)
    frontend_host_s: float = 0.0
    frames_classified: int = 0
    kept: dict = field(default_factory=dict)

    @property
    def attempted(self) -> int:
        return len(self.pool_index) + self.failed


class System:
    """The program's entry for one cell: ``call(item)`` returns the labels
    of one capture (stream) or one batch (frames) on the device."""

    def __init__(self, cell, device: str):
        from modulationdetectioncnn_torch.dsp import pipeline

        self.cfg = program_config(cell, device)
        self.kind = cell.traffic["kind"]
        self.predict = pipeline._make_predictor(self.cfg)
        self.stream_entry = pipeline.classify_stream_blocked
        self.tally = Tally()
        self.tracing = False
        self._keep_as = None
        self._call_start = 0.0
        self._span = None

    def _classify(self, x: torch.Tensor) -> torch.Tensor:
        t = time.perf_counter()
        self.tally.frontend_host_s += t - self._call_start
        self.tally.frames_classified += x.shape[0]
        if self._keep_as is not None:
            self.tally.kept[self._keep_as] = x.clone()
        self._end_frontend_span()
        with self._range(SPAN_CLASSIFIER):
            return self.predict(x)

    def _end_frontend_span(self) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None

    def _range(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def call(self, x: torch.Tensor, keep_as=None) -> torch.Tensor:
        """One capture or batch through the program; ``keep_as`` keeps a
        copy of the frames the classifier is handed, under that key."""
        self._keep_as = keep_as
        self._call_start = time.perf_counter()
        if self.kind == "frames":
            return self._classify(x)
        self._span = self._range(SPAN_FRONTEND)
        self._span.__enter__()
        try:
            return self.stream_entry(x, self._classify, self.cfg.stream)
        finally:
            self._end_frontend_span()

    def warm_up(self, items: list, times: int = 2) -> None:
        """Run the cell's one input shape ``times`` over, then wait."""
        for _ in range(times):
            self.call(items[0]).cpu()
        self.tally = Tally()

    def window(self, items: list, seconds: float, keep_first: bool = True,
               calls: int | None = None) -> tuple[float, float]:
        """The closed loop: hand over item i % len(items), wait for its
        labels on the host, hand over the next, until ``seconds`` have
        passed or, with ``calls``, that many items have been handed over.
        The first time each pool item comes, the frames the classifier is
        handed are kept. Returns the window's start and end on the host
        clock."""
        tally = self.tally
        seen = set()
        with self._range(SPAN_WINDOW):
            start = time.perf_counter()
            end = start + seconds
            i = 0
            while True:
                t0 = time.perf_counter()
                if t0 >= end or i == calls:
                    break
                j = i % len(items)
                i += 1
                keep = j if (keep_first and j not in seen) else None
                try:
                    out = self.call(items[j], keep_as=keep)
                    with self._range(SPAN_LABELS):
                        labels = out.cpu().numpy()
                except Exception as exc:   # a failed call counts and adds nothing to the rate
                    tally.failed += 1
                    tally.errors.append(repr(exc)[:300])
                    if tally.failed >= 3:
                        break
                    continue
                t1 = time.perf_counter()
                seen.add(j)
                tally.pool_index.append(j)
                tally.labels.append(labels)
                tally.latency_s.append(t1 - t0)
                tally.in_window.append(t1 <= end)
        return start, end
