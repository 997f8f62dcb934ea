"""The program's spans and counters (``utils/profiler.py``: ``span``,
``count``, ``spans``, ``counters``, ``self_ms``) on the CPU.

- Without a profiler a stream call records nothing, reads no clock, opens no
  profiler range, and its labels and frames are bitwise those of the same
  call with the spans and the constant-copy helper replaced by plain code.
- Under ``torch.profiler`` each stream call is one ``amc.stream`` root whose
  stage spans share its request id and name it as parent; ``self_ms`` is a
  span's duration less its children's; the in-memory spans fall within
  0.1 ms of the exported trace's ``amc.*`` ranges; a session restarts after
  an unprofiled call.
- The benchmark's readers of them report in exactly their cells, and
  ``frontend_syncs.stream`` reads 0 on the CPU (no card, no copy).
- ``stream`` under ``AMC_TRACE_DIR`` writes the trace and its span summary.
"""
import contextlib
import gc
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from modulationdetectioncnn_torch import cli
from modulationdetectioncnn_torch.config import AmcConfig, StreamConfig
from modulationdetectioncnn_torch.dsp import channelizer, fir, normalize
from modulationdetectioncnn_torch.dsp import pipeline as tpipe
from modulationdetectioncnn_torch.utils import profiler

# Timing correction and the resampler on, so that every constant-copy site
# runs: the DFT (2), the filter bank (1), the CFO's DFT (2), the timing bank
# (1) and the resampler's window matrix (1).
SC = StreamConfig(num_subbands=8, taps_per_branch=8, block_len=8 * 128 * 3,
                  normalize_timing=True, resample_up=2, resample_down=3)
STAGES = ("amc.frontend.channelize", "amc.frontend.cfo", "amc.frontend.timing")


@pytest.fixture(scope="module")
def stream():
    """(x, call): a short wideband stream and a function that classifies it
    with the product's predictor, returning (labels, frames handed to it)."""
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.standard_normal((2, SC.block_len * 2 + 700)).astype(np.float32))
    predict = tpipe._make_predictor(AmcConfig(device="cpu"))

    def call():
        seen = []

        def keep(fr):
            seen.append(fr.clone())
            return predict(fr)

        return tpipe.classify_stream_blocked(x, keep, SC), seen[0]

    return call


def _dur(r):
    return r.end_ns - r.start_ns


def _profiled(fn, times=1):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = [fn() for _ in range(times)]
    return prof, out


def test_no_profiler_records_nothing_and_changes_nothing(stream, monkeypatch):
    profiler.reset()
    with monkeypatch.context() as m:
        def forbidden(*a, **k):
            raise AssertionError("an unprofiled span read the clock or opened a range")

        m.setattr(profiler.time, "time_ns", forbidden)
        m.setattr(torch.profiler, "record_function", forbidden)
        labels, frames = stream()
    assert profiler.spans() == [] and profiler.counters() == {}
    # The same call with plain code in place of the spans and of the helper.
    with monkeypatch.context() as m:
        def copy(a, device):
            return torch.from_numpy(np.array(a)).to(device)

        for mod in (channelizer, normalize, fir):
            m.setattr(mod, "host_constant", copy)
        m.setattr(tpipe, "span", lambda name: contextlib.nullcontext())
        want_labels, want_frames = stream()
    assert torch.equal(labels, want_labels) and torch.equal(frames, want_frames)
    _, [(traced_labels, traced_frames)] = _profiled(stream)
    assert torch.equal(traced_labels, want_labels) and torch.equal(traced_frames, want_frames)


def test_each_call_is_one_root_with_its_stages_beneath(stream):
    stream()                       # unprofiled: the next profiled span starts a session
    _profiled(stream, times=2)
    recs = profiler.spans()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["amc.stream", "amc.stream"]
    root_ids = {r.id for r in roots}
    assert all(r.request in root_ids for r in recs)
    for r in recs:
        if r.name in STAGES + ("amc.classifier.predict",):
            assert r.parent == r.request, r
        if r.parent is not None:
            outer = by_id[r.parent]
            assert outer.request == r.request
            assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
    per_root = {name: [sum(r.name == name and r.request == i for r in recs) for i in root_ids]
                for name in STAGES + ("amc.classifier.predict",)}
    assert all(v == [1, 1] for v in per_root.values()), per_root
    syncs = [r for r in recs if r.name == "amc.frontend.sync"]
    assert len(syncs) == 2 * 7
    assert sorted({by_id[r.parent].name for r in syncs}) == sorted(STAGES + ("amc.stream",))
    assert profiler.counters() == {}            # no copy to a card on the CPU
    for name in ("amc.stream",) + STAGES:
        want = sum(_dur(r) - sum(_dur(c) for c in recs if c.parent == r.id)
                   for r in recs if r.name == name) / 1e6
        assert profiler.self_ms(name) == pytest.approx(want, rel=1e-12)
        assert 0 < profiler.self_ms(name) < sum(_dur(r) for r in recs if r.name == name) / 1e6


def test_spans_fall_on_the_trace_clock(stream, tmp_path):
    _profiled(stream)              # the process's first ranges cost more to open
    profiler.reset()
    # A collection pause while a range opens moves a start by up to half the
    # pause (tens of ms in a full test process), and so can the first range
    # of a profiler session (its set-up, ~8 ms at times): the clock is what
    # is tested, so neither falls on a compared span.
    gc.disable()
    try:
        def call():
            with torch.profiler.record_function("session set-up"):
                pass
            return stream()

        prof, _ = _profiled(call)
    finally:
        gc.enable()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        doc = json.load(f)
    base = doc["baseTimeNanoseconds"]
    ranges = sorted((e["ts"] * 1e3 + base, (e["ts"] + e["dur"]) * 1e3 + base, e["name"])
                    for e in doc["traceEvents"]
                    if e.get("cat") == "user_annotation" and e["name"].startswith("amc."))
    recs = sorted((r.start_ns, r.end_ns, r.name) for r in profiler.spans())
    assert [r[2] for r in ranges] == [r[2] for r in recs] and len(recs) > 10
    for (s, e, name), (rs, re_, _) in zip(recs, ranges):
        assert abs(s - rs) <= 1e5 and abs(e - re_) <= 1e5, (name, s - rs, e - re_)


def test_a_session_restarts_after_an_unprofiled_call(stream):
    stream()
    _profiled(stream)
    first = profiler.spans()
    stream()
    assert profiler.spans() == first           # read after the region, until the next
    _profiled(stream, times=2)
    second = profiler.spans()
    assert sum(r.name == "amc.stream" for r in first) == 1
    assert sum(r.name == "amc.stream" for r in second) == 2
    assert not {r.id for r in first} & {r.id for r in second}


def test_predictor_alone_is_a_root():
    predict = tpipe._make_predictor(AmcConfig(device="cpu"))
    x = torch.zeros((4, 2, 128))
    profiler.reset()
    _profiled(lambda: predict(x), times=3)
    recs = profiler.spans()
    assert [(r.name, r.parent) for r in recs] == [("amc.classifier.predict", None)] * 3
    assert len({r.request for r in recs}) == 3


def test_bench_readers_report_in_exactly_their_cells():
    import time

    from amc_bench import run, spec
    from amc_bench.tests.conftest import small_cell

    new = {m["name"]: m["workloads"] for m in spec.benchmark()["per_layer"]
           if m["source"] in ("program_span", "program_counter")
           and m["name"] != "frontend_host_ms.stream"}
    assert len(new) == 8
    for cell in ("int8_stream", "bf16_stream_timing", "int8_frames", "bf16_frames"):
        line = run.run(small_cell(cell), 3000000123, 0.2, True, "cpu", time.perf_counter())
        assert line["correct"], line
        for name, cells in new.items():
            value = spec.reader(name)(None)     # the window's session, still current
            assert (value is not None) == (cell in cells), (cell, name, value)
            assert (name in line["metrics"]) == (cell in cells), (cell, name)
        if "stream" in cell:
            assert line["metrics"]["frontend_syncs.stream"]["value"] == 0
            for name in ("channelize_host_ms.stream", "cfo_host_ms.stream",
                         "frontend_wait_ms.stream"):
                assert line["metrics"][name]["value"] > 0


def test_stream_command_writes_trace_and_span_summary(tmp_path, monkeypatch):
    monkeypatch.setenv("AMC_TRACE_DIR", str(tmp_path))
    assert cli.main(["stream", "device=cpu"]) == 0
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2 and files[0].endswith(".pt.trace.json"), files
    stem = files[0][:-len(".pt.trace.json")]
    assert files[1] == stem + ".spans.json"
    with open(tmp_path / files[0]) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"amc.stream", "amc.frontend.channelize", "amc.frontend.cfo",
            "amc.frontend.sync", "amc.classifier.predict"} <= names
    with open(tmp_path / files[1]) as f:
        summary = json.load(f)
    assert summary["counters"] == {}
    s = summary["spans"]["amc.stream"]
    assert s["calls"] == 1 and 0 < s["self_ms"] < s["total_ms"]
    assert summary["spans"]["amc.classifier.predict"]["calls"] == 1
