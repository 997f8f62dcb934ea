"""One run of one cell: ``python3 -m amc_bench --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.

Set-up (``setup_s``, from the harness's first statement to the first timed
call): the program's predictor from the committed weights (and, in a new
checkout, the build of its kernel library into the program's own
``_build/``), the traffic pool on the card from the seed, and two calls on
the cell's one input shape. Then the closed-loop window (``system.py``),
under ``torch.profiler`` with ``--trace 1``. Then, with the peak memory
read and the program freed, the check against the plain reference
(``check.py``). The last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

from amc_bench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "modulationdetectioncnn_tpu")


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e30


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                               "-i", "0"], capture_output=True, text=True, timeout=30,
                              check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Context:
    """What the metric readers (``metrics/<name>.py``) read."""

    def __init__(self, cell, tally, seconds, setup_s, summary=None):
        from amc_bench import counts

        self.cell = cell
        self.counts = counts
        self.seconds = seconds
        self.setup_s = setup_s
        self.summary = summary
        done = [i for i, w in enumerate(tally.in_window) if w]
        self.latencies_s = [tally.latency_s[i] for i in done]
        self.items = len(tally.labels)
        self.frames_classified = tally.frames_classified
        self.frontend_host_s = tally.frontend_host_s
        self.samples_in_window = sum(tally.labels[i].size for i in done) * cell.config["frame_len"]
        if cell.traffic["kind"] == "stream":
            self.samples_in_window = len(done) * cell.traffic["capture_samples"]


@torch.no_grad()
def run(cell, seed: int, seconds: float, trace: bool, device: str, t0: float,
        system_factory=None, calls: int | None = None) -> dict:
    """One run, without autograd (the caller's grad mode is restored after);
    returns the result line as a dict (``checks`` last).
    ``system_factory(cell, device)`` builds the system under test
    (default ``System``); ``calls`` ends the window after that many calls
    if ``seconds`` have not passed before (``System.window``)."""
    from amc_bench import check, gen
    from amc_bench.system import SPAN_CLASSIFIER, SPAN_FRONTEND, SPAN_LABELS, SPAN_WINDOW, System

    system = (system_factory or System)(cell, device)
    items = gen.make(cell.traffic, seed, device)
    system.warm_up(items)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    summary = None
    system.tracing = trace
    keep = cell.traffic["kind"] == "stream"
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from amc_bench import trace as trace_mod

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        with profile(activities=acts) as prof:
            system.window(items, seconds, keep_first=keep, calls=calls)
            if device == "cuda":
                torch.cuda.synchronize()
        path = os.path.join(tempfile.gettempdir(),
                            f"amc_bench_{cell.name}_{os.getpid()}.trace.json")
        prof.export_chrome_trace(path)
        del prof
        try:
            summary = trace_mod.summarize(path, SPAN_WINDOW,
                                          (SPAN_FRONTEND, SPAN_CLASSIFIER, SPAN_LABELS))
        finally:
            os.remove(path)
    else:
        system.window(items, seconds, keep_first=keep, calls=calls)
    tally, sc = system.tally, system.cfg.stream
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                "count": cell.chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
                if device == "cuda" else 0}
    del system
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = check.numbers(cell, sc, items, tally, device)
    check_s = time.perf_counter() - t_check
    correct, checks = check.verdict(values, cell.settings["limits"], tally)
    ctx = Context(cell, tally, seconds, setup_s, summary)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": correct, "attempted": tally.attempted, "failed": tally.failed,
            "metrics": metrics, "device": dev_info}
    if device == "cuda":
        dev_info["power_limit"] = power_limit()
    if summary is not None:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.gaps}
    line["check_s"] = check_s
    if tally.errors:
        line["errors"] = tally.errors[:3]
    line["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    return line


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m amc_bench", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = _args(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"amc_bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    found = forbidden_modules()
    if found:
        print(f"amc_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"amc_bench: {cell.name} seed {args.seed} on {line['device']['kind']} "
          f"({line['device'].get('power_limit')})", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
