"""Per-stage breakdown of the int8 classifier on the card.

The port's counterpart of the JAX package's ``scripts/bench_breakdown.py``:
at the bench's B=4096 it times the v7 and v9 classifiers in full (rows 1 +
2 and 4 + 2 of PERF.md's kernel table), the v9 conv stage alone (row 4) and
the dense + argmax stage alone (row 2, on a seeded int8 map), and the glue
residual (the v9 forward less its two stages). Each stage is given as its
share of the v9 forward (of the card's time per call: each round queued
behind a sleep kernel, since the dense stage alone takes less of the
card's time than of the host's) and as useful int8 operations per second
against two yardsticks: the int8 ceiling that the card measures in the same run
(``torch._int_mm`` at 8192^3, a yardstick only, on no product path) and the
published 1,979 TOP/s, beside the card's power limit.

Operations are useful MACs (conv1 126x6x256, conv2 124x1536x80, dense1
9920x256, dense2 256x11 per frame), not the padded MACs of a TPU layout.
Times are CUDA events around runs of back-to-back calls on one stream,
the median of 5 runs, each stage measured in turn within each round.

    python -m modulationdetectioncnn_torch.scripts.bench_breakdown [out.json]

writes ``chiprun_out/bench_breakdown.json`` by default (never into
``artifacts/``, which holds the JAX package's records) and prints the same
JSON. It needs a card: there is no CPU version of a measurement of it.
"""
from __future__ import annotations

import json
import os
import statistics
import sys

import numpy as np
import torch

from modulationdetectioncnn_torch.scripts import refuse_artifacts

BATCH = 4096
T_IN = 128
ROUNDS = 5
ITERS = 20
CEILING_N = 8192
SLEEP_CYCLES = 20_000_000         # ~10 ms of the card's clock, more than a round takes to queue
PUBLISHED_INT8_OPS = 1979e12      # H100 SXM data sheet, dense, at 700 W
BYTES_PER_S = 3.35e12             # H100 SXM HBM3
# Useful multiply-accumulates per frame of the flagship VT-CNN2.
USEFUL_MACS = {"conv1": 126 * 6 * 256, "conv2": 124 * 1536 * 80,
               "dense1": 9920 * 256, "dense2": 256 * 11}
CONV_MACS = USEFUL_MACS["conv1"] + USEFUL_MACS["conv2"]
DENSE_MACS = USEFUL_MACS["dense1"] + USEFUL_MACS["dense2"]
FULL_MACS = CONV_MACS + DENSE_MACS
# Bytes per frame that each stage must move (input read once, output
# written once): f32 (2, 128) frames -> (124, 80) int8 map -> int32 label.
CONV_BYTES = 2 * T_IN * 4 + 124 * 80
DENSE_BYTES = 124 * 80 + 4
FULL_BYTES = 2 * T_IN * 4 + 4


def ceiling_ops(n: int) -> int:
    """Operations of one (n, n) x (n, n) product: 2 n^3."""
    return 2 * n ** 3


def stage_entry(ms: float, macs_per_frame: int, ceiling_ops_per_s: float,
                bytes_per_frame: int, batch: int = BATCH) -> dict:
    """One stage's record: its time, the frames' samples/s, its useful int8
    ops/s against the measured ceiling and the published peak, and its
    bound (the larger of the operations over the published peak and the
    bytes over the memory rate)."""
    sec = ms / 1e3
    ops = 2 * macs_per_frame * batch
    return {"ms": ms, "samples_per_sec": batch * T_IN / sec,
            "useful_ops_per_s": ops / sec,
            "pct_of_measured_int8_ceiling": 100 * ops / sec / ceiling_ops_per_s,
            "pct_of_published_int8_peak": 100 * ops / sec / PUBLISHED_INT8_OPS,
            "bound_ms": 1e3 * max(ops / PUBLISHED_INT8_OPS,
                                  bytes_per_frame * batch / BYTES_PER_S)}


def stage_shares(full_ms: float, conv_ms: float, dense_ms: float) -> dict:
    """Each stage's share of the full forward; the glue is what the full
    forward takes beyond its two stages, at least 0."""
    glue = max(full_ms - conv_ms - dense_ms, 0.0)
    return {"conv": conv_ms / full_ms, "dense": dense_ms / full_ms,
            "glue": glue / full_ms}


def run() -> dict:
    """Measure every stage on the card and return the breakdown."""
    from modulationdetectioncnn_torch import bench
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.device import describe, resolve_device
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    dev = resolve_device("cuda")
    cfg = AmcConfig()
    qw, x = bench.make_int8_weights(cfg, BATCH)      # the bench's PTQ weights
    rng = np.random.default_rng(1)
    h0 = torch.from_numpy(rng.integers(0, 80, (BATCH, 124 * 80)).astype(np.int8)).to(dev)
    a = torch.from_numpy(rng.integers(-100, 100, (CEILING_N, CEILING_N)).astype(np.int8)).to(dev)
    b_cm = torch.from_numpy(rng.integers(-100, 100, (CEILING_N, CEILING_N)).astype(np.int8)
                            ).to(dev).t()            # column-major, as cuBLASLt takes it
    v7 = infer.make_int8_predict(qw, "v7")
    v9 = infer.make_int8_predict(qw, "v9")
    calls = {
        "int8_ceiling": lambda: torch._int_mm(a, b_cm),
        "v7_full": lambda: v7(x),
        "v9_full": lambda: v9(x),
        "conv_stage_v9": lambda: infer.conv_stage_int8_v9(x, qw),
        "dense_argmax_stage": lambda: infer.dense_argmax_int8(h0, qw),
    }
    samples: dict[str, list[float]] = {k: [] for k in calls}
    for _ in range(ROUNDS):
        for name, fn in calls.items():
            samples[name] += launch_ms_samples(fn, iters=ITERS, reps=1)
    ms = {k: statistics.median(v) for k, v in samples.items()}
    ceiling = ceiling_ops(CEILING_N) / (ms["int8_ceiling"] / 1e3)
    # A stage called on its own is timed at the host's pace once the host
    # takes longer to launch it than the card to run it (the dense stage);
    # in the forward the card hides that. So the shares are of the card's
    # time per call: a round's calls are queued behind a sleep kernel, and
    # the card then runs them back to back between the events.
    def card_ms(fn) -> float:
        runs = []
        for _ in range(ROUNDS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            for _ in range(ITERS):
                fn()
            stop.record()
            stop.synchronize()
            runs.append(start.elapsed_time(stop) / ITERS)
        return statistics.median(runs)

    dev_ms = {k: card_ms(calls[k]) for k in ("v9_full", "conv_stage_v9", "dense_argmax_stage")}
    shares = stage_shares(dev_ms["v9_full"], dev_ms["conv_stage_v9"],
                          dev_ms["dense_argmax_stage"])
    stages = {
        "v7_full": stage_entry(ms["v7_full"], FULL_MACS, ceiling, FULL_BYTES),
        "v9_full": stage_entry(ms["v9_full"], FULL_MACS, ceiling, FULL_BYTES),
        "conv_stage_v9": stage_entry(ms["conv_stage_v9"], CONV_MACS, ceiling, CONV_BYTES),
        "dense_argmax_stage": stage_entry(ms["dense_argmax_stage"], DENSE_MACS, ceiling,
                                          DENSE_BYTES),
        "glue_residual": {"device_ms": shares["glue"] * dev_ms["v9_full"]},
    }
    for k, v in dev_ms.items():
        stages[k]["device_ms"] = v
    return {
        "device": describe(dev),
        "batch": BATCH,
        "timing": f"CUDA events around {ITERS} back-to-back calls, median of "
                  f"{ROUNDS} rounds, stages in turn; device_ms the same with each "
                  "round queued behind a sleep kernel (the card's time per call), "
                  "which the shares are of",
        "measured_int8_ceiling": {"call": f"torch._int_mm, {CEILING_N}^3",
                                  "ms": ms["int8_ceiling"], "ops_per_s": ceiling},
        "published_int8_ops_per_s": PUBLISHED_INT8_OPS,
        "useful_macs_per_frame": dict(USEFUL_MACS, total=FULL_MACS),
        "stages": stages,
        "stage_shares_of_v9_full": shares,
        "samples_ms": samples,
    }


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_path = argv[0] if argv else os.path.join("chiprun_out", "bench_breakdown.json")
    refuse_artifacts(out_path)
    result = run()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
