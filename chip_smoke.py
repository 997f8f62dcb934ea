#!/usr/bin/env python3
"""Drive the PyTorch port's ``stream`` and ``bench`` paths on one NVIDIA GPU
and check them.

Usage, from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing JSON lines (``"phase": ...``):

1. device  -- the card's name and power limit (nvidia-smi), printed raw too.
2. build   -- compiles ``modulationdetectioncnn_torch/csrc/*.cu`` with nvcc
              for sm_90a (one nvcc per source, in parallel, then one link)
              and loads the library; build seconds and ptxas's report.
3. kernels -- each of the four kernels against its plain PyTorch version on
              the card, for the committed int8 artifact, for seeded
              random weights and for the bench's own PTQ weights, on 8192
              seeded frames, on the stream demo's 1024 frames, at B=1, on
              a ragged 37-frame slice and on the bench's 4096 frames: 0
              mismatching int8 activations over the whole (B, 124, 80)
              map and 0 mismatching labels, and v7, v9 and v10 giving the
              same labels. Times at B=4096 (CUDA events around runs of
              back-to-back launches, median of 5 runs),
              the plain version's, one torch call on the kernel's largest
              product as a yardstick, and the least time the card could
              take (bound).
4. stream  -- ``run_stream_demo`` on cuda with the default StreamConfig and
              the committed artifact, once with the default v7 classifier
              and once with ``eval.int8_kernel=v10``, launch counters zeroed
              just before each: subbands 1/5/11 must read BPSK/QPSK/GFSK,
              streamed labels must equal whole-stream labels, the path's
              kernels must have launched, and the labels must agree with
              the CPU plain path.
5. bench   -- the port's bench (``modulationdetectioncnn_torch.bench``) at
              its defaults: cnn mode at B=4096 with calibration over v7 and
              v10 and the stream_extra line; then stream mode; then the v9
              backend named explicitly. Counters zeroed before each run.
              Its stdout and stderr lines are printed as they came; the
              contract keys, ``fallback`` false, the winner among the
              candidates, every kernel of each run launched, and no
              ``stream_extra_error`` are required.
6. profile -- torch.profiler over 10 iterations of the v10 classifier and
              of the stream chain at B=4096: device time by kernel and the
              device's busy share (reported, not checked).

Then one ``{"kernels": [...]}`` line and, last, the contract line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before the
last line. With no CUDA device, or outside a checkout of the repository, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096          # the bench batch of the JAX package (BenchConfig)
N_CHECK = 8192        # seeded frames held against the plain versions
SEED = 0
# Dense peaks from NVIDIA's data sheets: (int8 ops/s, bytes/s).
PEAKS = {"SXM": (1979e12, 3.35e12), "PCIe": (1513e12, 2.0e12),
         "NVL": (1671e12, 3.9e12)}
TPU_KERNELS = {
    "conv_stage_int8_v7": "modulationdetectioncnn_tpu/ops/infer.py:1676",
    "dense_argmax_int8": "modulationdetectioncnn_tpu/ops/infer.py:631",
    "conv_stage_int8_v10": "modulationdetectioncnn_tpu/ops/infer.py:1247",
    "conv_stage_int8_v9": "modulationdetectioncnn_tpu/ops/infer.py:1103",
}
SOURCES = {
    "conv_stage_int8_v7": "modulationdetectioncnn_torch/csrc/conv_stage_int8.cu",
    "dense_argmax_int8": "modulationdetectioncnn_torch/csrc/dense_argmax_int8.cu",
    "conv_stage_int8_v10": "modulationdetectioncnn_torch/csrc/conv_stage_int8_v10.cu",
    "conv_stage_int8_v9": "modulationdetectioncnn_torch/csrc/conv_stage_int8_v10.cu",
}
CONTRACT_KEYS = {"metric", "value", "unit", "vs_baseline", "backend", "fallback"}


class CheckFailed(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def peaks_for(name: str) -> tuple[str, float, float]:
    part = "PCIe" if "PCIe" in name else "NVL" if "NVL" in name else "SXM"
    return (part, *PEAKS[part])


def time_ms(fn, iters: int, warmup: int = 3, reps: int = 5) -> float:
    """Median over ``reps`` runs of ``iters`` back-to-back launches, each run
    timed with one pair of CUDA events, per launch. Launches queue behind
    each other, so the host's time to issue one is hidden as long as it is
    shorter than the device's time to run one."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times)


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    part, int8_peak, bw_peak = peaks_for(name)
    info = {"phase": "device", "name": name, "nvidia_smi": smi,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "peaks_part": part,
            "int8_ops_per_s": int8_peak, "bytes_per_s": bw_peak}
    emit(info)
    return info


def phase_build() -> None:
    from modulationdetectioncnn_torch.ops import _build

    res = _build.build(force=True)
    _build.load_library()
    usage = [ln.strip() for ln in res["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(res["seconds"], 3),
          "nvcc": _build.find_nvcc(), "library": os.path.relpath(res["path"], REPO),
          "ptxas": usage})


def random_weights(art, rng: np.random.Generator):
    """Full-width int8 weights from a seed, with the artifact's requantize
    constants and each weight tensor's spread, so activations stay live."""
    from modulationdetectioncnn_torch.quant import int8_weights_from_numpy

    tree = art.tree()
    for k in ("w1p", "w2p", "w3", "w4"):
        std = float(tree[k].astype(np.float64).std())
        tree[k] = np.clip(np.rint(rng.normal(0, std, tree[k].shape)),
                          -127, 127).astype(np.int8)
    return int8_weights_from_numpy(tree, "cuda")


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> tuple[int, int]:
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0


def phase_kernels(dev_info: dict, demo_frames: torch.Tensor) -> list[dict]:
    from modulationdetectioncnn_torch import bench
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, QuantizedModel, load_int8

    rng = np.random.default_rng(SEED)
    art_np = QuantizedModel.from_npz(DEFAULT_ARTIFACT)
    # The bench's own PTQ weights and frames, as its int8 backends get them.
    bench_qw, bench_x = bench.make_int8_weights(AmcConfig(), BATCH)
    weights = {"artifact": load_int8(device="cuda"),
               "seeded": random_weights(art_np, rng), "bench_ptq": bench_qw}
    x_seed = torch.from_numpy(
        (0.7 * rng.standard_normal((N_CHECK, 2, 128))).astype(np.float32)).cuda()
    # Ragged batches and a slice that starts inside the tensor too.
    inputs = {"stream_frames": demo_frames, f"seeded_b{N_CHECK}": x_seed,
              "seeded_b1": x_seed[:1], "seeded_b37_at3": x_seed[3:40],
              f"bench_frames_b{BATCH}": bench_x}

    checks, stats = [], {n: {"mismatches": 0, "max_abs_err": 0} for n in TPU_KERNELS}
    for wname, qw in weights.items():
        for xname, x in inputs.items():
            conv_p = infer.conv_stage_int8_v7_plain(x, qw)
            folded_p = infer.conv_stage_int8_folded_plain(x, qw)
            lab_p = infer.dense_argmax_int8_plain(conv_p, qw)
            convs = {"conv_stage_int8_v7": infer.conv_stage_int8_v7(x, qw),
                     "conv_stage_int8_v9": infer.conv_stage_int8_v9(x, qw),
                     "conv_stage_int8_v10": infer.conv_stage_int8_v10(x, qw)}
            labels = {k: infer.dense_argmax_int8(v, qw) for k, v in convs.items()}
            lab_k = infer.dense_argmax_int8(conv_p, qw)
            torch.cuda.synchronize()
            pairs = {"conv_stage_int8_v7": (convs["conv_stage_int8_v7"], conv_p),
                     "conv_stage_int8_v9": (convs["conv_stage_int8_v9"], folded_p),
                     "conv_stage_int8_v10": (convs["conv_stage_int8_v10"], folded_p),
                     "dense_argmax_int8": (lab_k, lab_p)}
            for kname, (got, want) in pairs.items():
                mism, err = compare(kname, got, want)
                stats[kname]["mismatches"] += mism
                stats[kname]["max_abs_err"] = max(stats[kname]["max_abs_err"], err)
                checks.append({"kernel": kname, "weights": wname, "input": xname,
                               "n": int(x.shape[0]), "mismatches": mism})
            # Each classifier's labels (its conv kernel, then the dense
            # kernel) against the plain chain, and v7 == v9 == v10.
            label_mism = {k: compare(k, v, lab_p)[0] for k, v in labels.items()}
            plain_mism = compare("folded_plain", folded_p, conv_p)[0]
            checks.append({"weights": wname, "input": xname,
                           "label_mismatches_vs_plain": label_mism,
                           "folded_plain_vs_integer_plain": plain_mism,
                           "conv_live_fraction": round(float((conv_p > 0).float().mean()), 4),
                           "label_classes": int(torch.unique(lab_p).numel())})
            require(all(m == 0 for m in label_mism.values()) and plain_mism == 0,
                    f"{wname}/{xname}: labels differ {label_mism}, "
                    f"folded plain vs integer plain {plain_mism}")
    for c in checks:
        emit({"phase": "kernels.check", **c})
    for kname, s in stats.items():
        require(s["mismatches"] == 0, f"{kname}: {s['mismatches']} mismatches vs plain")

    # Timing at B=4096 with the artifact's weights.
    qw = weights["artifact"]
    b = BATCH
    x = x_seed[:b]
    a1 = infer.conv1_int8_plain(x, qw)
    a1f = infer.conv1_folded_plain(x, qw).reshape(-1, 512)      # (B*126, 512)
    conv = infer.conv_stage_int8_v7_plain(x, qw)
    im2col = torch.cat([a1[:, k:k + 124] for k in range(3)], dim=-1).reshape(-1, 1536)
    w2l_cm = qw.w2l.t().contiguous().t()                        # column-major
    h = conv.reshape(b, -1)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # v7, v9 and v10 compute one function (the same map from the same
    # model), so they share one bound: the function's int8 operations (conv1
    # 126*512*3 and conv2 124*80*1536 MACs per frame, not the folded
    # form's padded lanes) and its bytes (frames in, map out, v7's weights).
    conv_work = (2 * b * (126 * 512 * 3 + 124 * 80 * 1536),
                 b * 2 * 128 * 4 + b * 124 * 80
                 + nbytes(qw.w1, qw.m1, qw.o1, qw.w2t, qw.m2, qw.o2))
    work = {  # name: (int8 ops, bytes)
        "conv_stage_int8_v7": conv_work, "conv_stage_int8_v9": conv_work,
        "conv_stage_int8_v10": conv_work,
        "dense_argmax_int8": (2 * b * (9920 * 256 + 256 * 11),
                              b * 9920 + b * 4 + nbytes(qw.w3t, qw.m3, qw.o3, qw.w4,
                                                        qw.s4, qw.b4)),
    }
    int8_peak, bw_peak = dev_info["int8_ops_per_s"], dev_info["bytes_per_s"]

    def bound(int8_ops, nb):
        t_ops = int8_ops / int8_peak * 1e3
        t_bytes = nb / bw_peak * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    plans = (
        ("conv_stage_int8_v7", infer.conv_stage_int8_v7, infer.conv_stage_int8_v7_plain,
         lambda: torch._int_mm(im2col, qw.w2t.T), "torch._int_mm, conv2 im2col "
         "(B*124, 1536) x (1536, 80)", x),
        ("dense_argmax_int8", infer.dense_argmax_int8, infer.dense_argmax_int8_plain,
         lambda: torch._int_mm(h, qw.w3t.T), "torch._int_mm, dense1 (B, 9920) x "
         "(9920, 256)", h),
        ("conv_stage_int8_v10", infer.conv_stage_int8_v10,
         infer.conv_stage_int8_folded_plain, lambda: torch._int_mm(a1f, w2l_cm),
         "torch._int_mm, conv2 lane-packed (B*126, 512) x (512, 240)", x),
        ("conv_stage_int8_v9", infer.conv_stage_int8_v9,
         infer.conv_stage_int8_folded_plain, lambda: torch._int_mm(a1f, w2l_cm),
         "torch._int_mm, conv2 lane-packed (B*126, 512) x (512, 240)", x),
    )
    rows = []
    for kname, kernel, plain, lib, lib_what, arg in plans:
        ms = time_ms(lambda: kernel(arg, qw), iters=20)
        plain_ms = time_ms(lambda: plain(arg, qw), iters=2, warmup=1, reps=3)
        library_ms = time_ms(lib, iters=20)
        int8_ops, nb = work[kname]
        bms, by = bound(int8_ops, nb)
        rows.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                     "replaces": TPU_KERNELS[kname], "launches": None,
                     "max_abs_err": stats[kname]["max_abs_err"],
                     "mismatches": stats[kname]["mismatches"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": library_ms,
                     "library_call": lib_what, "batch": b,
                     "int8_ops": int8_ops, "bytes": nb})
    emit({"phase": "kernels", "timed": rows})
    return rows


def phase_stream(kernel: str) -> dict[str, int]:
    """The stream demo on cuda through the ``kernel`` classifier; returns
    the launch counts of that run."""
    import dataclasses
    from collections import Counter

    from modulationdetectioncnn_torch.config import AmcConfig, RML_CLASSES
    from modulationdetectioncnn_torch.dsp import framer, pipeline
    from modulationdetectioncnn_torch.ops import infer

    base = AmcConfig()                     # default StreamConfig, device=cuda
    cfg = dataclasses.replace(base, eval=dataclasses.replace(base.eval,
                                                             int8_kernel=kernel))
    infer.reset_launch_counts()
    t0 = time.perf_counter()
    labels = pipeline.run_stream_demo(cfg)
    wall = time.perf_counter() - t0
    launches = infer.launch_counts()

    wide, occupied = pipeline.make_demo_signal(cfg)
    predict = pipeline._make_predictor(cfg)
    batch = pipeline.classify_stream(framer.to_planes(wide, "cuda"), predict,
                                     cfg.stream).cpu().numpy()
    cpu_cfg = dataclasses.replace(cfg, device="cpu")
    cpu = pipeline.classify_stream_blocked(
        framer.to_planes(wide, "cpu"), pipeline._make_predictor(cpu_cfg),
        cpu_cfg.stream).numpy()
    tops = {k: RML_CLASSES[Counter(labels[k].tolist()).most_common(1)[0][0]]
            for k in occupied}
    occ = sorted(occupied)
    agree_cpu = float((cpu == labels).mean())
    emit({"phase": "stream", "int8_kernel": kernel, "frames": int(labels.size),
          "shape": list(labels.shape), "wall_s": wall, "tops": tops,
          "launches": launches,
          "streamed_equals_batch": bool(np.array_equal(labels, batch[:, :labels.shape[1]])),
          "agreement_with_cpu_plain": agree_cpu,
          "occupied_equal_cpu_plain": bool(np.array_equal(labels[occ], cpu[occ]))})
    require(tops == occupied, f"occupied subbands read {tops}, want {occupied}")
    require(labels.shape[1] == batch.shape[1]
            and np.array_equal(labels, batch), "streamed labels != whole-stream labels")
    path = (f"conv_stage_int8_{kernel}", "dense_argmax_int8")
    require(all(launches[k] > 0 for k in path), f"kernel not launched: {launches}")
    # CPU and GPU DSP floats differ in the last bits (matmul order), which
    # can flip CFO's argmax on noise-only frames: >= 99 % overall, exact on
    # the occupied subbands.
    require(np.array_equal(labels[occ], cpu[occ]), "occupied subbands differ from CPU")
    require(agree_cpu >= 0.99, f"agreement with CPU plain path {agree_cpu}")
    return launches


def run_bench(name: str, argv: list[str], path: tuple[str, ...]) -> tuple[dict, list, dict]:
    """One run of the port's bench (``bench.main(argv)``) with the counters
    zeroed just before it. Prints its stdout and stderr lines, each on a
    line of its own, and requires every kernel of ``path`` launched.
    Returns the contract line, the stderr JSON lines and the counts."""
    from modulationdetectioncnn_torch import bench
    from modulationdetectioncnn_torch.ops import infer

    out, err = io.StringIO(), io.StringIO()
    infer.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(argv)
    wall = time.perf_counter() - t0
    launches = infer.launch_counts()
    out_lines = out.getvalue().strip().splitlines()
    err_lines = err.getvalue().strip().splitlines()
    for line in out_lines + err_lines:
        print(line, flush=True)
    emit({"phase": "bench", "run": name, "argv": argv, "rc": rc, "wall_s": wall,
          "launches": launches})
    require(rc == 0 and out_lines, f"bench {name}: rc {rc}, no stdout")
    result = json.loads(out_lines[-1])
    extra = [json.loads(ln) for ln in err_lines if ln.startswith("{")]
    require(set(result) == CONTRACT_KEYS, f"bench {name}: keys {sorted(result)}")
    require(result["fallback"] is False and result["value"] > 0,
            f"bench {name}: {result}")
    require(not any("stream_extra_error" in e for e in extra),
            f"bench {name}: stream_extra failed: {err.getvalue()[-2000:]}")
    require(all(launches[k] > 0 for k in path),
            f"bench {name}: kernel not launched: {launches}")
    return result, extra, launches


def phase_bench() -> dict[str, int]:
    """The bench path: cnn mode at the defaults, stream mode, and v9 named
    explicitly. Returns the v9 and v10 launch counts on it."""
    from modulationdetectioncnn_torch.config import BenchConfig

    cands = BenchConfig().calibration_candidates
    res, extra, cnn = run_bench(
        "cnn", [], ("conv_stage_int8_v7", "conv_stage_int8_v10", "dense_argmax_int8"))
    cal = [e for e in extra if "kernel_calibration" in e]
    require(res["metric"] == "classified_iq_samples_per_sec_per_chip"
            and res["backend"] in cands, f"bench cnn: {res}")
    require(len(cal) == 1 and set(cal[0]["kernel_calibration"]) == set(cands)
            and cal[0]["winner"] == res["backend"], f"bench cnn calibration: {cal}")
    require(any(e.get("mode") == "stream_extra" and e.get("value", 0) > 0
                for e in extra), "bench cnn: no stream_extra line")
    res, _, _ = run_bench("stream", ["stream"],
                          ("conv_stage_int8_v7", "dense_argmax_int8"))
    require(res["metric"] == "streamed_iq_samples_per_sec_per_chip",
            f"bench stream: {res}")
    res, _, v9 = run_bench("v9", ["pallas_int8_v9", "bench.stream_extra=false"],
                           ("conv_stage_int8_v9", "dense_argmax_int8"))
    require(res["backend"] == "pallas_int8_v9", f"bench v9: {res}")
    return {"conv_stage_int8_v10": cnn["conv_stage_int8_v10"],
            "conv_stage_int8_v9": v9["conv_stage_int8_v9"]}


def phase_profile() -> None:
    """Where the time goes at B=4096: ``torch.profiler`` over 10 chained
    iterations of the v10 classifier alone and of the bench's stream chain
    (front end + v10 classifier). Prints the device time by kernel (top 8)
    and the device's busy share of the profiled window. A measurement, not
    a check: a profiler that sees no device time is reported as such."""
    from torch.profiler import ProfilerActivity, profile

    from modulationdetectioncnn_torch import bench
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.dsp import pipeline
    from modulationdetectioncnn_torch.dsp.channelizer import design_prototype

    cfg = AmcConfig()
    sc = cfg.stream
    classify, (frames,) = bench.make_classifier(cfg, "pallas_int8_v10", BATCH)
    h = design_prototype(sc.num_subbands, sc.taps_per_branch)
    wide = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (2, BATCH * sc.frame_len)).astype(np.float32)).cuda()

    def chained(fn):
        def step(xc):
            return xc + fn(xc).reshape(-1)[0].to(torch.float32) * 1e-38
        return step

    def stream_labels(xc):
        fr = pipeline.subband_frames(xc, h, sc)
        return classify(fr.reshape(-1, 2, sc.frame_len))

    for name, step, x in (("classifier_v10", chained(classify), frames),
                          ("stream_chain_v10", chained(stream_labels), wide)):
        with torch.no_grad():
            for _ in range(3):
                x = step(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(10):
                    x = step(x)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
        emit({"phase": "profile", "window": name, "iterations": 10,
              "wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "device_busy_share": busy_ms / wall_ms if ev else "not visible",
              "top_device_ms": {e.key[:80]: e.self_device_time_total / 1e3
                                for e in top}})


def demo_frames() -> torch.Tensor:
    """The frames the stream path hands the classifier (1024 on cuda)."""
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.dsp import framer, pipeline
    from modulationdetectioncnn_torch.dsp.channelizer import design_prototype

    cfg = AmcConfig()
    sc = cfg.stream
    wide, _ = pipeline.make_demo_signal(cfg)
    plan = pipeline.plan_frontend(sc)
    blocks = framer.overlap_save_blocks(framer.to_planes(wide, "cuda"),
                                        sc.block_len, plan.halo_in).transpose(0, 1)
    fr = pipeline.block_frontend(
        blocks, design_prototype(sc.num_subbands, sc.taps_per_branch), sc, plan)
    return fr.reshape(-1, 2, sc.frame_len).contiguous()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU machine",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "modulationdetectioncnn_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # The plain folded conv1 is a float32 product that must be exact: keep
    # TF32 off for matmuls (PyTorch's default, stated here).
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        dev = phase_device()
        phase_build()
        rows = phase_kernels(dev, demo_frames())
        launches = phase_stream("v7")           # the stream path: v7 + dense
        phase_stream("v10")
        launches.update(phase_bench())          # the bench path: v9, v10
        phase_profile()
        for row in rows:
            row["launches"] = launches[row["name"]]
    except CheckFailed as e:
        emit({"ok": False, "failed": str(e)})
        return 1
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
