#!/usr/bin/env python3
"""Drive the PyTorch port's ``stream`` path on one NVIDIA GPU and check it.

Usage, from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing one JSON line (``"phase": ...``):

1. device  -- the card's name and power limit (nvidia-smi), printed raw too.
2. build   -- compiles ``modulationdetectioncnn_torch/csrc/*.cu`` with nvcc
              for sm_90a and loads the library; build seconds.
3. kernels -- each kernel against its plain PyTorch version on the card, on
              the stream demo's own frames and on B=4096 frames from a fixed
              seed, for the committed int8 artifact and for seeded random
              weights: 0 mismatching int8 activations and labels required.
              Times at B=4096 (median of CUDA-event timings), the plain
              version's, torch._int_mm on the kernel's largest product as a
              yardstick, and the least time the card could take (bound).
4. stream  -- ``run_stream_demo`` on cuda with the default StreamConfig and
              the committed artifact, launch counters zeroed just before:
              subbands 1/5/11 must read BPSK/QPSK/GFSK, streamed labels must
              equal whole-stream labels, both kernels must have launched,
              and the labels must agree with the CPU plain path.

Then one ``{"kernels": [...]}`` line and, last, the contract line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before the
last line. With no CUDA device, or outside a checkout of the repository, it
exits non-zero and prints no result.
"""
from __future__ import annotations

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
SEED = 0
# Dense peaks from NVIDIA's data sheets: (int8 ops/s, memory bytes/s).
PEAKS = {"SXM": (1979e12, 3.35e12), "PCIe": (1513e12, 2.0e12),
         "NVL": (1671e12, 3.9e12)}
TPU_KERNELS = {
    "conv_stage_int8_v7": "modulationdetectioncnn_tpu/ops/infer.py:1676",
    "dense_argmax_int8": "modulationdetectioncnn_tpu/ops/infer.py:631",
}
SOURCES = {
    "conv_stage_int8_v7": "modulationdetectioncnn_torch/csrc/conv_stage_int8.cu",
    "dense_argmax_int8": "modulationdetectioncnn_torch/csrc/dense_argmax_int8.cu",
}


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


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median over ``iters`` launches, each timed with its own CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
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
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, QuantizedModel, load_int8

    rng = np.random.default_rng(SEED)
    art_np = QuantizedModel.from_npz(DEFAULT_ARTIFACT)
    weights = {"artifact": load_int8(device="cuda"),
               "seeded": random_weights(art_np, rng)}
    x_seed = torch.from_numpy(
        (0.7 * rng.standard_normal((BATCH, 2, 128))).astype(np.float32)).cuda()
    # Ragged batches and a slice that starts inside the tensor too.
    inputs = {"stream_frames": demo_frames, "seeded_b4096": x_seed,
              "seeded_b1": x_seed[:1], "seeded_b37_at3": x_seed[3:40]}

    checks, stats = [], {n: {"mismatches": 0, "max_abs_err": 0} for n in TPU_KERNELS}
    for wname, qw in weights.items():
        for xname, x in inputs.items():
            conv_k = infer.conv_stage_int8_v7(x, qw)
            conv_p = infer.conv_stage_int8_v7_plain(x, qw)
            lab_k = infer.dense_argmax_int8(conv_p, qw)
            lab_p = infer.dense_argmax_int8_plain(conv_p, qw)
            torch.cuda.synchronize()
            for kname, (got, want) in {"conv_stage_int8_v7": (conv_k, conv_p),
                                       "dense_argmax_int8": (lab_k, lab_p)}.items():
                mism, err = compare(kname, got, want)
                stats[kname]["mismatches"] += mism
                stats[kname]["max_abs_err"] = max(stats[kname]["max_abs_err"], err)
                checks.append({"kernel": kname, "weights": wname, "input": xname,
                               "n": int(x.shape[0]), "mismatches": mism})
            checks.append({"weights": wname, "input": xname,
                           "conv_live_fraction": round(float((conv_p > 0).float().mean()), 4),
                           "label_classes": int(torch.unique(lab_p).numel())})
    for c in checks:
        emit({"phase": "kernels.check", **c})
    for kname, s in stats.items():
        require(s["mismatches"] == 0, f"{kname}: {s['mismatches']} mismatches vs plain")

    # Timing at B=4096 with the artifact's weights.
    qw = weights["artifact"]
    x = x_seed
    a1 = infer.conv1_int8_plain(x, qw)
    conv = infer.conv_stage_int8_v7_plain(x, qw)
    im2col = torch.cat([a1[:, k:k + 124] for k in range(3)], dim=-1).reshape(-1, 1536)
    h = conv.reshape(BATCH, -1)
    b = BATCH
    ops_conv = 2 * b * (126 * 512 * 3 + 124 * 80 * 1536)
    bytes_conv = (b * 2 * 128 * 4 + b * 124 * 80
                  + sum(t.numel() * t.element_size() for t in
                        (qw.w1, qw.m1, qw.o1, qw.w2t, qw.m2, qw.o2)))
    ops_dense = 2 * b * (9920 * 256 + 256 * 11)
    bytes_dense = (b * 9920 + b * 4
                   + sum(t.numel() * t.element_size() for t in
                         (qw.w3t, qw.m3, qw.o3, qw.w4, qw.s4, qw.b4)))
    int8_peak, bw_peak = dev_info["int8_ops_per_s"], dev_info["bytes_per_s"]

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / int8_peak * 1e3, nbytes / bw_peak * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    rows = []
    for kname, kernel, plain, lib, ops, nbytes, arg in (
            ("conv_stage_int8_v7", infer.conv_stage_int8_v7,
             infer.conv_stage_int8_v7_plain,
             lambda: torch._int_mm(im2col, qw.w2t.T), ops_conv, bytes_conv, x),
            ("dense_argmax_int8", infer.dense_argmax_int8,
             infer.dense_argmax_int8_plain,
             lambda: torch._int_mm(h, qw.w3t.T), ops_dense, bytes_dense, h)):
        ms = time_ms(lambda: kernel(arg, qw), iters=30)
        plain_ms = time_ms(lambda: plain(arg, qw), iters=5, warmup=1)
        library_ms = time_ms(lib, iters=20)
        bms, by = bound(ops, nbytes)
        rows.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                     "replaces": TPU_KERNELS[kname], "launches": None,
                     "max_abs_err": stats[kname]["max_abs_err"],
                     "mismatches": stats[kname]["mismatches"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": library_ms,
                     "library_call": "torch._int_mm (largest product, int32 out)",
                     "batch": b, "ops": ops, "bytes": nbytes})
    emit({"phase": "kernels", "timed": rows})
    return rows


def phase_stream(kernel_rows: list[dict]) -> None:
    from collections import Counter

    from modulationdetectioncnn_torch.config import AmcConfig, RML_CLASSES
    from modulationdetectioncnn_torch.dsp import framer, pipeline
    from modulationdetectioncnn_torch.ops import infer

    cfg = AmcConfig()                      # default StreamConfig, device=cuda
    infer.reset_launch_counts()
    t0 = time.perf_counter()
    labels = pipeline.run_stream_demo(cfg)
    wall = time.perf_counter() - t0
    launches = {"conv_stage_int8_v7": infer.conv_stage_int8_v7.launches,
                "dense_argmax_int8": infer.dense_argmax_int8.launches}
    for row in kernel_rows:
        row["launches"] = launches[row["name"]]

    wide, occupied = pipeline.make_demo_signal(cfg)
    predict = pipeline._make_predictor(cfg)
    batch = pipeline.classify_stream(framer.to_planes(wide, "cuda"), predict,
                                     cfg.stream).cpu().numpy()
    cpu_cfg = AmcConfig(device="cpu")
    cpu = pipeline.classify_stream_blocked(
        framer.to_planes(wide, "cpu"), pipeline._make_predictor(cpu_cfg),
        cpu_cfg.stream).numpy()
    tops = {k: RML_CLASSES[Counter(labels[k].tolist()).most_common(1)[0][0]]
            for k in occupied}
    occ = sorted(occupied)
    agree_cpu = float((cpu == labels).mean())
    emit({"phase": "stream", "frames": int(labels.size), "shape": list(labels.shape),
          "wall_s": wall, "tops": tops, "launches": launches,
          "streamed_equals_batch": bool(np.array_equal(labels, batch[:, :labels.shape[1]])),
          "agreement_with_cpu_plain": agree_cpu,
          "occupied_equal_cpu_plain": bool(np.array_equal(labels[occ], cpu[occ]))})
    require(tops == occupied, f"occupied subbands read {tops}, want {occupied}")
    require(labels.shape[1] == batch.shape[1]
            and np.array_equal(labels, batch), "streamed labels != whole-stream labels")
    require(all(n > 0 for n in launches.values()), f"kernel not launched: {launches}")
    # CPU and GPU DSP floats differ in the last bits (matmul order), which
    # can flip CFO's argmax on noise-only frames: >= 99 % overall, exact on
    # the occupied subbands.
    require(np.array_equal(labels[occ], cpu[occ]), "occupied subbands differ from CPU")
    require(agree_cpu >= 0.99, f"agreement with CPU plain path {agree_cpu}")


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
    t_start = time.perf_counter()
    try:
        dev = phase_device()
        phase_build()
        rows = phase_kernels(dev, demo_frames())
        phase_stream(rows)
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
