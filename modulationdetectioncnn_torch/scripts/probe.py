"""Probes of the port's kernels and stream chain on the card.

The port's counterpart of the JAX package's ``scripts/probe.py``, for the
probes whose question the port still asks: each times the port's own
hand-written kernels (PERF.md's kernel table) or torch ops, never a copy of
a TPU layout variant. The TPU probes that ask a layout question (lane
packings, Mosaic transposes, the MXU and VMEM laws) have no counterpart:
the port lays its data out for the H100, and each of their kernels computes
a function that one of the port's kernels computes (PERF.md section 6).

  ceil      the int8 and bf16 product ceilings (``torch._int_mm``,
            ``torch.matmul``) at 2048^3 and 8192^3, and the memory's: a
            copy of (4096, 16384) int8 by the port's copy kernel and by torch
  stage     the v2 path by stage: quantize + tap rows, the tap planes (in
            torch and by the port's prologue kernel), row 9, row 11, the
            argmax, the whole ``pallas_int8`` forward
  dense     row 11, row 2, and dense1 alone (``torch._int_mm``, a yardstick)
  batch     the v7, v10 and v2 classifiers over B = 2048 .. 16384
  r3stream  the stream chain by stage at the bench's 524,288 samples
  r5cfo     the CFO chain's components at B=4096

Every record is one JSON line: ``ms`` is the median per call of 5 runs of
20 back-to-back calls between CUDA events (the longer of the device's and
the host's time); ``device_ms``, where printed, the card's busy time per
call under ``torch.profiler``. Each probe prints the card's name and power
limit first. There is no CPU version: a probe raises without a card.

    python -m modulationdetectioncnn_torch.scripts.probe ceil stage dense batch r3stream r5cfo
"""
from __future__ import annotations

import json
import statistics
import sys

import numpy as np
import torch

from modulationdetectioncnn_torch.ops import probe_kernels
from modulationdetectioncnn_torch.scripts.bench_breakdown import (
    BATCH, CONV_MACS, DENSE_MACS, FULL_MACS, T_IN)


def _header(probe: str) -> torch.device:
    """The card (raises without one), after printing its name and power
    limit."""
    from modulationdetectioncnn_torch.device import describe, resolve_device

    dev = resolve_device("cuda")
    print(json.dumps({"probe": probe, "device": describe(dev)}), flush=True)
    return dev


def _time(name: str, fn, ops: float | None = None, samples: int | None = None,
          nbytes: int | None = None, device: bool = False) -> dict:
    """Time ``fn`` and print its record: ``ops`` per call give ops/s,
    ``samples`` (I/Q samples per call) MS/s, ``nbytes`` (read and written
    per call) bytes/s, ``device`` the profiler's device time per call."""
    from modulationdetectioncnn_torch.utils.profiler import device_ms_per_call
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    runs = launch_ms_samples(fn)
    ms = statistics.median(runs)
    rec = {"name": name, "ms": ms, "samples_ms": runs}
    if ops:
        rec["ops_per_s"] = ops / (ms / 1e3)
    if samples:
        rec["msamples_per_s"] = samples / ms / 1e3
    if nbytes:
        rec["bytes_per_s"] = nbytes / (ms / 1e3)
    if device:
        rec["device_ms"] = device_ms_per_call(fn)
    print(json.dumps(rec), flush=True)
    return rec


def _seeded(shape, dev, low=None, high=None, dtype=np.float32, seed=0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) if low is None
         else rng.integers(low, high, shape)).astype(dtype)
    return torch.from_numpy(a).to(dev)


def _weights():
    """The bench's int8 weights (its seeded model through the port's PTQ)
    and its B=4096 frames."""
    from modulationdetectioncnn_torch import bench
    from modulationdetectioncnn_torch.config import AmcConfig

    return bench.make_int8_weights(AmcConfig(), BATCH)


def probe_ceil() -> list[dict]:
    dev = _header("ceil")
    recs = []
    for n in (2048, 8192):
        a = _seeded((n, n), dev, -100, 100, np.int8)
        b_cm = _seeded((n, n), dev, -100, 100, np.int8, seed=1).t()
        recs.append(_time(f"int8 torch._int_mm {n}^3", lambda: torch._int_mm(a, b_cm),
                          ops=2 * n ** 3))
        ab, bb = a.to(torch.bfloat16), b_cm.t().contiguous().to(torch.bfloat16)
        recs.append(_time(f"bf16 torch.matmul {n}^3", lambda: torch.matmul(ab, bb),
                          ops=2 * n ** 3))
    # The memory ceiling: probe_r3's copy of the (B, 16384) int8
    # intermediate, by the port's copy kernel and by torch's copy.
    h = _seeded((BATCH, 16384), dev, -128, 128, np.int8)
    out = torch.empty_like(h)
    for name, fn in (("copy_bytes kernel", lambda: probe_kernels.copy_bytes(h)),
                     ("Tensor.copy_ (a yardstick)", lambda: out.copy_(h))):
        recs.append(_time(f"{name}, (4096, 16384) int8", fn, nbytes=2 * h.numel()))
    return recs


def probe_stage() -> list[dict]:
    from modulationdetectioncnn_torch.ops import infer

    _header("stage")
    qw, x = _weights()
    xe = infer.expand_taps(x, qw.inv_sx)
    h = infer.conv_stage_int8_v2(xe, qw)
    logits = infer.dense_int8(h, qw)
    fwd = infer.make_int8_predict(qw, "v2")
    return [
        _time("prologue: quantize + expand_taps (torch)",
              lambda: infer.expand_taps(x, qw.inv_sx), device=True),
        _time("prologue: quantize + tap_planes (torch)",
              lambda: infer.tap_planes(x, qw.inv_sx), device=True),
        _time("prologue: quantize_tap_planes kernel",
              lambda: probe_kernels.quantize_tap_planes(x, qw.inv_sx), device=True),
        _time("row 9 conv_stage_int8_v2", lambda: infer.conv_stage_int8_v2(xe, qw),
              ops=2 * CONV_MACS * BATCH),
        _time("row 11 dense_int8 (logits)", lambda: infer.dense_int8(h, qw),
              ops=2 * DENSE_MACS * BATCH),
        _time("argmax of (B, 11) logits (torch)", lambda: infer.argmax_lowest(logits),
              device=True),
        _time("pallas_int8 forward: v2 logits + argmax", lambda: fwd(x),
              ops=2 * FULL_MACS * BATCH, samples=BATCH * T_IN, device=True),
    ]


def probe_dense() -> list[dict]:
    from modulationdetectioncnn_torch.ops import infer

    dev = _header("dense")
    qw, _ = _weights()
    h0 = _seeded((BATCH, 124 * 80), dev, 0, 80, np.int8)
    return [
        _time("row 11 dense_int8 (logits)", lambda: infer.dense_int8(h0, qw),
              ops=2 * DENSE_MACS * BATCH),
        _time("row 2 dense_argmax_int8 (labels)", lambda: infer.dense_argmax_int8(h0, qw),
              ops=2 * DENSE_MACS * BATCH),
        _time("dense1 alone: torch._int_mm (B, 9920) x (9920, 256), a yardstick",
              lambda: torch._int_mm(h0, qw.w3t.T), ops=2 * 9920 * 256 * BATCH),
    ]


def probe_batch() -> list[dict]:
    from modulationdetectioncnn_torch.ops import infer

    dev = _header("batch")
    qw, _ = _weights()
    recs = []
    for version in ("v7", "v10", "v2"):
        predict = infer.make_int8_predict(qw, version)
        for b in (2048, 4096, 8192, 16384):
            xb = _seeded((b, 2, T_IN), dev)
            recs.append(_time(f"{version} classifier B={b}", lambda: predict(xb),
                              ops=2 * FULL_MACS * b, samples=b * T_IN))
    return recs


def probe_r3stream() -> list[dict]:
    """The stream chain of the bench's stream mode (default StreamConfig:
    16 subbands, CFO on, timing off) by stage, cumulative as in the JAX
    probe, plus the CFO and timing corrections and the classifiers alone."""
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.dsp import channelizer, framer, normalize, pipeline
    from modulationdetectioncnn_torch.ops import infer

    dev = _header("r3stream")
    sc = AmcConfig().stream
    m = sc.num_subbands
    t_len = BATCH * T_IN                                  # 524,288 samples
    h = channelizer.design_prototype(m, sc.taps_per_branch)
    x0 = _seeded((2, t_len), dev)
    fr0 = _seeded((m, t_len // m // T_IN, 2, T_IN), dev)
    qw, x = _weights()
    classify_v7 = infer.make_int8_predict(qw, "v7")
    classify_v10 = infer.make_int8_predict(qw, "v10")

    def chan_move(xc):
        return torch.movedim(channelizer.channelize(xc, h, m), -1, -3)

    def chan_frame(xc):
        fr = framer.frames_from_stream(chan_move(xc), sc.frame_len, sc.frame_hop)
        return fr.transpose(-2, -3)

    def full_chain(xc):
        fr = pipeline.subband_frames(xc, h, sc)
        return classify_v7(fr.reshape(-1, 2, sc.frame_len))

    cases = [
        ("channelize (FIR + DFT)", lambda: channelizer.channelize(x0, h, m)),
        ("channelize + movedim", lambda: chan_move(x0)),
        ("through framing", lambda: chan_frame(x0)),
        ("through power_normalize", lambda: normalize.power_normalize(chan_frame(x0))),
        ("cfo estimate + correct (frames)",
         lambda: normalize.correct_cfo(fr0, normalize.estimate_cfo(fr0, pad_factor=sc.cfo_pad_factor))),
        ("timing estimate + correct (frames)",
         lambda: normalize.correct_timing(fr0, normalize.estimate_timing(fr0, sc.sps),
                                          sc.sps, sc.timing_phases)),
        ("classify v7 alone (B=4096)", lambda: classify_v7(x)),
        ("classify v10 alone (B=4096)", lambda: classify_v10(x)),
        ("full stream chain (cfo on), v7", lambda: full_chain(x0)),
    ]
    return [_time(name, fn, samples=t_len, device=True) for name, fn in cases]


def _peak_parabola(s2: torch.Tensor) -> torch.Tensor:
    """``estimate_cfo``'s peak search on a given |Z|^2 spectrum: the
    argmax, then the parabola through the magnitudes around it."""
    n = s2.shape[-1]
    k = torch.argmax(s2, dim=-1)

    def mag_at(idx):
        return torch.sqrt(torch.gather(s2, -1, (idx % n)[..., None])[..., 0])

    alpha, beta, gamma = mag_at(k - 1), mag_at(k), mag_at(k + 1)
    denom = alpha - 2 * beta + gamma
    delta = torch.where(denom.abs() > 1e-30, 0.5 * (alpha - gamma) / denom,
                        torch.zeros_like(denom))
    return (k.to(torch.float32) + delta) / n


def probe_r5cfo() -> list[dict]:
    """The CFO chain's components at B=4096 frames of (2, 128)."""
    from modulationdetectioncnn_torch.dsp import normalize

    dev = _header("r5cfo")
    x0 = _seeded((BATCH, 2, T_IN), dev)
    s2 = _seeded((BATCH, 4 * T_IN), dev) ** 2
    cos_m, sin_m = (torch.from_numpy(a).to(dev)
                    for a in normalize._padded_dft_matrices(T_IN, 4 * T_IN))

    def x4_dft(x):
        xr, xi = x[..., 0, :], x[..., 1, :]
        pr, pi = xr * xr - xi * xi, 2 * xr * xi
        pr, pi = pr * pr - pi * pi, 2 * pr * pi
        zr = pr @ cos_m - pi @ sin_m
        zi = pi @ cos_m + pr @ sin_m
        return zr * zr + zi * zi

    cases = [
        ("estimate_cfo pad 4", lambda: normalize.estimate_cfo(x0)),
        ("estimate_cfo pad 2", lambda: normalize.estimate_cfo(x0, pad_factor=2)),
        ("estimate + correct", lambda: normalize.correct_cfo(x0, normalize.estimate_cfo(x0))),
        ("correct only (cos/sin + complex multiply)",
         lambda: normalize.correct_cfo(x0, x0[:, 0].mean(dim=-1) * 1e-6)),
        ("x^4 + DFT + |Z|^2 only (resident DFT matrices)", lambda: x4_dft(x0)),
        ("peak + parabola only", lambda: _peak_parabola(s2)),
    ]
    return [_time(name, fn, device=True) for name, fn in cases]


PROBES = {
    "ceil": probe_ceil,
    "stage": probe_stage,
    "dense": probe_dense,
    "batch": probe_batch,
    "r3stream": probe_r3stream,
    "r5cfo": probe_r5cfo,
}


def main(argv: list[str] | None = None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or ["stage"]
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        raise SystemExit(f"unknown probe(s) {unknown}; use {' '.join(PROBES)}")
    for name in names:
        with torch.no_grad():
            PROBES[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
