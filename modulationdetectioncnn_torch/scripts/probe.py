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
  dense_old rows 2 and 11 against an earlier body of ``csrc/dense_argmax_int8.cu``
            (a copy put at ``OLD_DENSE_SRC``, never part of the package), old,
            new, new, old at B = 4096, 2048 and 16384, outputs bit for bit
  dense_bf16_old rows 13 and 16 the same way against an earlier body of
            ``csrc/dense_argmax_bf16.cu`` (a copy at ``OLD_DENSE_BF16_SRC``),
            outputs within the dense stage's tolerances of each other
            (``bf16_dense_misses``), beside ``torch.matmul``'s dense1
  conv2_old rows 18 (bf16, float32) and 20 against an earlier body of
            ``csrc/cnn_kernels.cu`` (a copy at ``OLD_CNN_SRC``) the same way,
            beside the library call on conv2's z
  conv_v7_old row 1 (v7) against an earlier body of ``csrc/conv_stage_int8.cu``
            (a copy at ``OLD_CONV_V7_SRC``) the same way, beside ``_int_mm``
            on conv2's im2col, maps bit for bit
  conv_fold_old rows 3 and 4 (v10, v9) against an earlier body of
            ``csrc/conv_stage_int8_v10.cu`` (a copy at ``OLD_CONV_FOLD_SRC``)
            the same way, beside row 1 and ``_int_mm`` on conv2's
            lane-packed product, maps bit for bit
  conv_v5_old rows 5 and 10 (v5, v1) against an earlier body of
            ``csrc/conv_stage_int8_v5.cu`` (a copy at ``OLD_CONV_V5_SRC``)
            the same way, beside row 1 and ``_int_mm`` on conv2's
            lane-packed product, maps bit for bit
  conv_v6_old rows 6 and 7 (v6, v4) against an earlier body of
            ``csrc/conv_stage_int8_v6.cu`` (a copy at ``OLD_CONV_V6_SRC``,
            with the header it includes beside it) the same way, on the tap
            planes of the same frames, beside row 5, row 1 and ``_int_mm``
            on conv2's lane-packed product, maps bit for bit
  conv_v3_old rows 8 and 9 (v3, v2) against an earlier body of
            ``csrc/conv_stage_int8_v3.cu`` (a copy at ``OLD_CONV_V3_SRC``,
            with the header it includes beside it) the same way, on the tap
            rows of the same frames, beside row 6, row 1 and ``_int_mm`` on
            conv2's lane-packed product, maps bit for bit
  conv1_int8_old row 19 against an earlier body of ``csrc/cnn_kernels.cu`` (a
            copy at ``OLD_CNN_SRC``) the same way, on the quantized seeded
            frames under the committed artifact's conv1, outputs bit for bit
  conv1_old row 17 (bf16 and float32 out) against an earlier body of
            ``csrc/cnn_kernels.cu`` (a copy at ``OLD_CNN_SRC``), old, new,
            new, old at B = 2048, 4096 and 16384, on seeded frames under the
            bench's seeded conv1, outputs bit for bit
  copy_old  row 23 (the byte copy) against an earlier body of
            ``csrc/probe_kernels.cu`` (a copy at ``OLD_PROBE_SRC``) the same
            way on (B, 16384) int8, beside ``Tensor.copy_`` into a
            preallocated tensor, outputs bit for bit
  timing_old row 21 (the timing FIR) against an earlier body of
            ``csrc/correct_timing.cu`` (a copy at ``OLD_TIMING_SRC``) the same
            way, on seeded frames with their own timing filters, beside the
            library call (an unfolded ``torch.matmul``), outputs bit for bit
  conv2_maps row 18 bf16 on the bench's conv1 map, a seeded map, its ReLU,
            zeros, and with one channel tile (Co 40), beside torch.matmul
  batch     the v7, v10 and v2 classifiers over B = 2048 .. 16384
  r3stream  the stream chain by stage at the bench's 524,288 samples
  r5cfo     the CFO chain's components at B=4096

Every record is one JSON line: ``ms`` is the median per call of 5 runs of
20 back-to-back calls between CUDA events (the longer of the device's and
the host's time); ``device_ms``, where printed, the card's busy time per
call under ``torch.profiler``. Each probe prints the card's name and power
limit first. There is no CPU version: a probe raises without a card.

    python -m modulationdetectioncnn_torch.scripts.probe ceil stage dense batch r3stream r5cfo

``dense_edge_cases`` builds the int8 dense stage's edge inputs, which
chip_smoke.py holds rows 2 and 11 to on the card and the CPU tests hold
their plain versions to against the JAX package's golden chain;
``dense_bf16_edge_cases`` the bf16 dense stage's (rows 13 and 16), held
the same way against the JAX package's Pallas kernels in interpret mode;
``conv_v7_edge_cases`` the v7 conv stage's (row 1), held the same way
(``tests/test_torch_v7_edges.py``). ``conv_bf16_old_vs_new`` times the
bf16 conv stages (rows 15, 14, 12) against an earlier body at
``OLD_CONV_BF16_SRC`` for chip_smoke.py, ``conv_fold_old_vs_new`` rows 3
and 4 (v10, v9) against one at ``OLD_CONV_FOLD_SRC``, ``conv_v5_old_vs_new``
rows 5 and 10 (v5, v1) against one at ``OLD_CONV_V5_SRC``,
``conv_v6_old_vs_new`` rows 6 and 7 (v6, v4) against one at
``OLD_CONV_V6_SRC``, ``conv_v3_old_vs_new`` rows 8 and 9 (v3, v2) against
one at ``OLD_CONV_V3_SRC``, ``conv1_int8_old_vs_new`` row 19 and
``conv1_old_vs_new`` row 17 against one at ``OLD_CNN_SRC``,
``timing_old_vs_new`` row 21 against one at ``OLD_TIMING_SRC`` and
``copy_old_vs_new`` row 23 against one at ``OLD_PROBE_SRC``.
``conv1_int8_edge_cases`` builds row 19's edge inputs and
``TIMING_TAU_EDGES`` row 21's, which chip_smoke.py holds the kernels to
on the card and ``tests/test_torch_fir_conv1_rows.py`` the plain versions
to against the JAX package. ``fold_edge_tree``
builds a model at the edge of the v9/v10 fold's contract and
``conv1_probe_trees`` turns conv2 into a pass-through, so that a conv
stage's map shows its conv1 map: chip_smoke.py holds rows 3 and 4 to
both on the card, ``tests/test_torch_v10_fold.py`` their plain version to
the JAX package's v10 kernel.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from modulationdetectioncnn_torch.ops import _build, probe_kernels
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


OLD_DENSE_SRC = os.path.join(_build.BUILD_DIR, "dense_argmax_int8_old.cu")
DENSE_ENTRIES = ("dense_argmax_int8", "dense_int8")
OLD_DENSE_BF16_SRC = os.path.join(_build.BUILD_DIR, "dense_argmax_bf16_old.cu")
DENSE_BF16_ENTRIES = ("dense_argmax_bf16", "dense_bf16")
DENSE_BF16_STAGES = ("dense_argmax_bf16", "dense_logits_bf16")   # their wrappers
OLD_CNN_SRC = os.path.join(_build.BUILD_DIR, "cnn_kernels_old.cu")
CNN_ENTRIES = ("conv2_stacked", "conv2_stacked_int8", "conv1_stacked_int8", "conv1_stacked")
OLD_TIMING_SRC = os.path.join(_build.BUILD_DIR, "correct_timing_old.cu")
TIMING_ENTRIES = ("correct_timing_fir",)
OLD_PROBE_SRC = os.path.join(_build.BUILD_DIR, "probe_kernels_old.cu")
PROBE_ENTRIES = ("copy_bytes", "tap_planes")
# The dense stages by wrapper: its C entry (without ``amc_``), the weights
# the entry takes after the map and B, whether it takes the model's classes
# next, and whether it writes logits (else labels).
_INT8_DENSE = ("w3t", "m3", "o3", "w4", "s4", "b4")
_BF16_DENSE = ("w3t", "b3", "w4", "b4")
DENSE_STAGES = {
    "dense_argmax_int8": ("dense_argmax_int8", _INT8_DENSE, False, False),
    "dense_int8": ("dense_int8", _INT8_DENSE, False, True),
    "dense_argmax_bf16": ("dense_argmax_bf16", _BF16_DENSE, True, False),
    "dense_logits_bf16": ("dense_bf16", _BF16_DENSE, True, True),
}
# Rows 13 and 16 against the plain version (PERF.md section 2): labels
# >= 99.9 % equal, each difference a near-tie of the plain logits (top-2 gap
# under 1e-3 of the row's largest); logits within one bf16 ulp of every
# dense1 unit times |w4| (2^-7 * sum_d |d1_d w4_dc|) plus 1e-6 of the
# largest logit, the padded classes -inf.
BF16_LABEL_AGREEMENT, NEAR_TIE = 0.999, 1e-3
BF16_LOGIT_RTOL, BF16_LOGIT_ATOL_OF_MAX = 2.0 ** -7, 1e-6


def old_library(src: str, entries: tuple[str, ...]) -> ctypes.CDLL | None:
    """An earlier body of one of ``csrc/*.cu`` copied to ``src`` (the ignored
    ``_build/``), built on its own with the package's flags (and its headers
    on the include path) and loaded beside the package's library, with the
    C entries ``amc_<name>`` of ``entries`` declared as the package declares
    them; None when there is no copy."""
    if not os.path.isfile(src):
        return None
    out = os.path.splitext(src)[0] + ".so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-shared", "-o",
           out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    for name in entries:
        fn = getattr(lib, f"amc_{name}")
        fn.argtypes = _build._SIGNATURES[f"amc_{name}"]
        fn.restype = ctypes.c_int
    return lib


def _old_dense(lib: ctypes.CDLL, name: str, h: torch.Tensor, w) -> torch.Tensor:
    """The old library's entry of the dense stage ``name`` on the package
    wrapper's arguments (labels or logits)."""
    entry, keys, takes_nc, logits = DENSE_STAGES[name]
    b = h.shape[0]
    out = (torch.empty((b, 11), dtype=torch.float32, device=h.device) if logits
           else torch.empty((b,), dtype=torch.int32, device=h.device))
    args = [h.data_ptr(), b, *(getattr(w, k).data_ptr() for k in keys)]
    if takes_nc:
        args.append(w.nc)
    code = getattr(lib, f"amc_{entry}")(*args, out.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"old amc_{entry} failed to launch: CUDA error {code}")
    return out


def bf16_dense_misses(h: torch.Tensor, bw, got: torch.Tensor,
                      want: torch.Tensor | None = None) -> dict:
    """Row 16's labels ((B,) int32) or row 13's logits ((B, 11) f32) on the
    map ``h`` against ``want`` (another body's; by default the plain
    version's) under the tolerances above, the near-ties and the logits'
    bound taken from the plain version. ``ok`` is whether they hold."""
    from modulationdetectioncnn_torch.ops import infer_bf16 as ib

    plain = ib.dense_logits_bf16_plain(h, bw)
    n = int(h.shape[0])
    if got.dim() == 1:
        want = ib.argmax_lowest(plain) if want is None else want
        differ = (got != want).nonzero().flatten()
        top2 = plain.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]) / plain.abs().masked_fill(
            torch.isinf(plain), 0).amax(-1).clamp_min(1e-30)
        agree = float((got == want).float().mean()) if n else 1.0
        not_tie = int((gap[differ] >= NEAR_TIE).sum())
        return {"n": n, "label_agreement": agree, "differing": int(differ.numel()),
                "differing_not_near_tie": not_tie,
                "max_abs_diff": int((got - want).abs().max()) if n else 0,
                "ok": agree >= BF16_LABEL_AGREEMENT and not_tie == 0}
    want = plain if want is None else want
    live, nc = want[:, :bw.nc], bw.nc
    diff = (got[:, :nc] - live).abs()
    d1 = ib.dense1_bf16_plain(h, bw)
    bound = (BF16_LOGIT_RTOL * (d1.abs() @ bw.w4.float().abs())[:, :nc]
             + BF16_LOGIT_ATOL_OF_MAX * float(plain[:, :nc].abs().max()))
    outside = int((diff > bound).sum()) + int((got[:, nc:] != float("-inf")).sum())
    return {"n": n, "outside_tolerance": outside, "max_abs_diff": float(diff.max()),
            "max_abs_logit": float(live.abs().max()),
            "bit_equal_share": float((got[:, :nc] == live).float().mean()),
            "finite": bool(torch.isfinite(got[:, :nc]).all()),
            "ok": outside == 0 and bool(torch.isfinite(got[:, :nc]).all())}


def dense_old_vs_new(lib: ctypes.CDLL, w, names=DENSE_ENTRIES,
                     batches=(4096, 2048, 16384)) -> list[dict]:
    """Dense stages ``names`` (DENSE_STAGES' wrappers: rows 2 and 11 with
    int8 weights, 13 and 16 with bf16 ones), the old body against the
    package's, on seeded maps ([0, 127] int8; |N(0, 1)| in bf16): each timed
    old, new, new, old (median of 5 runs of 20 calls each between CUDA
    events, then the profiler's device time per call, in the same order),
    beside dense1 alone by ``torch._int_mm`` or ``torch.matmul`` (a
    yardstick) in the same round. ``ok``: int8 outputs bit for bit
    (``outputs_differing``), bf16 ones within ``bf16_dense_misses``'
    tolerances of the old body's."""
    from modulationdetectioncnn_torch.ops import infer, infer_bf16
    from modulationdetectioncnn_torch.utils.profiler import device_ms_per_call
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    def ms(fn):
        return statistics.median(launch_ms_samples(fn))

    bf16 = w.w3t.dtype == torch.bfloat16
    recs = []
    for b in batches:
        if bf16:
            h = _seeded((b, 124 * 80), w.w3t.device, seed=b).abs().to(torch.bfloat16)
            mm = lambda: torch.matmul(h, w.w3t.T)  # noqa: E731
        else:
            h = _seeded((b, 124 * 80), w.w3t.device, 0, 128, np.int8, seed=b)
            mm = lambda: torch._int_mm(h, w.w3t.T)  # noqa: E731
        for name in names:
            new = lambda: getattr(infer_bf16 if bf16 else infer, name)(h, w)  # noqa: E731
            old = lambda: _old_dense(lib, name, h, w)  # noqa: E731
            got, want = new(), old()
            if bf16:
                check = bf16_dense_misses(h, w, got, want)
            else:
                differ = int((got != want).sum())
                check = {"outputs_differing": differ, "ok": differ == 0}
            times = [ms(old), ms(new), ms(new), ms(old)]
            dev = [device_ms_per_call(f) for f in (old, new, new, old)]
            recs.append({"probe": "dense_bf16_old" if bf16 else "dense_old", "name": name,
                         "batch": b, "old_ms": [times[0], times[3]],
                         "new_ms": [times[1], times[2]],
                         "old_device_ms": [dev[0], dev[3]], "new_device_ms": [dev[1], dev[2]],
                         "library_dense1_ms": ms(mm),
                         "library_dense1_device_ms": device_ms_per_call(mm),
                         **{k: v for k, v in check.items() if k != "n"}})
        del h
    return recs


def _dense_old(probe: str, src: str, entries: tuple[str, ...], w, names) -> list[dict]:
    lib = old_library(src, entries)
    if lib is None:
        raise SystemExit(f"{probe}: no earlier body at {src}")
    recs = dense_old_vs_new(lib, w, names)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


def probe_dense_old() -> list[dict]:
    _header("dense_old")
    return _dense_old("dense_old", OLD_DENSE_SRC, DENSE_ENTRIES, _weights()[0], DENSE_ENTRIES)


def probe_dense_bf16_old() -> list[dict]:
    """Rows 13 and 16 against an earlier body of ``csrc/dense_argmax_bf16.cu``
    (a copy at ``OLD_DENSE_BF16_SRC``) on the bench's seeded float model."""
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2
    from modulationdetectioncnn_torch.ops import infer_bf16 as ib

    dev = _header("dense_bf16_old")
    bw = ib.make_bf16_weights(VTCNN2(generator=torch.Generator().manual_seed(0)).state_dict(),
                              dev)
    return _dense_old("dense_bf16_old", OLD_DENSE_BF16_SRC, DENSE_BF16_ENTRIES, bw,
                      DENSE_BF16_STAGES)


def _old_entry(lib: ctypes.CDLL, a1s: torch.Tensor, w2p: torch.Tensor) -> str:
    """The old library's conv2 entry for these arguments: the one of the
    route the package takes (``ops/cnn_kernels.py::conv2_route``) where the
    old library has it, declared as the package declares it, else its
    general entry (``amc_conv2_stacked``, ``amc_conv2_stacked_int8``)."""
    from modulationdetectioncnn_torch.ops import cnn_kernels as ck

    general = "amc_conv2_stacked_int8" if a1s.dtype == torch.int8 else "amc_conv2_stacked"
    route = ck.conv2_route(a1s.shape[2], w2p.shape[1] // 3, a1s.dtype,
                           a1s.data_ptr() % 16 == 0 and w2p.data_ptr() % 16 == 0)
    name = f"{general}_{route}"
    if route == "general" or not hasattr(lib, name):
        return general
    fn = getattr(lib, name)
    fn.argtypes = _build._SIGNATURES[name]
    fn.restype = ctypes.c_int
    return name


def _old_conv2(lib: ctypes.CDLL, a1s: torch.Tensor, w2p: torch.Tensor, *rest) -> torch.Tensor:
    """The old library's conv2 (``_old_entry``'s) on the package wrapper's
    arguments: ``rest`` is (b2, out dtype) for the float modes, (shift,
    offset) for int8."""
    b, t, k = a1s.shape
    co = w2p.shape[1] // 3
    stream = torch.cuda.current_stream().cuda_stream
    entry = _old_entry(lib, a1s, w2p)
    routed = entry not in ("amc_conv2_stacked", "amc_conv2_stacked_int8")
    vec = [] if routed else [int(k * a1s.element_size() % 16 == 0 and a1s.data_ptr() % 16 == 0)]
    if a1s.dtype == torch.int8:
        out = torch.empty((b, t - 2, co), dtype=torch.int8, device=a1s.device)
        args = [rest[0].data_ptr(), rest[1].data_ptr()]     # shift, offset
    else:
        out = torch.empty((b, t - 2, co), dtype=rest[1], device=a1s.device)
        in_f32 = [] if routed else [int(a1s.dtype == torch.float32)]
        args = [rest[0].data_ptr(), *in_f32, int(rest[1] == torch.float32)]
    code = getattr(lib, entry)(a1s.data_ptr(), b, t, k, co, w2p.data_ptr(), *args, *vec,
                               out.data_ptr(), stream)
    if code != 0:
        raise RuntimeError(f"old conv2 ({entry}) failed to launch: CUDA error {code}")
    return out


def conv2_f32_wide_range(b: int, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row 18's float32 edge at the default widths (T 126, K 512, Co 80):
    a1s (B, 126, 512) whose channel j is 2^(-20 + 40 j / 511) times abs of a
    normal (a ReLU map, its channels spanning 2^-20 .. 2^20), w2p of both
    signs, so the largest channels' terms cancel in many sums and the ReLU
    cuts about half of them; b2 0.1 normal. chip_smoke.py holds the kernel
    to the plain version on it, the CPU tests the plain version to the JAX
    kernel, both within 1e-5 of the map's largest magnitude."""
    r = np.random.default_rng(seed)
    t, k, co = 126, 512, 80
    a1s = np.abs(r.standard_normal((b, t, k))) * 2.0 ** np.linspace(-20.0, 20.0, k)
    w2p = r.standard_normal((k, 3 * co)) / np.sqrt(3 * k)
    b2 = 0.1 * r.standard_normal(co)
    return a1s.astype(np.float32), w2p.astype(np.float32), b2.astype(np.float32)


def conv2_old_vs_new(lib: ctypes.CDLL, w2p: torch.Tensor, b2: torch.Tensor, w2p_i8: torch.Tensor,
                     m2: torch.Tensor, o2: torch.Tensor,
                     batches=(4096, 2048, 16384)) -> list[dict]:
    """Rows 18 (bf16 and float32) and 20, the old body against the
    package's, on seeded (B, 126, 512) maps under the given weights (float
    w2p (512, 240), b2 (80,); int8 w2p, shift, offset): each timed old, new,
    new, old (median of 5 runs of back-to-back calls between CUDA events,
    then the profiler's device time per call, in the same order), beside
    the library call on conv2's z in the same round. The old body is the
    old library's entry of the package's route where it has one, else its
    general entry (``old_entry``). ``differing`` counts output elements
    outside the row's tolerance against the old body: int8 bit for bit,
    bf16 one bf16 ulp plus 1e-3 of the map's largest magnitude, float32
    1e-5 of it."""
    from modulationdetectioncnn_torch.ops import cnn_kernels as ck
    from modulationdetectioncnn_torch.utils.profiler import device_ms_per_call
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    def ms(fn, iters):
        return statistics.median(launch_ms_samples(fn, iters))

    w2b, w2i_cm = w2p.to(torch.bfloat16), w2p_i8.t().contiguous().t()
    recs = []
    for b in batches:
        dev = w2p.device
        af = _seeded((b, 126, 512), dev, seed=b)
        ab = af.to(torch.bfloat16)
        ai = _seeded((b, 126, 512), dev, 0, 128, np.int8, seed=b + 1)
        cases = (
            ("conv2_stacked bf16", (ab, w2b), lambda: ck.conv2_stacked(ab, w2b, b2),
             lambda: _old_conv2(lib, ab, w2b, b2, torch.bfloat16),
             lambda: torch.matmul(ab.reshape(-1, 512), w2b), (2.0 ** -7, 1e-3), 20),
            ("conv2_stacked float32", (af, w2p),
             lambda: ck.conv2_stacked(af, w2p, b2, out_dtype=torch.float32),
             lambda: _old_conv2(lib, af, w2p, b2, torch.float32),
             lambda: torch.matmul(af.reshape(-1, 512), w2p), (0.0, 1e-5), 5),
            ("conv2_stacked_int8", (ai, w2p_i8), lambda: ck.conv2_stacked_int8(ai, w2p_i8, m2, o2),
             lambda: _old_conv2(lib, ai, w2p_i8, m2, o2),
             lambda: torch._int_mm(ai.reshape(-1, 512), w2i_cm), (0.0, 0.0), 20))
        for name, (a_in, w_in), new, old, library, (rtol, atol_of_max), iters in cases:
            entry, route = _old_entry(lib, a_in, w_in), ck.conv2_route(512, 80, a_in.dtype)
            got, want = new(), old()
            g, w = got.double(), want.double()
            bound = rtol * w.abs() + atol_of_max * float(w.abs().max())
            differ = int(((g - w).abs() > bound).sum())
            times = [ms(old, iters), ms(new, iters), ms(new, iters), ms(old, iters)]
            dev_ms = [device_ms_per_call(f, iters) for f in (old, new, new, old)]
            recs.append({"probe": "conv2_old", "name": name, "batch": b,
                         "old_entry": entry, "new_route": route,
                         "old_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                         "old_device_ms": [dev_ms[0], dev_ms[3]],
                         "new_device_ms": [dev_ms[1], dev_ms[2]],
                         "library_ms": ms(library, iters),
                         "library_device_ms": device_ms_per_call(library, iters),
                         "outputs_differing": differ})
        del af, ab, ai
    return recs


def probe_conv2_old() -> list[dict]:
    from modulationdetectioncnn_torch.quant import load_int8

    dev = _header("conv2_old")
    lib = old_library(OLD_CNN_SRC, CNN_ENTRIES)   # its conv2 entries: the general route
    if lib is None:
        raise SystemExit(f"conv2_old: no earlier body at {OLD_CNN_SRC}")
    qw = load_int8(device="cuda")
    w2p = _seeded((512, 240), dev, seed=7) / np.sqrt(1536)
    b2 = 0.1 * _seeded((80,), dev, seed=8)
    recs = conv2_old_vs_new(lib, w2p, b2, qw.w2l, qw.m2, qw.o2)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


def probe_conv2_maps() -> list[dict]:
    """Row 18 bf16 at B=4096 (the Hopper route) on the bench's conv1 map, a
    seeded map, its ReLU, an all-zero map, and with one channel tile (Co
    40: the map read once, not by two blocks), each beside ``torch.matmul``
    on conv2's z, two rounds."""
    from modulationdetectioncnn_torch import bench
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.ops import cnn_kernels as ck

    dev = _header("conv2_maps")
    x, _, model = bench._frames_and_model(AmcConfig(), BATCH)
    w1p, b1, w2p, b2 = ck.float_conv_weights(model.state_dict(), dev)
    w2b = w2p.to(torch.bfloat16)
    seeded = _seeded((BATCH, 126, 512), dev).to(torch.bfloat16)
    maps = {"bench_conv1": ck.conv1_stacked(x.to(dev), w1p, b1), "seeded": seeded,
            "seeded_relu": torch.relu(seeded), "zeros": torch.zeros_like(seeded)}
    w40 = w2b.reshape(512, 3, 80)[:, :, :40].reshape(512, 120).contiguous()
    recs = []
    for rnd in range(2):
        for name, a in maps.items():
            for w, bias, co in ((w2b, b2, 80), (w40, b2[:40].contiguous(), 40)):
                if co == 40 and name != "seeded":
                    continue
                rec = _time(f"row 18 bf16 {name} Co {co}, round {rnd}",
                            lambda: ck.conv2_stacked(a, w, bias), device=True)
                rec["library"] = _time(f"torch.matmul z {name} Co {co}, round {rnd}",
                                       lambda: torch.matmul(a.reshape(-1, 512), w),
                                       device=True)["ms"]
                recs.append(rec)
    return recs


OLD_CONV_V7_SRC = os.path.join(_build.BUILD_DIR, "conv_stage_int8_old.cu")
CONV_V7_ENTRIES = ("conv_stage_int8_v7",)
OLD_CONV_FOLD_SRC = os.path.join(_build.BUILD_DIR, "conv_stage_int8_v10_old.cu")
CONV_FOLD_ENTRIES = ("conv_stage_int8_v10", "conv_stage_int8_v9")
OLD_CONV_V5_SRC = os.path.join(_build.BUILD_DIR, "conv_stage_int8_v5_old.cu")
CONV_V5_ENTRIES = ("conv_stage_int8_v5", "conv_stage_int8_v1")
# The tap-plane and tap-row bodies that rows 6, 7 and 8, 9 ran first
# include conv_stage_int8_mma.cuh, which the package no longer has: a copy
# of it (c875d35's, the same as fcc11c4's) goes into _build/ beside them.
OLD_CONV_V6_SRC = os.path.join(_build.BUILD_DIR, "conv_stage_int8_v6_old.cu")
CONV_V6_ENTRIES = ("conv_stage_int8_v6", "conv_stage_int8_v4")
OLD_CONV_V3_SRC = os.path.join(_build.BUILD_DIR, "conv_stage_int8_v3_old.cu")
CONV_V3_ENTRIES = ("conv_stage_int8_v3", "conv_stage_int8_v2")


def _old_conv(lib: ctypes.CDLL, name: str, x: torch.Tensor, qw) -> torch.Tensor:
    """The old library's entry ``amc_<name>`` of an int8 conv stage on the
    package wrapper's arguments (its input, frames, tap planes or tap
    rows, then the weights of ``ops/infer.py::_ENTRIES`` in their order,
    and inv_sx for frames): the (B, 124, 80) int8 map."""
    from modulationdetectioncnn_torch.ops import infer

    b = x.shape[0]
    out = torch.empty((b, 124, 80), dtype=torch.int8, device=x.device)
    keys, kind = infer._ENTRIES[name]
    args = [x.data_ptr(), b, *(getattr(qw, k).data_ptr() for k in keys)]
    if kind == infer._FRAMES:
        args.append(qw.inv_sx)
    code = getattr(lib, f"amc_{name}")(*args, out.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"old amc_{name} failed to launch: CUDA error {code}")
    return out


def conv_v7_old_vs_new(lib: ctypes.CDLL, qw, batches=(4096, 2048, 16384)) -> list[dict]:
    """Row 1, the old body against the package's, on seeded frames
    (0.7 N(0, 1)) under the full-width weights ``qw``: each timed old, new,
    new, old (median of 5 runs of 20 calls between CUDA events, then the
    profiler's device time per call, in the same order), beside
    ``torch._int_mm`` on conv2's im2col, (B*124, 1536) x (1536, 80) (a
    yardstick), in the same round. ``ok``: the maps bit for bit."""
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.utils.profiler import device_ms_per_call
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    def ms(fn):
        return statistics.median(launch_ms_samples(fn))

    dev, w_cm = qw.w2t.device, qw.w2t.T
    recs = []
    for b in batches:
        x = 0.7 * _seeded((b, 2, T_IN), dev, seed=b)
        cols = torch.randint(0, 128, (b * 124, 1536), dtype=torch.int8, device=dev,
                             generator=torch.Generator(dev).manual_seed(b))
        new = lambda: infer.conv_stage_int8_v7(x, qw)  # noqa: E731
        old = lambda: _old_conv(lib, "conv_stage_int8_v7", x, qw)  # noqa: E731
        mm = lambda: torch._int_mm(cols, w_cm)  # noqa: E731
        differ = int((new() != old()).sum())
        times = [ms(old), ms(new), ms(new), ms(old)]
        dev_ms = [device_ms_per_call(f) for f in (old, new, new, old)]
        recs.append({"probe": "conv_v7_old", "name": "conv_stage_int8_v7", "batch": b,
                     "old_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                     "old_device_ms": [dev_ms[0], dev_ms[3]],
                     "new_device_ms": [dev_ms[1], dev_ms[2]],
                     "library_im2col_ms": ms(mm),
                     "library_im2col_device_ms": device_ms_per_call(mm),
                     "maps_differing": differ, "ok": differ == 0})
        del x, cols
    return recs


def probe_conv_v7_old() -> list[dict]:
    """Row 1 against an earlier body of ``csrc/conv_stage_int8.cu`` (a copy
    at ``OLD_CONV_V7_SRC``) on the committed artifact's weights."""
    return _conv_old("conv_v7_old", OLD_CONV_V7_SRC, CONV_V7_ENTRIES, conv_v7_old_vs_new)


def _conv_old_vs_new(lib: ctypes.CDLL, qw, entries: tuple[str, ...], tag: str,
                     batches, rows: tuple[tuple[int, str], ...] = ()) -> list[dict]:
    """The int8 conv stages ``entries``, the old body against the
    package's, on seeded frames (0.7 N(0, 1)), their tap planes or their
    tap rows (each entry on the input it takes) under the full-width
    weights ``qw``: each timed old, new, new, old (median of 5 runs of 20
    calls between CUDA events, then the profiler's device time per call,
    in the same order), beside yardsticks timed in the same round: row 1
    (the package's v7, the same map), the rows of ``rows``, (row, version)
    pairs such as (6, "v6") (each on the input it takes; the same map) and
    ``torch._int_mm`` on conv2's lane-packed product, (B*126, 512) x (512,
    240). ``ok``: the maps bit for bit."""
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.utils.profiler import device_ms_per_call
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    def ms(fn):
        return statistics.median(launch_ms_samples(fn))

    w_cm = qw.w2l.t().contiguous().t()                  # (512, 240), column-major
    recs = []
    for b in batches:
        x = 0.7 * _seeded((b, 2, T_IN), qw.w2l.device, seed=b)
        a1 = infer.conv1_int8_plain(x, qw).reshape(-1, 512)
        mm = lambda: torch._int_mm(a1, w_cm)  # noqa: E731
        v7 = lambda: infer.conv_stage_int8_v7(x, qw)  # noqa: E731
        yard = {"row1_v7_ms": ms(v7), "row1_v7_device_ms": device_ms_per_call(v7)}
        inputs = {infer._FRAMES: x, infer._PLANES: infer.tap_planes(x, qw.inv_sx),
                  infer._TAPS: infer.expand_taps(x, qw.inv_sx)}
        for row, v in rows:
            name = f"conv_stage_int8_{v}"
            inp = inputs[infer._ENTRIES[name][1]]
            fn = lambda: getattr(infer, name)(inp, qw)  # noqa: E731
            yard.update({f"row{row}_{v}_ms": ms(fn), f"row{row}_{v}_device_ms":
                         device_ms_per_call(fn)})
        yard.update(library_lane_packed_ms=ms(mm),
                    library_lane_packed_device_ms=device_ms_per_call(mm))
        for name in entries:
            inp = inputs[infer._ENTRIES[name][1]]
            new = lambda: getattr(infer, name)(inp, qw)  # noqa: E731
            old = lambda: _old_conv(lib, name, inp, qw)  # noqa: E731
            differ = int((new() != old()).sum())
            times = [ms(old), ms(new), ms(new), ms(old)]
            dev_ms = [device_ms_per_call(f) for f in (old, new, new, old)]
            recs.append({"probe": tag, "name": name, "batch": b,
                         "old_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                         "old_device_ms": [dev_ms[0], dev_ms[3]],
                         "new_device_ms": [dev_ms[1], dev_ms[2]], **yard,
                         "maps_differing": differ, "ok": differ == 0})
        del x, a1, inputs
    return recs


def conv_fold_old_vs_new(lib: ctypes.CDLL, qw, batches=(4096, 2048, 16384)) -> list[dict]:
    """Rows 3 and 4 (v10, v9) against an earlier body (``_conv_old_vs_new``)."""
    return _conv_old_vs_new(lib, qw, CONV_FOLD_ENTRIES, "conv_fold_old", batches)


def conv_v5_old_vs_new(lib: ctypes.CDLL, qw, batches=(4096, 2048, 16384)) -> list[dict]:
    """Rows 5 and 10 (v5, v1) against an earlier body (``_conv_old_vs_new``)."""
    return _conv_old_vs_new(lib, qw, CONV_V5_ENTRIES, "conv_v5_old", batches)


def conv_v6_old_vs_new(lib: ctypes.CDLL, qw, batches=(4096, 2048, 16384)) -> list[dict]:
    """Rows 6 and 7 (v6, v4) against an earlier body (``_conv_old_vs_new``,
    beside row 5 too)."""
    return _conv_old_vs_new(lib, qw, CONV_V6_ENTRIES, "conv_v6_old", batches, rows=((5, "v5"),))


def conv_v3_old_vs_new(lib: ctypes.CDLL, qw, batches=(4096, 2048, 16384)) -> list[dict]:
    """Rows 8 and 9 (v3, v2) against an earlier body (``_conv_old_vs_new``,
    beside row 6 too)."""
    return _conv_old_vs_new(lib, qw, CONV_V3_ENTRIES, "conv_v3_old", batches, rows=((6, "v6"),))


def probe_conv_fold_old() -> list[dict]:
    """Rows 3 and 4 against an earlier body of ``csrc/conv_stage_int8_v10.cu``
    (a copy at ``OLD_CONV_FOLD_SRC``) on the committed artifact's weights."""
    return _conv_old("conv_fold_old", OLD_CONV_FOLD_SRC, CONV_FOLD_ENTRIES,
                     conv_fold_old_vs_new)


def probe_conv_v5_old() -> list[dict]:
    """Rows 5 and 10 against an earlier body of ``csrc/conv_stage_int8_v5.cu``
    (a copy at ``OLD_CONV_V5_SRC``) on the committed artifact's weights."""
    return _conv_old("conv_v5_old", OLD_CONV_V5_SRC, CONV_V5_ENTRIES, conv_v5_old_vs_new)


def probe_conv_v6_old() -> list[dict]:
    """Rows 6 and 7 against an earlier body of ``csrc/conv_stage_int8_v6.cu``
    (a copy at ``OLD_CONV_V6_SRC``) on the committed artifact's weights."""
    return _conv_old("conv_v6_old", OLD_CONV_V6_SRC, CONV_V6_ENTRIES, conv_v6_old_vs_new)


def probe_conv_v3_old() -> list[dict]:
    """Rows 8 and 9 against an earlier body of ``csrc/conv_stage_int8_v3.cu``
    (a copy at ``OLD_CONV_V3_SRC``) on the committed artifact's weights."""
    return _conv_old("conv_v3_old", OLD_CONV_V3_SRC, CONV_V3_ENTRIES, conv_v3_old_vs_new)


def _conv_old(tag: str, src: str, entries: tuple[str, ...], run) -> list[dict]:
    """The probe ``tag``: ``run`` on the old body at ``src`` under the
    committed artifact's weights, one printed record per batch and entry."""
    from modulationdetectioncnn_torch.quant import load_int8

    _header(tag)
    lib = old_library(src, entries)
    if lib is None:
        raise SystemExit(f"{tag}: no earlier body at {src}")
    recs = run(lib, load_int8(device="cuda"))
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


# The fold-edge model's conv1 requantize, (shift, offset) for channel j at
# j % 12: offsets with 8-bit significands (bf16-exact once scaled) up to
# 16,711,680, so |acc| + |o1| reaches 16,760,067 of the fold's 2^24 bound;
# shifts from 0 to 31, with sums whose rq1 lands far below 0, far above
# 127, across 0, across 127 and at 2^24 units of 2^-31.
FOLD_EDGE_RQ1 = ((0, 16711680), (0, -16711680), (1, 0), (8, 0), (12, 0), (12, 520192),
                 (16, 8323072), (17, 16646144), (20, 16711680), (24, 16711680),
                 (30, -16711680), (31, 16646144))


def fold_edge_tree(seed: int) -> dict:
    """The committed artifact's tree with conv1 at the edge of the v9/v10
    fold's contract (``quant.fold_conv1_weights`` accepts it): taps +-127
    (a seeded sign per tap and channel) on the even channels, seeded in
    [-127, 127] on the odd ones, and ``FOLD_EDGE_RQ1``'s shift and offset
    pairs; conv2's requantize moved so the map stays live (channel co: on
    32 seeded frames, the offset takes off its sums' median and the shift
    puts the 75th percentile of what is left at or under 127)."""
    from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, QuantizedModel

    rng = np.random.default_rng(seed)
    tree = QuantizedModel.from_npz(DEFAULT_ARTIFACT).tree()
    c1 = tree["w1p"].shape[1]
    w1 = rng.integers(-127, 128, (3, c1))
    w1[:, 0::2] = rng.choice(np.array([-127, 127]), (3, (c1 + 1) // 2))
    rq = np.array(FOLD_EDGE_RQ1, np.int64)[np.arange(2 * c1) % len(FOLD_EDGE_RQ1)]
    tree.update(w1p=w1.astype(np.int8), m1=rq[:, 0].astype(np.int32),
                o1=rq[:, 1].astype(np.int32))
    x = (0.7 * rng.standard_normal((32, 2, T_IN))).astype(np.float32)
    acc2 = _v7_acc2(np.clip((_v7_acc1(x, tree["s_x"], tree["w1p"]) + tree["o1"])
                            >> tree["m1"], 0, 127), tree["w2p"]).reshape(-1, tree["m2"].shape[0])
    mid = np.median(acc2, axis=0)
    p75 = np.percentile(np.abs(acc2 - mid), 75, axis=0)
    tree["m2"] = np.ceil(np.log2(np.maximum(p75, 1) / 127)).clip(0, 30).astype(np.int32)
    tree["o2"] = (-mid).astype(np.int32)
    return tree


# conv2 as a pass-through of conv1's map: probe i's output channel co shows
# channel CONV1_PROBE_WIDTH * i + co % CONV1_PROBE_WIDTH of the map at tap 0
# (co < CONV1_PROBE_WIDTH: map row t is conv1 row t) or at tap 2 (the rest:
# conv1 row t + 2), so the probes' maps hold all 126 rows of the 512 channels.
CONV1_PROBE_WIDTH = 40


def conv1_probe_trees(tree: dict) -> list[tuple[dict, np.ndarray, np.ndarray]]:
    """(tree, channel, tap) per probe: ``tree`` with conv2 replaced by the
    pass-through above (weight 1, rq2 shift 0 and offset 0: conv1's map is
    in [0, 127] already), ``channel[co]`` the conv1 channel its output
    channel co shows (-1: none, a zero column) and ``tap[co]`` the tap."""
    k1, c2 = tree["w2p"].shape[0], tree["m2"].shape[0]
    probes = []
    for i in range(-(-k1 // CONV1_PROBE_WIDTH)):
        co = np.arange(c2)
        ch = CONV1_PROBE_WIDTH * i + co % CONV1_PROBE_WIDTH
        ch = np.where((ch < k1) & (co < 2 * CONV1_PROBE_WIDTH), ch, -1)
        tap = np.where(co < CONV1_PROBE_WIDTH, 0, 2)
        w2 = np.zeros((k1, 3 * c2), np.int8)
        live = ch >= 0
        w2[ch[live], tap[live] * c2 + co[live]] = 1
        probes.append((dict(tree, w2p=w2, m2=np.zeros(c2, np.int32),
                            o2=np.zeros(c2, np.int32)), ch, tap))
    return probes


def conv1_from_probe_maps(maps, probes) -> np.ndarray:
    """conv1's (B, 126, 512) map assembled from the probes' (B, 124, >= c2)
    conv maps (``conv1_probe_trees``' order)."""
    b, t2 = maps[0].shape[:2]
    k1 = probes[0][0]["w2p"].shape[0]
    a1 = np.full((b, t2 + 2, k1), -1, np.int16)
    for m, (_, ch, tap) in zip(maps, probes):
        for co in np.flatnonzero(ch >= 0):
            a1[:, tap[co]:tap[co] + t2, ch[co]] = m[:, :, co]
    return a1


OLD_CONV_BF16_SRC = os.path.join(_build.BUILD_DIR, "conv_stage_bf16_old.cu")
# Rows 15, 14 and 12 by wrapper: the weights their C entry takes after the
# input and B, in its order.
CONV_BF16_WEIGHTS = {"conv_stage_bf16_v4": ("w1e", "w2t", "b2"),
                     "conv_stage_bf16_v2": ("w1e", "w2t", "b2"),
                     "conv_stage_bf16": ("w1p", "b1", "w2t", "b2")}
CONV_BF16_ENTRIES = tuple(CONV_BF16_WEIGHTS)
# The bf16 conv maps against another computation of them (PERF.md section
# 2): every element within one bf16 ulp of the reference plus 1e-3 of its
# largest magnitude.
BF16_MAP_RTOL, BF16_MAP_ATOL_OF_MAX = 2.0 ** -7, 1e-3


def bf16_map_outside(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of the bf16 map ``got`` outside the tolerance of ``want``."""
    got, want = got.float(), want.float()
    bound = BF16_MAP_RTOL * want.abs() + BF16_MAP_ATOL_OF_MAX * float(want.abs().max())
    return int(((got - want).abs() > bound).sum())


def _old_conv_bf16(lib: ctypes.CDLL, name: str, inp: torch.Tensor, bw) -> torch.Tensor:
    """The old library's entry of the bf16 conv stage ``name`` on the
    package wrapper's arguments: the (B, 124, 80) bf16 map."""
    b = inp.shape[0]
    out = torch.empty((b, 124, 80), dtype=torch.bfloat16, device=inp.device)
    weights = (getattr(bw, k).data_ptr() for k in CONV_BF16_WEIGHTS[name])
    code = getattr(lib, f"amc_{name}")(inp.data_ptr(), b, *weights, out.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"old amc_{name} failed to launch: CUDA error {code}")
    return out


def conv_bf16_old_vs_new(lib: ctypes.CDLL, bw, batches=(4096, 2048, 16384)) -> list[dict]:
    """Rows 15, 14 and 12, the old body against the package's, on seeded
    frames (0.7 N(0, 1); row 14 on their tap rows) under the full-width
    weights ``bw``: each timed old, new, new, old (median of 5 runs of 20
    calls between CUDA events, then the profiler's device time per call,
    in the same order), beside ``torch.matmul`` on conv2's lane-packed
    product, (B*126, 512) x (512, 240) bf16 (a yardstick), in the same
    round. ``ok``: the new map within the bf16 map tolerance of the old."""
    from modulationdetectioncnn_torch.ops import infer_bf16 as ib
    from modulationdetectioncnn_torch.utils.profiler import device_ms_per_call
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    def ms(fn):
        return statistics.median(launch_ms_samples(fn))

    dev, w_cm = bw.w2t.device, bw.w2t.T
    recs = []
    for b in batches:
        x = 0.7 * _seeded((b, 2, T_IN), dev, seed=b)
        xe = ib.expand_taps_bf16(x)
        a1 = ib.conv1_bf16_plain(x, bw).reshape(-1, 512)
        mm = lambda: torch.matmul(a1, w_cm)  # noqa: E731
        lib_ms, lib_dev = ms(mm), device_ms_per_call(mm)
        for name in CONV_BF16_ENTRIES:
            inp = xe if name == "conv_stage_bf16_v2" else x
            new = lambda: getattr(ib, name)(inp, bw)  # noqa: E731
            old = lambda: _old_conv_bf16(lib, name, inp, bw)  # noqa: E731
            got, want = new(), old()
            outside = bf16_map_outside(got, want)
            times = [ms(old), ms(new), ms(new), ms(old)]
            dev_ms = [device_ms_per_call(f) for f in (old, new, new, old)]
            recs.append({"probe": "conv_bf16_old", "name": name, "batch": b,
                         "old_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                         "old_device_ms": [dev_ms[0], dev_ms[3]],
                         "new_device_ms": [dev_ms[1], dev_ms[2]],
                         "library_conv2_ms": lib_ms, "library_conv2_device_ms": lib_dev,
                         "outside_tolerance_vs_old": outside,
                         "bit_equal_share_vs_old": float((got == want).float().mean()),
                         "ok": outside == 0 and bool(torch.isfinite(got.float()).all())})
            del got, want
        del x, xe, a1
    return recs


def narrow_tree(seed: int) -> dict:
    """A narrow model's tree (conv1 32, conv2 16, dense 32, 2 classes: a
    seeded torch VT-CNN2 through the port's PTQ), which the carry pads to
    the kernels' widths."""
    from modulationdetectioncnn_torch.config import ModelConfig
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2
    from modulationdetectioncnn_torch.train.quant import quantize

    model = VTCNN2.from_config(
        ModelConfig(num_classes=2, conv1_filters=32, conv2_filters=16, dense_units=32),
        generator=torch.Generator().manual_seed(seed))
    calib = np.random.default_rng(seed + 1).standard_normal((256, 2, 128)).astype(np.float32)
    return quantize(model, calib).tree()


def _v7_acc1(x: np.ndarray, s_x, w1p: np.ndarray) -> np.ndarray:
    """golden/quant.py's conv1 sums, (B, 2, T) f32 -> (B, T-2, 2C) int64,
    channel h*C + c: the quantize (a rounded multiply by the f32
    reciprocal, ties to even), then the three taps."""
    inv = np.float32(1.0 / np.float64(np.float32(s_x)))
    xq = np.clip(np.rint(x.astype(np.float32) * inv), -127, 127).astype(np.int64)
    t1 = x.shape[-1] - 2
    acc = sum(xq[:, :, k:k + t1, None] * np.asarray(w1p, np.int64)[k] for k in range(3))
    return acc.transpose(0, 2, 1, 3).reshape(x.shape[0], t1, -1)


def _v7_acc2(a1: np.ndarray, w2p: np.ndarray) -> np.ndarray:
    """conv2's sums on an int (B, t1, 2C) map, (B, t1-2, C2) int64 (float64
    products are exact: every partial sum is below 2**53)."""
    c2, t2 = w2p.shape[1] // 3, a1.shape[1] - 2
    w = np.asarray(w2p, np.float64)
    return np.rint(sum(a1[:, k:k + t2].astype(np.float64) @ w[:, k * c2:(k + 1) * c2]
                       for k in range(3))).astype(np.int64)


def _rq_edge_offsets(acc0: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    """Per-channel offsets that put ``(acc0 + o) >> shift`` at -1, 0, 127 and
    128 in turn (channel j: target j // 4 % 4)."""
    targets = np.array([-1, 0, 127, 128], np.int64)[np.arange(acc0.size) // 4 % 4]
    return (targets * (np.int64(1) << shifts) - acc0).astype(np.int32)


def conv_v7_edge_cases(seed: int, b: int = 40) -> dict[str, tuple[dict, np.ndarray]]:
    """{kind: (model tree, (b, 2, 128) f32 frames)} for the v7 conv stage
    (row 1), from the committed artifact, the narrow model and a seed (b >=
    2). Each kind's frames go through its own weights:

    - ``half_ties``: s_x = 2^-4, so every product x * inv_sx is exact, and
      frames holding (k + 0.5) * s_x for k from -131 to 130 (every tie from
      -130.5 to 130.5, +-126.5 and +-127.5 among them) and +-300 * s_x
      (saturation) first, then seeded integers and halves in [-140, 140]:
      rint's ties to even decide the quantize;
    - ``max_sums``: every conv1 tap +127 and conv2 weight +-127 (even
      channels one sign per channel, odd ones a sign per weight), rq1
      shifts 0 / 4 / 8 with offset 0, rq2 shifts 17..20 with a rounding
      offset, and saturated frames (every sample +-127 after the quantize:
      all +, all -, alternating, a sign per plane, seeded signs), so conv1
      sums reach +-3 * 127^2 and conv2 sums +-1536 * 127^2 ~ 2.5e7;
    - ``rq_edges``: shifts 0, 20, 22, 23 (channel j: j % 4) and offsets
      that put ``(acc + o) >> m`` at -1, 0, 127 and 128 on frame 0's row 0,
      for rq1 and rq2 (the sums from the integer spec on these frames);
      with shifts >= 20 every row of a channel lands within one step of
      its target;
    - ``narrow``: ``narrow_tree(seed)``, which the carry pads to the
      kernels' widths;
    - ``fold_refused``: the artifact with conv1 offset 5 at 257, which is
      not bf16-exact: the v9/v10 fold refuses it, v7 runs it.

    The last three take seeded frames 0.7 N(0, 1).
    """
    from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, QuantizedModel

    rng = np.random.default_rng(seed)
    art = QuantizedModel.from_npz(DEFAULT_ARTIFACT).tree()

    def seeded():
        return (0.7 * rng.standard_normal((b, 2, 128))).astype(np.float32)

    # half_ties
    ties = dict(art, s_x=np.float32(2.0 ** -4))
    vals = np.concatenate([np.arange(-131, 131) + 0.5, [300.0, -300.0]])
    fill = rng.integers(-140, 141, b * 256 - vals.size) + 0.5 * rng.integers(0, 2, b * 256 - vals.size)
    x_ties = (np.concatenate([vals, fill]) * 2.0 ** -4).astype(np.float32).reshape(b, 2, 128)
    # max_sums
    sums = dict(art)
    c1, k1, c2 = art["w1p"].shape[1], art["w2p"].shape[0], art["m2"].shape[0]
    sums["w1p"] = np.full((3, c1), 127, np.int8)
    w2 = rng.choice(np.array([-127, 127], np.int8), size=(k1, 3, c2))
    w2[:, :, 0::2] = np.where(np.arange(c2)[0::2] // 2 % 2 == 0, 127, -127).astype(np.int8)
    sums["w2p"] = w2.reshape(k1, 3 * c2)
    sums["m1"] = np.array([0, 4, 8], np.int32)[np.arange(2 * c1) % 3]
    sums["o1"] = np.zeros(2 * c1, np.int32)
    sums["m2"] = (17 + np.arange(c2) % 4).astype(np.int32)
    sums["o2"] = (np.int32(1) << (sums["m2"] - 1)).astype(np.int32)
    sat = 300.0 * np.float32(art["s_x"])
    signs = rng.choice(np.array([-1.0, 1.0]), size=(b, 2, 128))
    signs[0::5] = 1.0
    signs[1::5] = -1.0
    signs[2::5] = np.where(np.arange(128) % 2 == 0, 1.0, -1.0)
    signs[3::5, 0], signs[3::5, 1] = 1.0, -1.0
    x_sums = (sat * signs).astype(np.float32)
    # rq_edges
    edges = dict(art)
    x_edges = seeded()
    m1 = np.array([0, 20, 22, 23], np.int32)[np.arange(2 * c1) % 4]
    acc1 = _v7_acc1(x_edges[:1], art["s_x"], art["w1p"])
    o1 = _rq_edge_offsets(acc1[0, 0], m1)
    a1 = np.clip((acc1 + o1) >> m1, 0, 127)
    m2 = np.array([0, 20, 22, 23], np.int32)[np.arange(c2) % 4]
    o2 = _rq_edge_offsets(_v7_acc2(a1, art["w2p"])[0, 0], m2)
    edges.update(m1=m1, o1=o1, m2=m2, o2=o2)
    # fold_refused
    refused = dict(art, o1=np.array(art["o1"]).copy())
    refused["o1"][5] = 257
    return {"half_ties": (ties, x_ties), "max_sums": (sums, x_sums),
            "rq_edges": (edges, x_edges), "narrow": (narrow_tree(seed), seeded()),
            "fold_refused": (refused, seeded())}


def dense_edge_cases(tree: dict, b: int, seed: int) -> dict[str, tuple[dict, np.ndarray]]:
    """{kind: (weight tree, (b, 9920) int8 map)} for the int8 dense stage,
    from a model's tree (``QuantizedModel.tree()``) and a seed:

    - ``saturated``: every map value 127; dense1's even units have every
      weight +127 or -127 (a sign per unit), the odd ones a sign per
      weight, so dense1 sums reach 9920 * 127 * 127 ~ 1.6e8 in magnitude;
    - ``full_range``: a seeded map over all of [0, 127], the model as is;
    - ``near_tie``: the same kind of map under a dense2 whose classes 3, 5
      and 7 share class 3's column and scale, 3 and 7 its bias, and 5 the
      next float above it; the other classes get zero weights and a bias of
      -3e38. Class 7 ties class 3 on every frame (the lowest index wins);
      class 5's logit is class 3's or the next float above, as the rounded
      add falls, so a fused multiply-add or another rounding flips labels.
    """
    rng = np.random.default_rng(seed)
    full = rng.integers(0, 128, (b, tree["w3"].shape[0]), dtype=np.int8)
    sat = dict(tree)
    signs = rng.choice(np.array([-127, 127], np.int8), size=tree["w3"].shape)
    signs[:, 0::2] = signs[0, 0::2]
    sat["w3"] = signs
    tie = dict(tree)
    w4 = np.array(tree["w4"], np.int8)
    s4, b4 = np.array(tree["s4"], np.float32), np.array(tree["b4"], np.float32)
    w4[:, 5] = w4[:, 7] = w4[:, 3]
    others = [c for c in range(w4.shape[1]) if c not in (3, 5, 7)]
    w4[:, others] = 0
    s4[[5, 7]] = s4[3]
    b4[7], b4[5] = b4[3], np.nextafter(b4[3], np.float32(np.inf))
    b4[others] = -3e38
    tie.update(w4=w4, s4=s4, b4=b4)
    return {"saturated": (sat, np.full_like(full, 127)), "full_range": (dict(tree), full),
            "near_tie": (tie, rng.integers(0, 128, full.shape, dtype=np.int8))}


def _round_bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def dense_bf16_edge_cases(params: dict, narrow: dict, b: int, seed: int
                          ) -> dict[str, tuple[dict, np.ndarray]]:
    """{kind: (Flax-layout tree, (b, 124, 80) map of bf16 values as float32)}
    for the bf16 dense stage (rows 13 and 16), from a full-width model's and
    a narrow model's Flax-layout trees (``models.vtcnn2.flax_params``, or a
    Flax init's ``params["params"]``) and a seed. Lanes past the model's
    conv2 filters are zero, as the padded conv stages write them:

    - ``large``: every map value in [2^50, 2^51]; dense1's even units have
      every weight +M or -M (a sign per unit), M the model's largest
      |weight| in bf16, the odd ones a sign per weight, so dense1 sums
      reach ~9920 * 2^51 * M in magnitude;
    - ``near_tie``: a seeded |N(0, 1)| map; dense1's units 0 and 1 read
      map element 0 and 1 alone (weight 1.0, bias 1.0), and dense2's
      classes 3, 5 and 7 read them alone, with weights 1.0 and 91 * 2^-15
      (so their sum keeps all 24 bits), biases 1 + 2^-23 for 3 and 7 and
      the next float above it for 5; the other classes get zero weights
      and a bias of -3e38. Those logits are exact but for their rounded
      adds (d1, the two products' sum, the bias), which no order of the
      sums changes: class 7 ties class 3 on every frame (the lowest index
      wins), and class 5's logit is class 3's or above it, as the bias's
      add rounds, so the labels are 3 or 5 by the last bit;
    - ``narrow``: a seeded |N(0, 1)| map in the narrow model's lanes under
      the narrow model (2 classes), which the packing pads to the kernels'
      widths.
    """
    rng = np.random.default_rng(seed)

    def copy(tree):
        return {layer: dict(v) for layer, v in tree.items()}

    def seeded_map(c2):
        h = np.zeros((b, 124, 80), np.float32)
        h[..., :c2] = np.abs(rng.standard_normal((b, 124, c2), np.float32))
        return _round_bf16(h)

    big = copy(params)
    w3 = np.asarray(params["Dense1"]["kernel"], np.float32)
    m = float(_round_bf16(np.array([np.abs(w3).max()]))[0])
    signs = rng.choice(np.array([-m, m], np.float32), size=w3.shape)
    signs[:, 0::2] = signs[0, 0::2]
    big["Dense1"]["kernel"] = signs
    large = _round_bf16(2.0 ** 50 * (1.0 + rng.random((b, 124, 80), np.float32)))
    tie = copy(params)
    w3k = np.array(params["Dense1"]["kernel"], np.float32)     # (9920, 256)
    b3 = np.array(params["Dense1"]["bias"], np.float32)
    w3k[:, :2] = 0.0
    w3k[0, 0] = w3k[1, 1] = b3[0] = b3[1] = 1.0
    w4 = np.zeros_like(np.asarray(params["Dense2"]["kernel"], np.float32))
    w4[0, [3, 5, 7]] = 1.0
    w4[1, [3, 5, 7]] = 91 * 2.0 ** -15
    b4 = np.full(w4.shape[1], -3e38, np.float32)
    b4[3] = b4[7] = np.float32(1.0 + 2.0 ** -23)
    b4[5] = np.nextafter(b4[3], np.float32(np.inf))
    tie["Dense1"] = {"kernel": w3k, "bias": b3}
    tie["Dense2"] = {"kernel": w4, "bias": b4}
    return {"large": (big, large), "near_tie": (tie, seeded_map(80)),
            "narrow": (copy(narrow), seeded_map(np.shape(narrow["Conv2"]["bias"])[0]))}


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


# Row 21's tau edges: both ends of the wrap to [-sps/2, sps/2), the
# rounding boundaries of tau_c * 32 next to them (x.5 goes to even), 0 and
# one period on: the integer delay d runs over 0 .. 8.
TIMING_TAU_EDGES = (-4.0, -4.0 + 1e-6, 4.0 - 1e-6, 4.0, 0.0, -1e-6, 8.0 - 1e-6, 8.0, 12.0,
                    -3.984375, 3.984375, 0.015625, -0.015625, 4.015625, 7.984375, 0.046875)
# Int32 offsets kept this far inside int32, so acc + offset cannot wrap
# (|acc| <= 3 * 128 * 128 < 2^16).
_RQ_OFFSET_LIMIT = (1 << 31) - (1 << 17)


def conv1_int8_edge_cases(seed: int, b: int, t: int, c: int
                          ) -> dict[str, tuple[np.ndarray, ...]]:
    """Row 19's edges as {kind: (x (b, 2, t) int8, w1p (3, c) int8, shift
    (2c,) int32, offset (2c,) int32)}, for any b, t >= 3 and c:

    - ``saturated``: frames of -128 alone, +127 alone, alternating -128 and
      +127, a sign per plane, then seeded extremes; taps all -128 on
      channels 0 mod 4, all +127 on 1 mod 4, a seeded mix of -128 and +127
      on the rest, so the sums reach +-3 * 128^2 and 3 * 127 * 128; shifts
      0 .. 31 (channel n: n % 32) with offset 0, so every shift meets sums
      of both signs at their largest;
    - ``clip_edges``: seeded frames and taps over all of int8 (-128 too),
      shifts 0 .. 31 and offsets that put ``(acc + o) >> shift`` at -1, 0,
      127 and 128 (channel n: n // 2 % 4) on frame 0's row 0 (clipped
      inside int32 where the shift is too large to reach them), with
      ``2^shift - 1`` added on odd channels, the other end of the floor.
    """
    r = np.random.default_rng(seed)
    n = np.arange(2 * c)
    shifts = (n % 32).astype(np.int32)
    # saturated
    ext = np.array([-128, 127], np.int8)
    xs = ext[r.integers(0, 2, (b, 2, t))]
    xs[0::5] = -128
    xs[1::5] = 127
    xs[2::5] = np.where(np.arange(t) % 2 == 0, -128, 127).astype(np.int8)
    xs[3::5, 0], xs[3::5, 1] = -128, 127
    ws = ext[r.integers(0, 2, (3, c))]
    ws[:, 0::4], ws[:, 1::4] = -128, 127
    sat = (xs, ws, shifts, np.zeros(2 * c, np.int32))
    # clip_edges
    xe = r.integers(-128, 128, (b, 2, t)).astype(np.int8)
    we = r.integers(-128, 128, (3, c)).astype(np.int8)
    acc0 = np.concatenate([xe[0, h, 0:3].astype(np.int64) @ we.astype(np.int64)
                           for h in range(2)])
    target = np.array([-1, 0, 127, 128], np.int64)[n // 2 % 4]
    sh = shifts.astype(np.int64)
    o = target * (np.int64(1) << sh) + (n % 2) * ((np.int64(1) << sh) - 1) - acc0
    o = np.clip(o, -_RQ_OFFSET_LIMIT, _RQ_OFFSET_LIMIT).astype(np.int32)
    return {"saturated": sat, "clip_edges": (xe, we, shifts, o)}


def _old_timing(lib: ctypes.CDLL, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The old library's timing FIR (``amc_correct_timing_fir``) on the
    package wrapper's arguments."""
    out = torch.empty_like(x)
    code = lib.amc_correct_timing_fir(x.data_ptr(), 2 * x.shape[0], x.shape[-1], c.data_ptr(),
                                      c.shape[1], out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"old amc_correct_timing_fir failed to launch: CUDA error {code}")
    return out


def timing_old_vs_new(lib: ctypes.CDLL, batches=(4096, 2048, 16384)) -> list[dict]:
    """Row 21, the old body against the package's, on seeded frames (N(0,
    1), T 128) with their own Oerder & Meyr filters (17 taps): each timed
    old, new, new, old (median of 5 runs of 20 calls between CUDA events,
    which time the host here, then the profiler's device time per call, in
    the same order), beside ``torch.matmul`` on the unfolded frames (a
    yardstick) in the same round. ``ok``: the outputs bit for bit."""
    import torch.nn.functional as F

    from modulationdetectioncnn_torch.config import StreamConfig
    from modulationdetectioncnn_torch.dsp import normalize
    from modulationdetectioncnn_torch.utils.profiler import device_ms_per_call
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    def ms(fn):
        return statistics.median(launch_ms_samples(fn))

    sc = StreamConfig()
    recs = []
    for b in batches:
        x = _seeded((b, 2, T_IN), "cuda", seed=b)
        c = normalize.timing_filters(normalize.estimate_timing(x, sc.sps), sc.sps,
                                     sc.timing_phases)
        taps = c.shape[1]
        xu = F.pad(x, ((taps - 1) // 2, (taps - 1) // 2)).unfold(-1, taps, 1)
        c4 = c[:, None, :, None]
        new = lambda: normalize.correct_timing_fir(x, c)  # noqa: E731
        old = lambda: _old_timing(lib, x, c)  # noqa: E731
        mm = lambda: torch.matmul(xu, c4)  # noqa: E731
        before = normalize.correct_timing_fir.route_launches["window"]
        got = new()
        route = "window" if normalize.correct_timing_fir.route_launches["window"] > before \
            else "general"
        differ = int((got != old()).sum())
        times = [ms(old), ms(new), ms(new), ms(old)]
        dev_ms = [device_ms_per_call(f) for f in (old, new, new, old)]
        recs.append({"probe": "timing_old", "name": "correct_timing_fir", "batch": b,
                     "new_route": route,
                     "old_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                     "old_device_ms": [dev_ms[0], dev_ms[3]],
                     "new_device_ms": [dev_ms[1], dev_ms[2]],
                     "library_ms": ms(mm), "library_device_ms": device_ms_per_call(mm),
                     "outputs_differing": differ, "ok": differ == 0})
        del x, c, xu
    return recs


def probe_timing_old() -> list[dict]:
    """Row 21 against an earlier body of ``csrc/correct_timing.cu`` (a copy
    at ``OLD_TIMING_SRC``)."""
    _header("timing_old")
    lib = old_library(OLD_TIMING_SRC, TIMING_ENTRIES)
    if lib is None:
        raise SystemExit(f"timing_old: no earlier body at {OLD_TIMING_SRC}")
    recs = timing_old_vs_new(lib)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


def conv1_int8_old_vs_new(lib: ctypes.CDLL, w1p: torch.Tensor, m1: torch.Tensor,
                          o1: torch.Tensor, inv_sx: float,
                          batches=(4096, 2048, 16384)) -> list[dict]:
    """Row 19, the old body (its ``amc_conv1_stacked_int8``) against the
    package's, on seeded frames (0.7 N(0, 1), T 128) quantized with
    ``inv_sx``, under conv1's int8 weights (w1p (3, C), shift and offset
    (2C,)): each timed old, new, new, old (median of 5 runs of 20 calls
    between CUDA events, then the profiler's device time per call, in the
    same order). ``ok``: the maps bit for bit."""
    from modulationdetectioncnn_torch.ops import cnn_kernels as ck
    from modulationdetectioncnn_torch.ops.requant import quantize_input
    from modulationdetectioncnn_torch.utils.profiler import device_ms_per_call
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    def ms(fn):
        return statistics.median(launch_ms_samples(fn))

    c = w1p.shape[1]

    def old_call(xq):
        b, _, t = xq.shape
        out = torch.empty((b, t - 2, 2 * c), dtype=torch.int8, device=xq.device)
        code = lib.amc_conv1_stacked_int8(xq.data_ptr(), b, t, c, w1p.data_ptr(),
                                          m1.data_ptr(), o1.data_ptr(), out.data_ptr(),
                                          torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"old amc_conv1_stacked_int8 failed to launch: CUDA error {code}")
        return out

    recs = []
    for b in batches:
        xq = quantize_input(0.7 * _seeded((b, 2, T_IN), w1p.device, seed=b), inv_sx)
        new = lambda: ck.conv1_stacked_int8(xq, w1p, m1, o1)  # noqa: E731
        old = lambda: old_call(xq)  # noqa: E731
        differ = int((new() != old()).sum())
        times = [ms(old), ms(new), ms(new), ms(old)]
        dev_ms = [device_ms_per_call(f) for f in (old, new, new, old)]
        recs.append({"probe": "conv1_int8_old", "name": "conv1_stacked_int8", "batch": b,
                     "new_route": ck.conv1_int8_route(T_IN, c),
                     "old_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                     "old_device_ms": [dev_ms[0], dev_ms[3]],
                     "new_device_ms": [dev_ms[1], dev_ms[2]],
                     "maps_differing": differ, "ok": differ == 0})
        del xq
    return recs


def probe_conv1_int8_old() -> list[dict]:
    """Row 19 against an earlier body of ``csrc/cnn_kernels.cu`` (a copy at
    ``OLD_CNN_SRC``) under the committed artifact's conv1."""
    from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, QuantizedModel, load_int8

    dev = _header("conv1_int8_old")
    lib = old_library(OLD_CNN_SRC, CNN_ENTRIES)
    if lib is None:
        raise SystemExit(f"conv1_int8_old: no earlier body at {OLD_CNN_SRC}")
    art = QuantizedModel.from_npz(DEFAULT_ARTIFACT)
    w1p, m1, o1 = (torch.from_numpy(np.asarray(getattr(art, k))).to(dev)
                   for k in ("w1p", "m1", "o1"))
    recs = conv1_int8_old_vs_new(lib, w1p, m1, o1, load_int8(device=dev).inv_sx)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


def _old_ms(fn) -> float:
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    return statistics.median(launch_ms_samples(fn))


def conv1_old_vs_new(lib: ctypes.CDLL, w1p: torch.Tensor, b1: torch.Tensor,
                     batches=(2048, 4096, 16384)) -> list[dict]:
    """Row 17, the old body (its ``amc_conv1_stacked``) against the
    package's, on seeded frames (N(0, 1), T 128) under the float conv1
    weights w1p (3, C) and b1 (C,), bf16 and float32 out: each timed old,
    new, new, old (median of 5 runs of 20 calls between CUDA events, then
    the profiler's device time per call, in the same order). ``ok``: the
    maps bit for bit."""
    from modulationdetectioncnn_torch.ops import cnn_kernels as ck
    from modulationdetectioncnn_torch.utils.profiler import device_ms_per_call

    c = w1p.shape[1]

    def old_call(x, out_dtype):
        b, _, t = x.shape
        out = torch.empty((b, t - 2, 2 * c), dtype=out_dtype, device=x.device)
        code = lib.amc_conv1_stacked(x.data_ptr(), b, t, c, w1p.data_ptr(), b1.data_ptr(),
                                     int(out_dtype == torch.float32), out.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"old amc_conv1_stacked failed to launch: CUDA error {code}")
        return out

    recs = []
    for b in batches:
        x = _seeded((b, 2, T_IN), w1p.device, seed=b)
        for out_dtype in (torch.bfloat16, torch.float32):
            new = lambda: ck.conv1_stacked(x, w1p, b1, out_dtype=out_dtype)  # noqa: E731
            old = lambda: old_call(x, out_dtype)  # noqa: E731
            differ = int((new() != old()).sum())
            times = [_old_ms(old), _old_ms(new), _old_ms(new), _old_ms(old)]
            dev_ms = [device_ms_per_call(f) for f in (old, new, new, old)]
            recs.append({"probe": "conv1_old", "name": "conv1_stacked", "batch": b,
                         "out_dtype": str(out_dtype)[6:],
                         "new_route": ck.conv1_route(T_IN, c, out_dtype),
                         "old_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                         "old_device_ms": [dev_ms[0], dev_ms[3]],
                         "new_device_ms": [dev_ms[1], dev_ms[2]],
                         "maps_differing": differ, "ok": differ == 0})
        del x
    return recs


def probe_conv1_old() -> list[dict]:
    """Row 17 against an earlier body of ``csrc/cnn_kernels.cu`` (a copy at
    ``OLD_CNN_SRC``) under the bench's seeded float model's conv1."""
    from modulationdetectioncnn_torch import bench
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.ops import cnn_kernels as ck

    dev = _header("conv1_old")
    lib = old_library(OLD_CNN_SRC, CNN_ENTRIES)
    if lib is None:
        raise SystemExit(f"conv1_old: no earlier body at {OLD_CNN_SRC}")
    model = bench._frames_and_model(AmcConfig(), 1)[2]
    w1p, b1 = ck.float_conv_weights(model.state_dict(), dev)[:2]
    recs = conv1_old_vs_new(lib, w1p, b1)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


COPY_ROW_BYTES = 16384          # probe_r3's (B, 16384) int8 intermediate


def copy_old_vs_new(lib: ctypes.CDLL, batches=(2048, 4096, 16384)) -> list[dict]:
    """Row 23, the old body (its ``amc_copy_bytes``) against the package's,
    on seeded (B, 16384) int8: each timed old, new, new, old (median of 5
    runs of 20 calls between CUDA events, then the profiler's device time
    per call, in the same order), beside ``Tensor.copy_`` into a
    preallocated tensor (a ``cudaMemcpyAsync``, the library call) timed
    the same way in the same round. ``ok``: both copies equal the input."""
    from modulationdetectioncnn_torch.ops import probe_kernels as pk
    from modulationdetectioncnn_torch.utils.profiler import device_ms_per_call

    def old_call(h):
        out = torch.empty_like(h)
        code = lib.amc_copy_bytes(h.data_ptr(), h.numel(), out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"old amc_copy_bytes failed to launch: CUDA error {code}")
        return out

    recs = []
    for b in batches:
        gen = torch.Generator(device="cuda").manual_seed(b)
        h = torch.randint(-128, 128, (b, COPY_ROW_BYTES), dtype=torch.int8, device="cuda",
                          generator=gen)
        dst = torch.empty_like(h)
        new = lambda: pk.copy_bytes(h)  # noqa: E731
        old = lambda: old_call(h)  # noqa: E731
        lib_call = lambda: dst.copy_(h)  # noqa: E731
        differ = int((new() != h).sum()) + int((old() != h).sum())
        times = [_old_ms(old), _old_ms(new), _old_ms(new), _old_ms(old)]
        dev_ms = [device_ms_per_call(f) for f in (old, new, new, old)]
        lib_dev = [device_ms_per_call(lib_call) for _ in range(2)]
        recs.append({"probe": "copy_old", "name": "copy_bytes", "batch": b,
                     "bytes_moved": 2 * h.numel(),
                     "old_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                     "old_device_ms": [dev_ms[0], dev_ms[3]],
                     "new_device_ms": [dev_ms[1], dev_ms[2]],
                     "library_ms": _old_ms(lib_call), "library_device_ms": lib_dev,
                     "bytes_differing": differ, "ok": differ == 0})
        del h, dst
    return recs


def probe_copy_old() -> list[dict]:
    """Row 23 against an earlier body of ``csrc/probe_kernels.cu`` (a copy
    at ``OLD_PROBE_SRC``)."""
    _header("copy_old")
    lib = old_library(OLD_PROBE_SRC, PROBE_ENTRIES)
    if lib is None:
        raise SystemExit(f"copy_old: no earlier body at {OLD_PROBE_SRC}")
    recs = copy_old_vs_new(lib)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


PROBES = {
    "ceil": probe_ceil,
    "stage": probe_stage,
    "dense": probe_dense,
    "dense_old": probe_dense_old,
    "dense_bf16_old": probe_dense_bf16_old,
    "conv2_old": probe_conv2_old,
    "conv2_maps": probe_conv2_maps,
    "conv1_int8_old": probe_conv1_int8_old,
    "conv1_old": probe_conv1_old,
    "copy_old": probe_copy_old,
    "timing_old": probe_timing_old,
    "conv_v7_old": probe_conv_v7_old,
    "conv_fold_old": probe_conv_fold_old,
    "conv_v5_old": probe_conv_v5_old,
    "conv_v6_old": probe_conv_v6_old,
    "conv_v3_old": probe_conv_v3_old,
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
