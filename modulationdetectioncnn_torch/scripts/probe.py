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
  conv2_old rows 18 (bf16, float32) and 20 against an earlier body of
            ``csrc/cnn_kernels.cu`` (a copy at ``OLD_CNN_SRC``) the same way,
            beside the library call on conv2's z
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
their plain versions to against the JAX package's golden chain.
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
OLD_CNN_SRC = os.path.join(_build.BUILD_DIR, "cnn_kernels_old.cu")
CNN_ENTRIES = ("conv2_stacked", "conv2_stacked_int8")


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


def _old_dense(lib: ctypes.CDLL, name: str, h: torch.Tensor, qw) -> torch.Tensor:
    """``name``'s entry of the old library on the package wrapper's
    arguments (labels or logits)."""
    b = h.shape[0]
    out = (torch.empty((b, 11), dtype=torch.float32, device=h.device)
           if name == "dense_int8" else torch.empty((b,), dtype=torch.int32, device=h.device))
    weights = (qw.w3t, qw.m3, qw.o3, qw.w4, qw.s4, qw.b4)
    code = getattr(lib, f"amc_{name}")(h.data_ptr(), b, *(t.data_ptr() for t in weights),
                                       out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"old amc_{name} failed to launch: CUDA error {code}")
    return out


def dense_old_vs_new(lib: ctypes.CDLL, qw, batches=(4096, 2048, 16384)) -> list[dict]:
    """Rows 2 and 11, the old body against the package's, on seeded [0, 127]
    maps: each timed old, new, new, old (median of 5 runs of 20 calls each
    between CUDA events, then the profiler's device time per call, in the
    same order), their outputs compared bit for bit, and dense1 alone by
    ``torch._int_mm`` (a yardstick) in the same round."""
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.utils.profiler import device_ms_per_call
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    def ms(fn):
        return statistics.median(launch_ms_samples(fn))

    recs = []
    for b in batches:
        h = _seeded((b, 124 * 80), qw.w3t.device, 0, 128, np.int8, seed=b)
        for name in DENSE_ENTRIES:
            new = lambda: getattr(infer, name)(h, qw)  # noqa: E731
            old = lambda: _old_dense(lib, name, h, qw)  # noqa: E731
            got, want = new(), old()
            differ = int((got != want).sum())
            mm = lambda: torch._int_mm(h, qw.w3t.T)  # noqa: E731
            times = [ms(old), ms(new), ms(new), ms(old)]
            dev = [device_ms_per_call(f) for f in (old, new, new, old)]
            rec = {"probe": "dense_old", "name": name, "batch": b,
                   "old_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
                   "old_device_ms": [dev[0], dev[3]], "new_device_ms": [dev[1], dev[2]],
                   "int_mm_dense1_ms": ms(mm), "int_mm_dense1_device_ms": device_ms_per_call(mm),
                   "outputs_differing": differ}
            recs.append(rec)
    return recs


def probe_dense_old() -> list[dict]:
    _header("dense_old")
    lib = old_library(OLD_DENSE_SRC, DENSE_ENTRIES)
    if lib is None:
        raise SystemExit(f"dense_old: no earlier body at {OLD_DENSE_SRC}")
    qw, _ = _weights()
    recs = dense_old_vs_new(lib, qw)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


def _old_conv2(lib: ctypes.CDLL, a1s: torch.Tensor, w2p: torch.Tensor, *rest) -> torch.Tensor:
    """The old library's conv2 on the package wrapper's arguments: ``rest``
    is (b2, out dtype) for the float modes, (shift, offset) for int8."""
    b, t, k = a1s.shape
    co = w2p.shape[1] // 3
    stream = torch.cuda.current_stream().cuda_stream
    vec = int(k * a1s.element_size() % 16 == 0 and a1s.data_ptr() % 16 == 0)
    if a1s.dtype == torch.int8:
        out = torch.empty((b, t - 2, co), dtype=torch.int8, device=a1s.device)
        code = lib.amc_conv2_stacked_int8(a1s.data_ptr(), b, t, k, co, w2p.data_ptr(),
                                          rest[0].data_ptr(), rest[1].data_ptr(), vec,
                                          out.data_ptr(), stream)
    else:
        out = torch.empty((b, t - 2, co), dtype=rest[1], device=a1s.device)
        code = lib.amc_conv2_stacked(a1s.data_ptr(), b, t, k, co, w2p.data_ptr(),
                                     rest[0].data_ptr(), int(a1s.dtype == torch.float32),
                                     int(rest[1] == torch.float32), vec, out.data_ptr(), stream)
    if code != 0:
        raise RuntimeError(f"old conv2 failed to launch: CUDA error {code}")
    return out


def conv2_old_vs_new(lib: ctypes.CDLL, w2p: torch.Tensor, b2: torch.Tensor, w2p_i8: torch.Tensor,
                     m2: torch.Tensor, o2: torch.Tensor,
                     batches=(4096, 2048, 16384)) -> list[dict]:
    """Rows 18 (bf16 and float32) and 20, the old body against the
    package's, on seeded (B, 126, 512) maps under the given weights (float
    w2p (512, 240), b2 (80,); int8 w2p, shift, offset): each timed old, new,
    new, old (median of 5 runs of back-to-back calls between CUDA events,
    then the profiler's device time per call, in the same order), beside
    the library call on conv2's z in the same round. ``differing`` counts
    output elements outside the row's tolerance against the old body: int8
    bit for bit, bf16 one bf16 ulp plus 1e-3 of the map's largest
    magnitude, float32 1e-5 of it."""
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
            ("conv2_stacked bf16", lambda: ck.conv2_stacked(ab, w2b, b2),
             lambda: _old_conv2(lib, ab, w2b, b2, torch.bfloat16),
             lambda: torch.matmul(ab.reshape(-1, 512), w2b), (2.0 ** -7, 1e-3), 20),
            ("conv2_stacked float32",
             lambda: ck.conv2_stacked(af, w2p, b2, out_dtype=torch.float32),
             lambda: _old_conv2(lib, af, w2p, b2, torch.float32),
             lambda: torch.matmul(af.reshape(-1, 512), w2p), (0.0, 1e-5), 5),
            ("conv2_stacked_int8", lambda: ck.conv2_stacked_int8(ai, w2p_i8, m2, o2),
             lambda: _old_conv2(lib, ai, w2p_i8, m2, o2),
             lambda: torch._int_mm(ai.reshape(-1, 512), w2i_cm), (0.0, 0.0), 20))
        for name, new, old, library, (rtol, atol_of_max), iters in cases:
            got, want = new(), old()
            g, w = got.double(), want.double()
            bound = rtol * w.abs() + atol_of_max * float(w.abs().max())
            differ = int(((g - w).abs() > bound).sum())
            times = [ms(old, iters), ms(new, iters), ms(new, iters), ms(old, iters)]
            dev_ms = [device_ms_per_call(f, iters) for f in (old, new, new, old)]
            recs.append({"probe": "conv2_old", "name": name, "batch": b,
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
    "dense_old": probe_dense_old,
    "conv2_old": probe_conv2_old,
    "conv2_maps": probe_conv2_maps,
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
