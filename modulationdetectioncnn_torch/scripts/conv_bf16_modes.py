"""The bf16 conv stages (rows 15, 14 and 12 of PERF.md's kernel table) on the
card: a quick check, and diagnostic modes of their kernel body.

  check  builds the package's kernels, holds the three stages to their
         plain versions (the bf16 map tolerance of ``probe.bf16_map_outside``)
         at B = 1, 2, 65, 66, 67, 131, 133, 4095, 4096, 4097 on the bench's
         seeded model and, at B = 1, 67, 4097, on the float checkpoint and a
         narrow model, conv1 bit for bit through probe weights
         (``chip_smoke.py::conv1_probe_mismatches``), the v2 map equal to
         v4's and the same 2048 frames' map equal at B = 2048, 4096 and
         16384; then, with an earlier body at ``probe.OLD_CONV_BF16_SRC``,
         old, new, new, old (``probe.conv_bf16_old_vs_new``).
  modes  copies ``csrc/conv_stage_bf16_v4.cu`` into ``_build/`` with parts
         taken out, builds each copy (one nvcc each, all started together)
         and times every mode of each stage (CUDA events around 20
         back-to-back launches, median of 5 runs; launches are far longer
         than the host's time to issue them), in the order of MODES and
         back, at B = 4096 and 16384: the whole
         body; products alone (the producers write no row); producers alone
         (no products); both without the pair sum and the epilogue
         (``no_tail``), also with no waits between the roles; without the
         pair sum; a frame's windows held in registers; 16 rows' windows
         loaded at once. A mode that drops the products' sums keeps them
         alive through a store that never happens: ptxas drops a ``wgmma``
         whose sums are unused.

One JSON line per record; the card's name and power limit first. Needs a
card (and nvcc); run from the repo root:

    python -m modulationdetectioncnn_torch.scripts.conv_bf16_modes check modes
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

from modulationdetectioncnn_torch.ops import _build
from modulationdetectioncnn_torch.scripts import probe

STAGES = (("conv_stage_bf16_v4", False), ("conv_stage_bf16_v2", True),
          ("conv_stage_bf16", False))
PIN = "      for (int i = 0; i < C2 / 2; ++i) pin(acc[i]);\n"
SINK = """      {
        float sink = 0.0f;
#pragma unroll
        for (int i = 0; i < C2 / 2; ++i) sink += acc[i];
        if (sink == 1.2345e-30f) out[tid] = __float2bfloat16_rn(sink);
      }
"""


def _out(**rec) -> None:
    print(json.dumps(rec), flush=True)


def _rep(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"the kernel source no longer holds {old.strip()!r}")
    return src.replace(old, new)


def _no_tail(s):
    return _rep(s, PIN, PIN + SINK + "      continue;\n")


def _no_rows(s):
    return _rep(s, "      for (int q0 = 0; q0 < ROWS; q0 += GROUP) {",
                "      for (int q0 = 0; q0 < 0; q0 += GROUP) {")


def _no_products(s):
    return _rep(s, "        stage_products<C2>(acc, base + c * WG_STAGE + wg * 64 * WG_CHUNK,\n"
                   "                           ws + 2 * c * (NB * 64));\n", "")


def _no_waits(s):
    s = _rep(s, "        mbar_wait(full + 8 * c, it & 1);\n", "")
    return _rep(s, "      mbar_wait(empty + 8 * c, (it & 1) ^ 1);\n", "")


def _no_pair(s):
    s = _rep(s, "        mbar_wait_cluster(recv_empty, (it & 1) ^ 1);"
                "   // the peer has read the last one\n", "        continue;\n")
    s = _rep(s, "      if (issuer) mbar_expect_tx(recv_full, RECV_BYTES);\n", "")
    return _rep(s, "      mbar_wait_cluster(recv_full, it & 1);\n", "")


def _windows_in_registers(s):
    line = "    if (f + step < n && pt < T1) next.load(in, f + step, h, pt);   // in flight meanwhile\n"
    s = _rep(s, line, line + "    float4 xall[ROWS];\n#pragma unroll\n"
             "    for (int q = 0; q < ROWS; ++q) xall[q] = wb[p + PRODUCERS * q];\n")
    return _rep(s, "        for (int u = 0; u < GROUP; ++u) x[u] = wb[p + PRODUCERS * (q0 + u)];",
                "        for (int u = 0; u < GROUP; ++u) x[u] = xall[q0 + u];")


MODES = {
    "whole": lambda s: s,
    "windows_in_registers": _windows_in_registers,
    "group16": lambda s: _rep(s, "constexpr int GROUP = 8; ", "constexpr int GROUP = 16; "),
    "products_alone": lambda s: _no_tail(_no_rows(s)),
    "producers_alone": lambda s: _no_tail(_no_products(s)),
    "no_tail": _no_tail,
    "no_waits_no_tail": lambda s: _no_tail(_no_waits(s)),
    "no_pair": _no_pair,
}


def _frames(b: int, seed: int = 0) -> torch.Tensor:
    x = 0.7 * np.random.default_rng(seed).standard_normal((b, 2, 128))
    return torch.from_numpy(x.astype(np.float32)).cuda()


def _smoke():
    """The repo root's chip_smoke.py, for its weight sets and conv1 probe."""
    root = os.path.dirname(_build.PKG_DIR)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def run_check() -> int:
    """The check above; returns the count of failures."""
    from modulationdetectioncnn_torch.ops import infer_bf16 as ib

    smoke = _smoke()
    sets = smoke.bf16_weight_sets()
    x_all = _frames(16384)
    bad = 0
    plans = [("bench_seeded", (1, 2, 65, 66, 67, 131, 133, 4095, 4096, 4097)),
             ("float_checkpoint", (1, 67, 4097)), ("narrow_c32_c16_d32_nc2", (1, 67, 4097))]
    for wname, batches in plans:
        bw = ib.make_bf16_weights(sets[wname], "cuda")
        for b in batches:
            x = x_all[:b]
            xe = ib.expand_taps_bf16(x)
            maps = {}
            for name, rows in STAGES:
                inp = xe if rows else x
                got = getattr(ib, name)(inp, bw)
                torch.cuda.synchronize()
                want = getattr(ib, f"{name}_plain")(inp, bw)[..., :bw.c2]
                outside = probe.bf16_map_outside(got, want)
                bad += outside
                maps[name] = got
                _out(weights=wname, batch=b, stage=name, outside_tolerance=outside,
                     max_abs_diff=float((got.float() - want.float()).abs().max()),
                     bit_equal_share=float((got == want).float().mean()))
            v2_vs_v4 = int((maps["conv_stage_bf16_v2"] != maps["conv_stage_bf16_v4"]).sum())
            bad += v2_vs_v4
            _out(weights=wname, batch=b, v2_map_vs_v4_map=v2_vs_v4)
        mism = smoke.conv1_probe_mismatches(x_all[3:40], bw)
        bad += sum(mism.values())
        _out(weights=wname, conv1_probe_mismatches=mism)
    bw = ib.make_bf16_weights(sets["bench_seeded"], "cuda")
    for name, rows in STAGES:
        inp = ib.expand_taps_bf16(x_all) if rows else x_all
        first = {b: getattr(ib, name)(inp[:b], bw)[:2048] for b in (2048, 4096, 16384)}
        differ = [int((first[b] != first[2048]).sum()) for b in (4096, 16384)]
        bad += sum(differ)
        _out(stage=name, first_2048_frames_differing_at_b4096_b16384=differ)
    lib = probe.old_library(probe.OLD_CONV_BF16_SRC, probe.CONV_BF16_ENTRIES)
    if lib is None:
        _out(skipped=f"no earlier body at {probe.OLD_CONV_BF16_SRC}")
    else:
        for rec in probe.conv_bf16_old_vs_new(lib, bw):
            bad += 0 if rec["ok"] else 1
            _out(**rec)
    _out(check_failures=bad)
    return bad


def run_modes() -> None:
    from modulationdetectioncnn_torch.ops import infer_bf16 as ib
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    with open(os.path.join(_build.CSRC_DIR, "conv_stage_bf16_v4.cu")) as f:
        src = f.read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    jobs = {}
    for mode, edit in MODES.items():
        path = os.path.join(_build.BUILD_DIR, f"conv_bf16_mode_{mode}.cu")
        with open(path, "w") as f:
            f.write(edit(src))
        so = path[:-3] + ".so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-shared", "-o",
               so, path]
        jobs[mode] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for mode, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for mode {mode}:\n{log[-3000:]}")
        _out(mode=mode, ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln])
        lib = ctypes.CDLL(so)
        for name in probe.CONV_BF16_ENTRIES:
            fn = getattr(lib, f"amc_{name}")
            fn.argtypes = _build._SIGNATURES[f"amc_{name}"]
            fn.restype = ctypes.c_int
        libs[mode] = lib
    bw = ib.make_bf16_weights(_smoke().bf16_weight_sets()["bench_seeded"], "cuda")
    order = list(libs) + list(reversed(list(libs)))
    for b in (4096, 16384):
        x = _frames(b, seed=b)
        xe = ib.expand_taps_bf16(x)
        for name, rows in STAGES:
            inp = xe if rows else x
            ms = {}
            for mode in order:
                ms.setdefault(mode, []).append(statistics.median(launch_ms_samples(
                    lambda: probe._old_conv_bf16(libs[mode], name, inp, bw))))
            _out(batch=b, stage=name, ms=ms)


def main(argv: list[str] | None = None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or ["check"]
    unknown = [n for n in names if n not in ("check", "modes")]
    if unknown:
        raise SystemExit(f"unknown step(s) {unknown}; use check, modes")
    if not torch.cuda.is_available():
        raise SystemExit("conv_bf16_modes needs a CUDA card")
    _build.load_library()
    _out(card=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    failures = 0
    with torch.no_grad():
        if "check" in names:
            failures = run_check()
        if "modes" in names:
            run_modes()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
