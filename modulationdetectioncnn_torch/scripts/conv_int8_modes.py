"""The int8 conv stages that build conv1 on the chip (rows 1 and 3 to 10 of
PERF.md's kernel table) on the card: a quick check of rows 3 to 10, and
diagnostic modes of rows 1 and 3.

  check  builds the package's kernels and prints ptxas's registers and
         spills for rows 1 and 3 to 10; holds rows 3 and 4 (v10, v9) to
         their plain version and to row 1's map (``chip_smoke.py::
         fold_stage_checks``: B = 1 .. 16384 on the artifact, a seeded
         model and the fold-edge model, conv1's whole map through conv2
         pass-throughs), and rows 5 and 10 (v5, v1) the same way
         (``chip_smoke.py::v5_stage_checks``: the artifact, a seeded model
         and row 1's edge models), and rows 6 and 7 (v6, v4) the same way
         on the tap planes of those frames and on random planes
         (``chip_smoke.py::v6_stage_checks``), and rows 8 and 9 (v3, v2)
         on their tap rows and on random rows
         (``chip_smoke.py::v3_stage_checks``); then, with an earlier body at
         ``probe.OLD_CONV_FOLD_SRC``, old, new, new, old beside row 1 and
         ``_int_mm`` (``probe.conv_fold_old_vs_new``), with one at
         ``probe.OLD_CONV_V5_SRC`` the same for rows 5 and 10
         (``probe.conv_v5_old_vs_new``), with one at
         ``probe.OLD_CONV_V6_SRC`` the same for rows 6 and 7 beside row 5
         too (``probe.conv_v6_old_vs_new``), with one at
         ``probe.OLD_CONV_V3_SRC`` the same for rows 8 and 9 beside row 6
         (``probe.conv_v3_old_vs_new``), and with one at
         ``probe.OLD_CONV_V7_SRC`` the same for row 1
         (``probe.conv_v7_old_vs_new``).
  sass   disassembles (``cuobjdump -sass``) the package's rows 1, 5 and 10,
         6 and 7, 3 and 4, 2 and 11, 17-20 (each instantiation; row 19's
         general route) and 21's general route and their earlier bodies at
         ``probe.OLD_CONV_V7_SRC``, ``probe.OLD_CONV_V5_SRC``,
         ``probe.OLD_CONV_V6_SRC``, ``probe.OLD_CONV_FOLD_SRC``,
         ``probe.OLD_DENSE_SRC``, ``probe.OLD_CNN_SRC`` and
         ``probe.OLD_TIMING_SRC`` (each built with the headers beside it)
         and reports, per kernel, whether the instructions are the same:
         an edit to a shared header that should leave a kernel's machine
         code as it was is held to that.
  modes  copies ``csrc/conv_stage_int8_v10.cu`` (row 3) and
         ``csrc/conv_stage_int8.cu`` with its producer's header
         ``csrc/conv1_producer_s8.cuh`` (row 1), each with the consumer
         role's header ``csrc/conv2_wgmma.cuh``, into ``_build/`` with parts
         taken out, builds each copy (one nvcc each, all started together) and
         times every mode of each row on the artifact's weights (CUDA
         events around 20 back-to-back launches, median of 5 runs), in
         the order of MODES and back, at B = 4096 and 16384: the whole
         body; products alone (the producers write no row); producers alone
         (no products); both without the epilogue (``no_tail``), also with
         no waits between the roles; without the producers' fence
         against the async proxy (alone too); and, for row 3, the
         producers' convert by ``cvt.rzi`` (``f2i``) instead of the f16
         pair, the producers alone with their convert or their products
         stood in for by a few xors, and a chunk's products issued four
         m-tiles at a time before their converts (``mma_first4``), and
         three other exact converts (``convert_*``, whole and producers
         alone), whose maps, with those of the other modes that keep the
         function, are held to the package kernel's first. A mode
         that drops the products or the epilogue keeps the sums alive
         through a store that never happens: ptxas drops a ``wgmma`` whose
         sums are unused.

One JSON line per record; the card's name and power limit first. Needs a
card (and nvcc); run from the repo root:

    python -m modulationdetectioncnn_torch.scripts.conv_int8_modes check sass modes
"""
from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

from modulationdetectioncnn_torch.ops import _build
from modulationdetectioncnn_torch.scripts import probe
from modulationdetectioncnn_torch.scripts.conv_bf16_modes import _frames, _out, _rep, _smoke

HEADER = "conv2_wgmma.cuh"
# row: (its source, the file that holds its producer, its C entries, the
# old-body runner that launches one)
ROWS = {"row3": ("conv_stage_int8_v10.cu", "conv_stage_int8_v10.cu", probe.CONV_FOLD_ENTRIES,
                 lambda lib, x, qw: probe._old_conv(lib, "conv_stage_int8_v10", x, qw)),
        "row1": ("conv_stage_int8.cu", "conv1_producer_s8.cuh", probe.CONV_V7_ENTRIES,
                 lambda lib, x, qw: probe._old_conv(lib, "conv_stage_int8_v7", x, qw))}
KERNELS = ("conv_stage_folded_kernel", "conv_stage_int8_v7_kernel", "conv_stage_int8_v5_kernel",
           "conv_stage_int8_v6_kernel", "conv_stage_int8_v3_kernel")
PIN = "    for (int i = 0; i < C2 / 2; ++i) pin(acc[i]);\n"
SINK = """    {
      int sink = 0;
#pragma unroll
      for (int i = 0; i < C2 / 2; ++i) sink += acc[i];
      if (sink == 0x12345678) out[threadIdx.x] = static_cast<int8_t>(sink);
    }
"""
F2I = """__device__ __forceinline__ uint32_t rq1_bytes(float d0, float d1, float d2, float d3) {
  const uint32_t p01 = __vimin_s16x2_relu(
      pack_s16(__float2int_rz(d1), __float2int_rz(d0)), 0x007F007Fu);
  const uint32_t p23 = __vimin_s16x2_relu(
      pack_s16(__float2int_rz(d3), __float2int_rz(d2)), 0x007F007Fu);
  return __byte_perm(p01, p23, 0x6420);
}
"""
# The producers' diagnostic stand-ins (their results are wrong): a word
# from the four sums by three xors, in place of the convert; the A and B
# registers xored into D, in place of the product.
NO_CONVERT = """__device__ __forceinline__ uint32_t rq1_bytes(float d0, float d1, float d2, float d3) {
  return __float_as_uint(d0) ^ __float_as_uint(d1) ^ __float_as_uint(d2) ^ __float_as_uint(d3);
}
"""
NO_MMA = """__device__ __forceinline__ void mma_fold(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  d[0] = __uint_as_float(a0 ^ b);
  d[1] = __uint_as_float(a1 ^ b);
  d[2] = __uint_as_float(a0 + b);
  d[3] = __uint_as_float(a1 + b);
}
"""
# A chunk's products four m-tiles at a time before their converts.
MMA_LOOP = """      for (int m = 0; m < M_TILES; ++m) {
        float d0[4], d1[4];
        mma_fold(d0, a[m][0], a[m][1], b[c][0]);
        mma_fold(d1, a[m][0], a[m][1], b[c][1]);
        *reinterpret_cast<uint32_t*>(st + 16 * m * WG_CHUNK) = rq1_bytes(d0[0], d0[1], d1[0], d1[1]);
        *reinterpret_cast<uint32_t*>(st + (16 * m + 8) * WG_CHUNK) =
            rq1_bytes(d0[2], d0[3], d1[2], d1[3]);
      }
"""
MMA_FIRST4 = """      for (int m0 = 0; m0 < M_TILES; m0 += 4) {
        float d[4][2][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_fold(d[u][j], a[m0 + u][0], a[m0 + u][1], b[c][j]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          *reinterpret_cast<uint32_t*>(st + 16 * (m0 + u) * WG_CHUNK) =
              rq1_bytes(d[u][0][0], d[u][0][1], d[u][1][0], d[u][1][1]);
          *reinterpret_cast<uint32_t*>(st + (16 * (m0 + u) + 8) * WG_CHUNK) =
              rq1_bytes(d[u][0][2], d[u][0][3], d[u][1][2], d[u][1][3]);
        }
      }
"""
# Other exact converts of four sums to rq1's bytes, timed against the
# kernel's (whose results they must equal): the f16 pair clamped by f16
# min/max to [1024, 1151] so each half's low byte is the answer (no DPX);
# the clamp and a magic add in f32 alone (2^23 rounded toward zero puts
# floor in the low byte); and f32's saturating multiply by 2^-7 (a clamp to
# [0, 128]) with 128 taken back to 127 in the packed word.
CONVERTS = {
    "h2": """__device__ __forceinline__ uint32_t rq1_bytes(float d0, float d1, float d2, float d3) {
  uint32_t p01, p23;
  asm("cvt.rz.f16x2.f32 %0, %1, %2;\\n" : "=r"(p01) : "f"(__fadd_rz(d1, 1024.0f)), "f"(__fadd_rz(d0, 1024.0f)));
  asm("cvt.rz.f16x2.f32 %0, %1, %2;\\n" : "=r"(p23) : "f"(__fadd_rz(d3, 1024.0f)), "f"(__fadd_rz(d2, 1024.0f)));
  asm("max.f16x2 %0, %0, %1;\\n" : "+r"(p01) : "r"(0x64006400u));
  asm("max.f16x2 %0, %0, %1;\\n" : "+r"(p23) : "r"(0x64006400u));
  asm("min.f16x2 %0, %0, %1;\\n" : "+r"(p01) : "r"(0x647F647Fu));
  asm("min.f16x2 %0, %0, %1;\\n" : "+r"(p23) : "r"(0x647F647Fu));
  return __byte_perm(p01, p23, 0x6420);
}
""",
    "fp32": """__device__ __forceinline__ uint32_t rq1_word(float d) {
  return __float_as_uint(__fadd_rz(fminf(fmaxf(d, 0.0f), 127.0f), 8388608.0f));
}
__device__ __forceinline__ uint32_t rq1_bytes(float d0, float d1, float d2, float d3) {
  return __byte_perm(__byte_perm(rq1_word(d0), rq1_word(d1), 0x0040),
                     __byte_perm(rq1_word(d2), rq1_word(d3), 0x0040), 0x5410);
}
""",
    "sat": """__device__ __forceinline__ uint32_t rq1_word(float d) {
  return __float_as_uint(__fadd_rz(__saturatef(d * 0.0078125f), 65536.0f));
}
__device__ __forceinline__ uint32_t rq1_bytes(float d0, float d1, float d2, float d3) {
  const uint32_t w = __byte_perm(__byte_perm(rq1_word(d0), rq1_word(d1), 0x0040),
                                 __byte_perm(rq1_word(d2), rq1_word(d3), 0x0040), 0x5410);
  return w - ((w >> 7) & 0x01010101u);
}
""",
}
PACK_S16 = """__device__ __forceinline__ uint32_t pack_s16(int hi, int lo) {
  uint32_t d;
  asm("cvt.pack.sat.s16.s32 %0, %1, %2;\\n" : "=r"(d) : "r"(hi), "r"(lo));
  return d;
}
"""


# Each edit takes (row, producer source, header source) and returns the pair.
def _no_tail(row, src, hdr):
    return src, _rep(hdr, PIN, PIN + SINK + "    continue;\n")


def _no_rows(row, src, hdr):
    if row == "row3":
        return _rep(src, "      for (int m = 0; m < M_TILES; ++m) {\n        float d0[4], d1[4];",
                    "      for (int m = 0; m < 0; ++m) {\n        float d0[4], d1[4];"), hdr
    return _rep(src, "      for (int q = 0; q < ROWS; ++q) {", "      for (int q = 0; q < 0; ++q) {"), hdr


def _no_products(row, src, hdr):
    return src, _rep(hdr, "      stage_products<C2>(acc, base + c * WG_STAGE + a_row0 * WG_CHUNK,\n"
                          "                         ws + 2 * c * (NB * 64));\n", "")


def _no_waits(row, src, hdr):
    return (_rep(src, "      mbar_wait(empty + 8 * c, (it & 1) ^ 1);\n", ""),
            _rep(hdr, "      mbar_wait(full + 8 * c, it & 1);\n", ""))


def _f2i(row, src, hdr):
    start = src.index("__device__ __forceinline__ uint32_t rq1_bytes(")
    end = src.index("}\n", start) + 2
    return src[:start] + PACK_S16 + F2I + src[end:], hdr


def _no_fence(row, src, hdr):
    return _rep(src, "      fence_proxy_async();   // these st.shared before wgmma's reads "
                     "(async proxy)\n", ""), hdr


def _convert(code):
    """An edit that puts ``code`` in place of the producers' rq1_bytes."""
    def edit(row, src, hdr):
        start = src.index("__device__ __forceinline__ uint32_t rq1_bytes(")
        end = src.index("}\n", start) + 2
        return src[:start] + code + src[end:], hdr
    return edit




def _no_mma(row, src, hdr):
    start = src.index("__device__ __forceinline__ void mma_fold(")
    end = src.index("}\n", start) + 2
    return src[:start] + NO_MMA + src[end:], hdr


def _mma_first4(row, src, hdr):
    return _rep(src, MMA_LOOP, MMA_FIRST4), hdr


def _both(*edits):
    def edit(row, src, hdr):
        for e in edits:
            src, hdr = e(row, src, hdr)
        return src, hdr
    return edit


MODES = {
    "whole": lambda row, src, hdr: (src, hdr),
    "products_alone": _both(_no_rows, _no_tail),
    "producers_alone": _both(_no_products, _no_tail),
    "no_tail": _no_tail,
    "no_waits_no_tail": _both(_no_waits, _no_tail),
    "no_fence": _no_fence,
    "producers_alone_no_fence": _both(_no_products, _no_tail, _no_fence),
    "f2i": _f2i,
    "producers_alone_no_convert": _both(_no_products, _no_tail, _convert(NO_CONVERT)),
    "producers_alone_no_mma": _both(_no_products, _no_tail, _no_mma),
    "mma_first4": _mma_first4,
    "producers_alone_mma_first4": _both(_no_products, _no_tail, _mma_first4),
    **{f"{pre}convert_{name}": _both(*pre_edits, _convert(code))
       for name, code in CONVERTS.items()
       for pre, pre_edits in (("", ()), ("producers_alone_", (_no_products, _no_tail)))},
}
# Row 1's producer has no convert, mma.sync or m-tile loop of its own.
ROW_MODES = {"row3": tuple(MODES), "row1": tuple(MODES)[:7]}


def _ptxas_of(log: str, kernels) -> list[str]:
    """ptxas's lines (registers, spills) for the entries whose mangled name
    holds one of ``kernels``."""
    keep, lines = False, []
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = any(k in ln for k in kernels)
        if keep:
            lines.append(ln.strip())
    return lines


def run_check() -> int:
    """The check above; returns the count of failures."""
    from modulationdetectioncnn_torch.quant import (
        DEFAULT_ARTIFACT, QuantizedModel, int8_weights_from_numpy, load_int8)

    res = _build.build(force=True)
    _out(ptxas=_ptxas_of(res["log"], KERNELS))
    smoke = _smoke()
    art = QuantizedModel.from_npz(DEFAULT_ARTIFACT)
    edge = probe.fold_edge_tree(smoke.SEED)
    weights = {"artifact": load_int8(device="cuda"),
               "seeded": smoke.random_weights(art, np.random.default_rng(smoke.SEED)),
               "fold_edge": int8_weights_from_numpy(edge, "cuda")}
    bad = 0
    x = _frames(max(smoke.FOLD_BATCHES), seed=1)
    recs = smoke.fold_stage_checks(weights, {"artifact": art.tree(), "fold_edge": edge}, x)
    recs += smoke.v5_stage_checks({k: weights[k] for k in ("artifact", "seeded")}, x)
    recs += smoke.v6_stage_checks({k: weights[k] for k in ("artifact", "seeded")}, x)
    recs += smoke.v3_stage_checks({k: weights[k] for k in ("artifact", "seeded")}, x)
    for rec in recs:
        bad += rec["mismatches"] + rec.get("maps_vs_v7", 0)
        _out(**rec)
    del x
    for src, entries, run in ((probe.OLD_CONV_FOLD_SRC, probe.CONV_FOLD_ENTRIES,
                               probe.conv_fold_old_vs_new),
                              (probe.OLD_CONV_V5_SRC, probe.CONV_V5_ENTRIES,
                               probe.conv_v5_old_vs_new),
                              (probe.OLD_CONV_V6_SRC, probe.CONV_V6_ENTRIES,
                               probe.conv_v6_old_vs_new),
                              (probe.OLD_CONV_V3_SRC, probe.CONV_V3_ENTRIES,
                               probe.conv_v3_old_vs_new),
                              (probe.OLD_CONV_V7_SRC, probe.CONV_V7_ENTRIES,
                               probe.conv_v7_old_vs_new)):
        lib = probe.old_library(src, entries)
        if lib is None:
            _out(skipped=f"no earlier body at {src}")
            continue
        for rec in run(lib, weights["artifact"]):
            bad += 0 if rec["ok"] else 1
            _out(**rec)
    _out(check_failures=bad)
    return bad


def _unit_free(name: str) -> str:
    """A mangled name without its anonymous namespace, which nvcc names
    after the source file (``_ZN<n>_GLOBAL__N__<id>_<file>_cu_<id>``...),
    so that a kernel compiled from a copy of a source keeps its name."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", name)
    return name[m.end(1) + int(m.group(1)):] if m else name


def _sass(lib_path: str) -> dict[str, list[str]]:
    """{mangled kernel name: its instructions} of the library ``lib_path``
    (``cuobjdump -sass``; addresses and encodings dropped)."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", ln)
        if name and m:
            funcs[name].append(" ".join(m.group(1).split()))
    return funcs


def run_sass() -> int:
    """The sass step above; returns the count of kernels whose code differs
    (0 when no earlier body is there)."""
    new = _sass(_build.build()["path"])
    differ = 0
    for src, entries, kernels in ((probe.OLD_CONV_V7_SRC, probe.CONV_V7_ENTRIES,
                                   ("conv_stage_int8_v7_kernel",)),
                                  (probe.OLD_CONV_V5_SRC, probe.CONV_V5_ENTRIES,
                                   ("conv_stage_int8_v5_kernel",)),
                                  (probe.OLD_CONV_V6_SRC, probe.CONV_V6_ENTRIES,
                                   ("conv_stage_int8_v6_kernel",)),
                                  (probe.OLD_CONV_FOLD_SRC, probe.CONV_FOLD_ENTRIES,
                                   ("conv_stage_folded_kernel",)),
                                  (probe.OLD_DENSE_SRC, probe.DENSE_ENTRIES,
                                   ("dense_argmax_int8_kernelILb1E",
                                    "dense_argmax_int8_kernelILb0E")),
                                  (probe.OLD_CNN_SRC, probe.CNN_ENTRIES,
                                   ("conv1_f32_kernel", "conv2_kernel", "conv2_wgmma_kernel",
                                    "conv2_ffma_kernel", "conv1_int8_kernel")),
                                  (probe.OLD_TIMING_SRC, probe.TIMING_ENTRIES,
                                   ("correct_timing_fir_kernel",))):
        lib = probe.old_library(src, entries)
        if lib is None:
            _out(skipped=f"no earlier body at {src}")
            continue
        old = _sass(lib._name)
        new_by = {_unit_free(n): v for n, v in new.items()}
        for k in kernels:
            for name in sorted(n for n in old if k in n):   # each instantiation
                a, b = old[name], new_by.get(_unit_free(name), [])
                same = a == b
                differ += 0 if same else 1
                _out(sass=_unit_free(name), old=os.path.relpath(src, _build.PKG_DIR),
                     instructions=[len(a), len(b)], identical=same,
                     first_difference=None if same else next(
                         (i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b))))
    return differ


def run_modes() -> None:
    from modulationdetectioncnn_torch.quant import load_int8
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    with open(os.path.join(_build.CSRC_DIR, HEADER)) as f:
        hdr = f.read()
    jobs = {}
    for row, (name, producer, entries, _) in ROWS.items():
        texts = {}
        for fname in (name, producer):
            with open(os.path.join(_build.CSRC_DIR, fname)) as f:
                texts[fname] = f.read()
        for mode in ROW_MODES[row]:
            out_dir = os.path.join(_build.BUILD_DIR, "int8_modes", f"{row}_{mode}")
            os.makedirs(out_dir, exist_ok=True)
            s, h = MODES[mode](row, texts[producer], hdr)
            path = os.path.join(out_dir, name)
            # The copy's includes resolve in its own directory first.
            for fname, text in {**texts, producer: s, HEADER: h}.items():
                with open(os.path.join(out_dir, fname), "w") as f:
                    f.write(text)
            so = path[:-3] + ".so"
            cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-shared",
                   "-o", so, path]
            jobs[(row, mode)] = (so, entries, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (row, mode), (so, entries, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {row} mode {mode}:\n{log[-3000:]}")
        _out(row=row, mode=mode, ptxas=_ptxas_of(log, KERNELS))
        lib = ctypes.CDLL(so)
        for name in entries:
            fn = getattr(lib, f"amc_{name}")
            fn.argtypes = _build._SIGNATURES[f"amc_{name}"]
            fn.restype = ctypes.c_int
        libs.setdefault(row, {})[mode] = lib
    qw = load_int8(device="cuda")
    # The modes that keep the function: their maps against the package's.
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.quant import int8_weights_from_numpy

    edge = int8_weights_from_numpy(probe.fold_edge_tree(_smoke().SEED), "cuda")
    x = _frames(4096, seed=3)
    for mode, lib in libs["row3"].items():
        if mode in ("whole", "f2i", "mma_first4") or mode.startswith("convert_"):
            differ = {w: int((ROWS["row3"][3](lib, x, q) != infer.conv_stage_int8_v10(x, q)).sum())
                      for w, q in (("artifact", qw), ("fold_edge", edge))}
            _out(row="row3", mode=mode, maps_differing_from_package=differ)
    for b in (4096, 16384):
        x = _frames(b, seed=b)
        for row, (_, _, _, run) in ROWS.items():
            order = list(libs[row]) + list(reversed(list(libs[row])))
            ms = {}
            for mode in order:
                ms.setdefault(mode, []).append(statistics.median(launch_ms_samples(
                    lambda: run(libs[row][mode], x, qw))))
            _out(batch=b, row=row, ms=ms)


def main(argv: list[str] | None = None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or ["check"]
    unknown = [n for n in names if n not in ("check", "sass", "modes")]
    if unknown:
        raise SystemExit(f"unknown step(s) {unknown}; use check, sass, modes")
    if not torch.cuda.is_available():
        raise SystemExit("conv_int8_modes needs a CUDA card")
    _build.load_library()
    _out(card=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    failures = 0
    with torch.no_grad():
        if "check" in names:
            failures = run_check()
        if "sass" in names:
            failures += run_sass()
        if "modes" in names:
            run_modes()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
