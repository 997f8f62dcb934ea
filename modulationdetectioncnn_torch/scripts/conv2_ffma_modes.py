"""Row 18's float32 form on the card (the FFMA route of ``conv2_stacked``,
``amc_conv2_stacked_ffma`` in ``csrc/cnn_kernels.cu``): a quick check, and
diagnostic modes of its body.

  check  builds the package's kernels, prints ptxas's registers and spills
         for the FFMA body, and holds ``conv2_stacked`` (float32 in, float32
         and bf16 out) to its plain version (float32: 1e-5 of the map's
         largest magnitude; bf16: one bf16 ulp plus 1e-3 of it) at the
         default widths for B = 1, 37, 133, 4096, 4097 and at odd widths
         (T 300 / K 96 / Co 100, two channel tiles; T 302, three row tiles;
         K 200; K 1024; K 4 / Co 4; T 131 / K 36 / Co 44; Co 164, three
         channel tiles), each launch on the FFMA route.
  modes  copies ``csrc/cnn_kernels.cu`` into ``_build/`` with parts of the
         FFMA body changed, builds each copy (one nvcc each, all started
         together) and times every mode (CUDA events around back-to-back
         launches, median of 5 runs), in the order of MODES and back, at
         B = 4096 and 16384, beside ``torch.matmul`` f32's z (TF32 off) in
         the same round: the whole body; the weights loaded once a stage
         (every chunk reuses the stage's first 4 rows): all of them, the
         16-byte loads alone, the 4-byte loads alone; the map's rows loaded
         once a chunk (every run of rows reuses the first); both; no waits
         for a stage's data; the chunk loop not unrolled. Every mode but the
         whole body and ``unroll1`` computes wrong sums on purpose. Then
         the SM clock and the power, sampled by nvidia-smi while the whole
         body runs for ~3 s at B = 16384.

One JSON line per record; the card's name and power limit first. Needs a
card (and nvcc); run from the repo root:

    python -m modulationdetectioncnn_torch.scripts.conv2_ffma_modes check modes
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from modulationdetectioncnn_torch.ops import _build

ENTRY = "amc_conv2_stacked_ffma"
# (B, T, K, Co) the check runs; the first five at the default widths.
CHECK_SHAPES = ((1, 128, 512, 80), (37, 128, 512, 80), (133, 128, 512, 80),
                (4096, 128, 512, 80), (4097, 128, 512, 80), (5, 300, 96, 100),
                (5, 302, 512, 80), (7, 40, 200, 80), (3, 130, 1024, 80), (3, 9, 4, 4),
                (2, 131, 36, 44), (3, 200, 512, 164))


def _out(**rec) -> None:
    print(json.dumps(rec), flush=True)


def _rep(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"the kernel source does not hold exactly one {old.strip()!r}")
    return src.replace(old, new)


CALL = "ff_load_weights(wj, w_st + j4 * FF_W_ROWS4, n);"
QUAD = "w.quad[q][k] = *reinterpret_cast<const float4*>(p + 16 * n);"
ONE = "w.one[q][k] = *reinterpret_cast<const float*>(p + 4 * (64 + n));"


def _first_rows(src: str, quad: bool, one: bool) -> str:
    """The weight loads of the chosen kinds read the stage's first 4 rows
    for every chunk, so ptxas takes them out of the chunk loop."""
    src = _rep(src, "void ff_load_weights(FfWeights& w, const uint8_t* w_j, int n) {",
               "void ff_load_weights(FfWeights& w, const uint8_t* w_j, int n, const uint8_t* w_0) {")
    src = _rep(src, CALL, CALL.replace("n);", "n, w_st);"))
    if quad:
        src = _rep(src, QUAD, QUAD.replace("(p + 16 * n)", "(p - (w_j - w_0) + 16 * n)"))
    if one:
        src = _rep(src, ONE, ONE.replace("(p + 4 * (64 + n))", "(p - (w_j - w_0) + 4 * (64 + n))"))
    return src


def _map_once(src: str) -> str:
    return _rep(src, "m * 8 * P * WG_CHUNK));", "0 * WG_CHUNK));")


def _no_waits(src: str) -> str:
    return _rep(src, "      mbar_wait(full + 8 * s, (it / FF_STAGES) & 1);\n"
                     "      const uint8_t* a_st", "      const uint8_t* a_st")


MODES = {
    "whole": lambda s: s,
    "weights_once": lambda s: _first_rows(s, True, True),
    "quads_once": lambda s: _first_rows(s, True, False),
    "ones_once": lambda s: _first_rows(s, False, True),
    "map_once": _map_once,
    "loads_once": lambda s: _map_once(_first_rows(s, True, True)),
    "no_waits": _no_waits,
    "unroll1": lambda s: _rep(s, "#pragma unroll 2\n      for (int j4", "#pragma unroll 1\n      for (int j4"),
}


def _seeded(shape, seed: int, scale: float = 1.0, magnitude: bool = False) -> torch.Tensor:
    a = np.random.default_rng(seed).standard_normal(shape)
    a = np.abs(a) if magnitude else a
    return torch.from_numpy((scale * a).astype(np.float32)).cuda()


def _ptxas(log: str) -> list[str]:
    lines = log.splitlines()
    keep = []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and "conv2_ffma_kernel" in ln:
            keep += [s.strip() for s in lines[i + 1:i + 4] if "registers" in s or "spill" in s]
    return keep


def run_check() -> int:
    """The check above; returns the count of failures."""
    from modulationdetectioncnn_torch.ops import cnn_kernels as ck

    _out(ptxas_conv2_ffma=_ptxas(_build.build(force=True)["log"]))
    bad = 0
    for i, (b, t, k, co) in enumerate(CHECK_SHAPES):
        a1s = _seeded((b, t, k), 10 + i, magnitude=True)
        w2p = _seeded((k, 3 * co), 40 + i, 1.0 / np.sqrt(3 * k))
        b2 = _seeded((co,), 70 + i, 0.1)
        for out in (torch.float32, torch.bfloat16):
            ck.reset_launch_counts()
            got = ck.conv2_stacked(a1s, w2p, b2, out_dtype=out)
            want = ck.conv2_stacked_plain(a1s, w2p, b2, out)
            torch.cuda.synchronize()
            g, w = got.double(), want.double()
            top = float(w.abs().max())
            tol = 1e-5 * top if out == torch.float32 else 2.0 ** -7 * w.abs() + 1e-3 * top
            outside = int(((g - w).abs() > tol).sum())
            route = ck.route_launch_counts()["conv2_stacked"]
            bad += outside + (route["ffma"] != 1)
            _out(shape=[b, t, k, co], out=str(out)[6:], route=route, outside_tolerance=outside,
                 max_abs_err_of_max=float((g - w).abs().max()) / max(top, 1e-30))
    _out(check_failures=bad)
    return bad


def run_modes() -> None:
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    with open(os.path.join(_build.CSRC_DIR, "cnn_kernels.cu")) as f:
        src = f.read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    jobs = {}
    for mode, edit in MODES.items():
        path = os.path.join(_build.BUILD_DIR, f"conv2_ffma_mode_{mode}.cu")
        with open(path, "w") as f:
            f.write(edit(src))
        so = path[:-3] + ".so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-shared", "-o",
               so, path]
        jobs[mode] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    fns = {}
    for mode, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for mode {mode}:\n{log[-3000:]}")
        _out(mode=mode, ptxas=_ptxas(log))
        fn = getattr(ctypes.CDLL(so), ENTRY)
        fn.argtypes = _build._SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        fns[mode] = fn
    w2p = _seeded((512, 240), 7, 1.0 / np.sqrt(1536))
    b2 = _seeded((80,), 8, 0.1)
    order = list(fns) + list(reversed(list(fns)))
    for b in (4096, 16384):
        a1s = _seeded((b, 126, 512), b, magnitude=True)
        out = torch.empty((b, 124, 80), dtype=torch.float32, device="cuda")

        def launch(mode):
            code = fns[mode](a1s.data_ptr(), b, 126, 512, 80, w2p.data_ptr(), b2.data_ptr(), 1,
                             out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"mode {mode}: CUDA error {code}")

        ms = {}
        for mode in order:
            ms.setdefault(mode, []).append(statistics.median(launch_ms_samples(
                lambda: launch(mode), 5)))
        matmul = statistics.median(launch_ms_samples(
            lambda: torch.matmul(a1s.reshape(-1, 512), w2p), 5))
        _out(batch=b, ms=ms, torch_matmul_f32_z_ms=matmul)
        if b == 16384:
            smi = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                 "-lms", "100"], stdout=subprocess.PIPE, text=True)
            t0, calls = time.time(), 0
            while time.time() - t0 < 3.0:
                for _ in range(20):
                    launch("whole")
                torch.cuda.synchronize()
                calls += 20
            smi.terminate()
            rows = [ln.split(",") for ln in smi.communicate()[0].split("\n") if ln.count(",") == 1]
            _out(batch=b, whole_calls=calls, sm_clock_mhz=[float(r[0]) for r in rows[3:-1]],
                 power_w=[float(r[1]) for r in rows[3:-1]])
        del a1s, out


def main(argv: list[str] | None = None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or ["check"]
    unknown = [n for n in names if n not in ("check", "modes")]
    if unknown:
        raise SystemExit(f"unknown step(s) {unknown}; use check, modes")
    if not torch.cuda.is_available():
        raise SystemExit("conv2_ffma_modes needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
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
