"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each of ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and one more ``nvcc`` call links the objects
into one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds). The library lands in ``_build/`` inside the package
(listed in ``.gitignore``), named by a hash of the sources, the headers they
include (``csrc/*.cuh``) and the flags, so an edit to any of them rebuilds
it and an unchanged tree reuses it.

Each C function takes raw device pointers, sizes and the CUDA stream, and
returns the ``cudaGetLastError()`` code of its launch; ``check`` raises on a
non-zero code. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    # x, n, w1, m1, o1, w2t, m2, o2, inv_sx, out, stream
    "amc_conv_stage_int8_v7": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
                               ctypes.c_float, _P, _P],
    # h, n, w3t, m3, o3, w4, s4, b4, out, stream
    "amc_dense_argmax_int8": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
                              _P, _P],
    # x, n, w1f, w2l, m2, o2, inv_sx, out, stream
    "amc_conv_stage_int8_v9": [_P, ctypes.c_longlong, _P, _P, _P, _P,
                               ctypes.c_float, _P, _P],
    "amc_conv_stage_int8_v10": [_P, ctypes.c_longlong, _P, _P, _P, _P,
                                ctypes.c_float, _P, _P],
    # x, n, w1e, m1, o1, w2l, m2, o2, inv_sx, out, stream
    "amc_conv_stage_int8_v5": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
                               ctypes.c_float, _P, _P],
    "amc_conv_stage_int8_v1": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
                               ctypes.c_float, _P, _P],
    # xp, n, w1e, m1, o1, w2l, m2, o2, out, stream
    "amc_conv_stage_int8_v6": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
                               _P, _P],
    "amc_conv_stage_int8_v4": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
                               _P, _P],
    # xe, n, w1e, m1, o1, w2l, m2, o2, out, stream
    "amc_conv_stage_int8_v3": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
                               _P, _P],
    "amc_conv_stage_int8_v2": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
                               _P, _P],
    # h, n, w3t, m3, o3, w4, s4, b4, logits, stream
    "amc_dense_int8": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P, _P],
    # x, n, w1e, w2t, b2, out, stream
    "amc_conv_stage_bf16_v4": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P],
    # xe, n, w1e, w2t, b2, out, stream
    "amc_conv_stage_bf16_v2": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P],
    # x, n, w1p, b1, w2t, b2, out, stream
    "amc_conv_stage_bf16": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P],
    # h, n, w3t, b3, w4, b4, nc, labels, stream
    "amc_dense_argmax_bf16": [_P, ctypes.c_longlong, _P, _P, _P, _P, ctypes.c_int,
                              _P, _P],
    # h, n, w3t, b3, w4, b4, nc, logits, stream
    "amc_dense_bf16": [_P, ctypes.c_longlong, _P, _P, _P, _P, ctypes.c_int, _P, _P],
    # x, rows, t_len, c, taps, out, stream
    "amc_correct_timing_fir": [_P, ctypes.c_longlong, ctypes.c_int, _P,
                               ctypes.c_int, _P, _P],
    "amc_correct_timing_fir_window": [_P, ctypes.c_longlong, ctypes.c_int, _P,
                                      ctypes.c_int, _P, _P],
    # x, n, t_in, c, w1p, b1, out_f32, out, stream
    "amc_conv1_stacked": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P,
                          ctypes.c_int, _P, _P],
    "amc_conv1_stacked_regs": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P,
                               ctypes.c_int, _P, _P],
    # x, n, t_in, c, w1p, m, o, out, stream
    "amc_conv1_stacked_int8": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P,
                               _P, _P, _P, _P],
    "amc_conv1_stacked_int8_dp4a": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P,
                                    _P, _P, _P, _P],
    # a1s, n, t_in, k, co, w2p, b2, in_f32, out_f32, vec, out, stream
    "amc_conv2_stacked": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, _P, _P],
    # a1s, n, t_in, k, co, w2p, m, o, vec, out, stream
    "amc_conv2_stacked_int8": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, _P, _P, _P, ctypes.c_int, _P, _P],
    # a1s, n, t_in, k, co, w2p, b2, out_f32, out, stream
    "amc_conv2_stacked_wgmma": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, _P, _P, ctypes.c_int, _P, _P],
    # a1s, n, t_in, k, co, w2p, b2, out_f32, out, stream
    "amc_conv2_stacked_ffma": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, _P, _P, ctypes.c_int, _P, _P],
    # a1s, n, t_in, k, co, w2p, m, o, out, stream
    "amc_conv2_stacked_int8_wgmma": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, _P, _P, _P, _P, _P],
    # in, n_bytes, out, stream
    "amc_copy_bytes": [_P, ctypes.c_longlong, _P, _P],
    # x, n, w (the packed stacks), out, stream
    "amc_residual_chain_bf16": [_P, ctypes.c_longlong, _P, _P, _P],
    # x, b, t_len, inv_sx, out, stream
    "amc_tap_planes": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, _P, _P],
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels are built on the GPU machine")
    return nvcc


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libamc_kernels_{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> dict:
    """Compile the kernels if the library for these sources is missing.
    Returns the library path, the build seconds (0 when reused) and the
    compiler's report (registers and shared memory per kernel)."""
    out = library_path()
    if os.path.isfile(out) and not force:
        return {"path": out, "seconds": 0.0, "log": ""}
    nvcc = find_nvcc()
    tmp = f"{out}.{os.getpid()}.tmp"
    obj_dir = f"{tmp}.obj"
    os.makedirs(obj_dir, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = os.path.join(obj_dir, os.path.basename(src) + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    return {"path": out, "seconds": time.perf_counter() - t0, "log": "".join(log)}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build on first use and load, with argument types declared."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.amc_error_string.argtypes = [ctypes.c_int]
    lib.amc_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code != 0:
        msg = lib.amc_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{name} failed to launch: CUDA error {code} ({msg})")
