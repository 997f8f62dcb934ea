"""Rows 21 (the timing FIR) and 19 (the stand-alone int8 conv1) on the CPU.

Each has two bodies on the card, picked by shape in Python: the timing FIR's
window route (``csrc/correct_timing.cu``, ``amc_correct_timing_fir_window``:
T 128, taps <= 17, one warp a frame, the window taken from neighbouring
lanes) and its general route; row 19's dp4a route (``csrc/cnn_kernels.cu``,
``amc_conv1_stacked_int8_dp4a``: C a multiple of 16, a thread's 16 channels
in registers, each frame staged as 4-byte words from the aligned word at or
below its first byte) and its general route. Here, on the CPU:

- each route is picked by shape (and, for the FIR, alignment), and the
  wrappers take their plain versions on CPU tensors without counting;
- the plain versions equal the JAX package's functions on the edge inputs
  the chip checks use: tau at the wrap and rounding extremes
  (``scripts/probe.py::TIMING_TAU_EDGES``; within 2e-6, the XLA CPU
  backend's FMAs, and bit for bit against the unfused loop), and row 19's
  saturated sums, shifts 0 .. 31 and offsets at the clip's edges
  (``scripts/probe.py::conv1_int8_edge_cases``; bit for bit, and against
  ``golden/quant.py``);
- the new bodies' index arithmetic, replayed in NumPy (lanes, neighbour
  reach and zero halo of the window; word staging at every byte offset,
  the funnel-shifted window, the packed taps with a zero fourth byte,
  bytes past the input's end), equals the plain versions bit for bit;
- the new C entries are declared in ``ops/_build.py`` and their sources
  name the JAX kernels they replace.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch.dsp import normalize as tnorm
from modulationdetectioncnn_torch.ops import _build
from modulationdetectioncnn_torch.ops import cnn_kernels as tck
from modulationdetectioncnn_torch.scripts import probe
from modulationdetectioncnn_tpu.dsp import normalize as jnorm
from modulationdetectioncnn_tpu.golden import quant as gq
from modulationdetectioncnn_tpu.ops import cnn_kernels as jck

TAU_EDGES = np.array(probe.TIMING_TAU_EDGES, np.float32)

# (T, taps, x 16-byte aligned) -> the timing FIR's route on the card.
FIR_ROUTES = {"stream_t128_taps17": (128, 17, True, "window"),
              "t128_taps1": (128, 1, True, "window"),
              "t128_taps3": (128, 3, True, "window"),
              "t128_taps9": (128, 9, True, "window"),
              "t128_taps19_too_long": (128, 19, True, "general"),
              "t40": (40, 17, True, "general"),
              "t300": (300, 17, True, "general"),
              "t128_misaligned": (128, 17, False, "general")}
# (T, C) -> row 19's route on the card.
CONV1_ROUTES = {"default_t128_c256": (128, 256, "dp4a"), "c16": (128, 16, "dp4a"),
                "c48": (128, 48, "dp4a"), "t3_c16": (3, 16, "dp4a"),
                "t8192_c2048": (8192, 2048, "dp4a"),
                "c33_not_16": (40, 33, "general"), "c8_too_narrow": (128, 8, "general"),
                "c2064_too_wide": (128, 2064, "general"),
                "t8193_too_long": (8193, 256, "general")}


@pytest.mark.parametrize("case", FIR_ROUTES, ids=list(FIR_ROUTES))
def test_timing_fir_route_by_shape(case):
    t, taps, aligned, want = FIR_ROUTES[case]
    assert tnorm.correct_timing_fir_route(t, taps, aligned) == want


@pytest.mark.parametrize("case", CONV1_ROUTES, ids=list(CONV1_ROUTES))
def test_conv1_int8_route_by_shape(case):
    t, c, want = CONV1_ROUTES[case]
    assert tck.conv1_int8_route(t, c) == want


def test_cpu_wrappers_take_plain_versions_without_counting():
    tnorm.reset_launch_counts()
    tck.reset_launch_counts()
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((5, 2, 128)).astype(np.float32))
    c = torch.from_numpy(r.standard_normal((5, 17)).astype(np.float32))
    assert torch.equal(tnorm.correct_timing_fir(x, c), tnorm.correct_timing_fir_plain(x, c))
    xs, w, m, o = (torch.from_numpy(a) for a in probe.conv1_int8_edge_cases(3, 5, 40, 16)
                   ["clip_edges"])
    assert torch.equal(tck.conv1_stacked_int8(xs, w, m, o),
                       tck.conv1_stacked_int8_plain(xs, w, m, o))
    assert tnorm.correct_timing_fir.launches == 0
    assert tnorm.correct_timing_fir.route_launches == {"window": 0, "general": 0}
    assert tck.conv1_stacked_int8.launches == 0
    assert tck.route_launch_counts()["conv1_stacked_int8"] == {"dp4a": 0, "general": 0}


def _fir_loop(x, c):
    """The timing FIR as a NumPy float32 loop over any odd taps, each
    multiply and add rounded on its own (the CUDA kernels' order)."""
    taps, t = c.shape[1], x.shape[-1]
    half = (taps - 1) // 2
    xp = np.pad(x, [(0, 0), (0, 0), (half, half)])
    acc = np.zeros_like(x)
    for j in range(taps):
        acc = (acc + (xp[..., j:j + t] * c[:, None, j:j + 1]).astype(np.float32)
               ).astype(np.float32)
    return acc


# (B, T, taps per phase): the filter has 2 * taps + 1 taps.
TIMING_JAX_CASES = {"b1_t128": (1, 128, 8), "b37_t128": (37, 128, 8),
                    "b37_t40": (37, 40, 8), "b37_t40_taps3": (37, 40, 1)}


@pytest.mark.parametrize("case", TIMING_JAX_CASES, ids=list(TIMING_JAX_CASES))
def test_timing_plain_matches_jax_at_the_tau_edges(case):
    """The port's correct_timing (the plain FIR on the CPU) against the JAX
    package's, the same frames and tau at the wrap and rounding extremes:
    within 2e-6 (the JAX kernel's multiply-adds fuse on the CPU), and the
    plain FIR bit for bit against the unfused loop."""
    b, t, tpp = TIMING_JAX_CASES[case]
    r = np.random.default_rng(b * t + tpp)
    x = r.standard_normal((b, 2, t)).astype(np.float32)
    tau = np.resize(TAU_EDGES, b)
    got = tnorm.correct_timing(torch.from_numpy(x), torch.from_numpy(tau), 8,
                               taps_per_phase=tpp).numpy()
    want = np.asarray(jnorm.correct_timing(jnp.asarray(x), jnp.asarray(tau), 8,
                                           taps_per_phase=tpp))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    c = tnorm.timing_filters(torch.from_numpy(tau), 8, taps_per_phase=tpp).numpy()
    assert c.shape == (b, 2 * tpp + 1)
    np.testing.assert_array_equal(got, _fir_loop(x, c))


# (B, T, C) for row 19's edges: C 16, 48, 256 take the dp4a route, 33 the
# general one; T 3 is one output row.
CONV1_JAX_CASES = {"b1_t128_c256": (1, 128, 256), "b37_t40_c33": (37, 40, 33),
                   "b37_t3_c16": (37, 3, 16), "b37_t40_c48": (37, 40, 48),
                   "b1_t3_c33": (1, 3, 33)}


def _conv1_acc(x, w):
    """conv1's exact int32 sums (B, T-2, 2C) in int64."""
    t1 = x.shape[-1] - 2
    return np.concatenate([sum(x[:, h, k:k + t1, None].astype(np.int64) * w[k].astype(np.int64)
                               for k in range(3)) for h in range(2)], axis=-1)


@pytest.mark.parametrize("case", CONV1_JAX_CASES, ids=list(CONV1_JAX_CASES))
def test_conv1_int8_plain_matches_jax_at_the_edges(case):
    """Row 19's plain version against the JAX kernel in interpret mode and
    the golden chain on both edge kinds, bit for bit; the edges are what
    they claim: sums at +-3 * 128^2 (and 3 * 127 * 128), outputs at 0 and
    127, every shift 0 .. 31 where 2C reaches it, and offsets putting frame
    0's row 0 at -1, 0, 127 and 128 before the clip."""
    b, t, c = CONV1_JAX_CASES[case]
    for kind, (x, w, m, o) in probe.conv1_int8_edge_cases(b * t + c, b, t, c).items():
        got = tck.conv1_stacked_int8(*(torch.from_numpy(a) for a in (x, w, m, o))).numpy()
        want = np.asarray(jck.conv1_stacked_int8(*(jnp.asarray(a) for a in (x, w, m, o)),
                                                 block_b=16, interpret=True))
        np.testing.assert_array_equal(got, want, err_msg=kind)
        np.testing.assert_array_equal(got, gq.conv1_int8(x, w, m, o), err_msg=kind)
        acc = _conv1_acc(x, w)
        assert np.array_equal(np.sort(np.unique(m)), np.arange(min(2 * c, 32)))
        if kind == "saturated":
            assert acc.max() == 3 * 128 * 128 and acc.min() == -3 * 127 * 128
            assert got.min() == 0 and got.max() == 127
        else:
            n = np.arange(2 * c)
            pre = (acc[0, 0] + o) >> m
            target = np.array([-1, 0, 127, 128])[n // 2 % 4]
            reach = np.abs(target.astype(np.int64) << m.astype(np.int64)) < 2 ** 30
            assert np.array_equal(pre[reach], target[reach])
            assert np.abs(acc.astype(np.int64) + o).max() < 2 ** 31


def _window_fir_replay(x, c):
    """The window route's arithmetic in NumPy: lane l of a frame's warp
    holds x[4l .. 4l+3] of a plane, takes x[4l-8 .. 4l+11] from lanes l-2
    .. l+2 (only as far as the filter reaches, zeros past the row's ends)
    and runs the taps x 4 outputs in order, float32 throughout."""
    b, taps = x.shape[0], c.shape[1]
    half = (taps - 1) // 2
    lanes = x.reshape(b, 2, 32, 4)
    reach = 2 if half > 4 else 1 if half > 0 else 0
    xx = np.full((b, 2, 32, 20), np.nan, np.float32)      # unread slots stay NaN
    xx[..., 8:12] = lanes
    for d in range(1, reach + 1):
        xx[..., :, 8 - 4 * d:12 - 4 * d] = 0.0
        xx[..., d:, 8 - 4 * d:12 - 4 * d] = lanes[..., :32 - d, :]     # __shfl_up_sync
        xx[..., :, 8 + 4 * d:12 + 4 * d] = 0.0
        xx[..., :32 - d, 8 + 4 * d:12 + 4 * d] = lanes[..., d:, :]     # __shfl_down_sync
    acc = np.zeros((b, 2, 32, 4), np.float32)
    for j in range(taps):
        win = xx[..., 8 - half + j:12 - half + j]
        acc = (acc + (win * c[:, None, None, j:j + 1]).astype(np.float32)).astype(np.float32)
    return acc.reshape(b, 2, 128)


@pytest.mark.parametrize("taps", [1, 3, 9, 11, 17])
def test_window_route_arithmetic_equals_plain(taps):
    r = np.random.default_rng(taps)
    x = r.standard_normal((6, 2, 128)).astype(np.float32)
    c = r.standard_normal((6, taps)).astype(np.float32)
    want = tnorm.correct_timing_fir_plain(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    got = _window_fir_replay(x, c)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def _dp4a_replay(x, w, m, o, lead, rng):
    """The dp4a route's arithmetic in NumPy, with x placed ``lead`` bytes
    past a word in a buffer whose bytes past x's end are noise (a word that
    starts inside x is read whole): per frame, 4-byte words from the
    aligned word at or below its first byte, zeros for words that start
    past x's end; per row, the plane's window as one word funnel-shifted
    out of two; per channel, the signed byte products with the packed taps
    (w0, w1, w2, 0) summed; then the requantize."""
    b, _, t = x.shape
    c = w.shape[1]
    n_words = (2 * t + 10) // 4
    buf = rng.integers(0, 256, lead + x.size + 8 * n_words, dtype=np.uint8)
    buf[lead:lead + x.size] = x.reshape(-1).view(np.uint8)
    x_end = lead + x.size
    taps = np.zeros((2 * c, 4), np.int64)
    taps[:, :3] = np.concatenate([w, w], axis=1).T.astype(np.int64)
    out = np.empty((b, t - 2, 2 * c), np.int8)
    for f in range(b):
        xb = lead + f * 2 * t
        a0 = xb & ~3
        starts = a0 + 4 * np.arange(n_words)
        words = buf[a0:a0 + 4 * n_words].view("<u4").astype(np.uint64)
        words[starts >= x_end] = 0
        for h in range(2):
            idx = (xb - a0) + h * t + np.arange(t - 2)
            pair = words[(idx >> 2) + 1] << np.uint64(32) | words[idx >> 2]
            win = (pair >> (8 * (idx & 3)).astype(np.uint64)) & np.uint64(0xFFFFFFFF)
            xbytes = win.astype(np.uint32).view(np.uint8).view(np.int8).reshape(-1, 4)
            acc = xbytes.astype(np.int64) @ taps[h * c:(h + 1) * c].T
            ch = slice(h * c, (h + 1) * c)
            v = (acc.astype(np.int32) + o[ch]) >> m[ch]
            out[f, :, ch] = np.clip(v, 0, 127)
    return out


@pytest.mark.parametrize("lead", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(3, 41, 16), (2, 3, 48), (2, 128, 32)],
                         ids=["t41_c16", "t3_c48", "t128_c32"])
def test_dp4a_route_arithmetic_equals_plain(lead, shape):
    b, t, c = shape
    rng = np.random.default_rng(lead + t)
    for kind, (x, w, m, o) in probe.conv1_int8_edge_cases(t + c, b, t, c).items():
        want = tck.conv1_stacked_int8_plain(*(torch.from_numpy(a) for a in (x, w, m, o)))
        np.testing.assert_array_equal(_dp4a_replay(x, w, m, o, lead, rng), want.numpy(),
                                      err_msg=kind)


def test_new_entries_declared_and_sources_name_their_jax_kernels():
    """The two new C entries are declared with the argument types of the
    general entries they sit beside (the same ABI), their sources define
    them and name the JAX kernels they replace, and the probes that time
    them against an earlier body declare them too."""
    sig = _build._SIGNATURES
    assert sig["amc_correct_timing_fir_window"] == sig["amc_correct_timing_fir"]
    assert sig["amc_conv1_stacked_int8_dp4a"] == sig["amc_conv1_stacked_int8"]
    sources = {"correct_timing.cu": ("amc_correct_timing_fir_window",
                                     "Replaces: modulationdetectioncnn_tpu/dsp/normalize.py::"
                                     "correct_timing's\n//   kernel `kern` (dsp/normalize.py:189"),
               "cnn_kernels.cu": ("amc_conv1_stacked_int8_dp4a",
                                  "Replaces: modulationdetectioncnn_tpu/ops/cnn_kernels.py::"
                                  "_conv1_int8_kernel\n//   (:223")}
    for name, (entry, replaces) in sources.items():
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            src = f.read()
        assert re.search(rf'extern "C" int {entry}\(', src)
        assert replaces in src
        head = src[:src.index("#include")]
        assert entry in head                 # the note names the entry it replaces with
    assert "conv1_stacked_int8" in probe.CNN_ENTRIES
    assert probe.TIMING_ENTRIES == ("correct_timing_fir",)
    assert os.path.dirname(probe.OLD_TIMING_SRC) == _build.BUILD_DIR
    assert {"timing_old", "conv1_int8_old"} <= set(probe.PROBES)
