"""Rows 17 (the stand-alone float conv1) and 23 (the probe suite's byte copy)
on the CPU.

Row 17 has two bodies on the card, picked by shape in Python: the register
route (``csrc/cnn_kernels.cu``, ``amc_conv1_stacked_regs``: C a multiple of
8, a thread's 8 bf16 or 4 float32 channels with their taps and bias in
registers, each frame staged as floats, one 16-byte store a row) and the
general route. Row 23 has one: four 16-byte loads in flight a thread, a
block a step of 4 x 256 vectors (up to 16 waves of resident blocks, then
grid-stride), then the byte tail. Here, on the CPU:

- row 17's route is picked by shape and out dtype, at and past each limit,
  and the wrappers take their plain versions on CPU tensors without
  counting;
- the register route's arithmetic, replayed in NumPy thread by thread
  (groups of CH channels, rows dealt to slots, frames dealt to persistent
  blocks, each product and sum rounded on its own, the bf16 pack rounded
  to nearest even), writes every output once and equals the plain version
  bit for bit, in both out dtypes, on seeded, tie and large-magnitude
  inputs; and equals the JAX kernel in interpret mode bit for bit on the
  ties (exact products), within ``tests/test_torch_cnn_kernels.py``'s
  tolerances on the rest (the JAX function fuses products and sums into
  FMAs on the CPU);
- the copy's step, stride and tail index arithmetic, replayed with the
  source's constants, writes every byte exactly once;
- the new C entry is declared and both sources name their JAX kernels.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch.ops import _build
from modulationdetectioncnn_torch.ops import cnn_kernels as tck
from modulationdetectioncnn_torch.ops import probe_kernels as pk
from modulationdetectioncnn_torch.scripts import probe
from modulationdetectioncnn_tpu.ops import cnn_kernels as jck


def _source(name: str) -> str:
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        return f.read()


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+);", src).group(1))


CNN_SRC = _source("cnn_kernels.cu")
PROBE_SRC = _source("probe_kernels.cu")
RG_THREADS = _constant(CNN_SRC, "RG_THREADS")
COPY_THREADS = _constant(PROBE_SRC, "THREADS")
COPY_UNROLL = _constant(PROBE_SRC, "COPY_UNROLL")
COPY_WAVES = _constant(PROBE_SRC, "COPY_WAVES")

# (T, C) -> row 17's route on the card (bf16 out, float32 out).
CONV1_ROUTES = {"default_t128_c256": (128, 256, "regs", "regs"),
                "c8": (128, 8, "regs", "regs"), "c48": (128, 48, "regs", "regs"),
                "t3_c8": (3, 8, "regs", "regs"), "t41_c48": (41, 48, "regs", "regs"),
                "t2048_c512": (2048, 512, "regs", "regs"),
                "c1024_bf16_limit": (128, 1024, "regs", "general"),
                "c520_past_f32_limit": (128, 520, "regs", "general"),
                "c1032_past_bf16_limit": (128, 1032, "general", "general"),
                "t2049_too_long": (2049, 256, "general", "general"),
                "t2_too_short": (2, 256, "general", "general"),
                "c33_not_8": (40, 33, "general", "general"),
                "c12_not_8": (128, 12, "general", "general"),
                "c4_too_narrow": (128, 4, "general", "general")}


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", CONV1_ROUTES, ids=list(CONV1_ROUTES))
def test_conv1_route_by_shape_and_out_dtype(case, out):
    t, c, bf16, f32 = CONV1_ROUTES[case]
    want = bf16 if out == "bfloat16" else f32
    assert tck.conv1_route(t, c, getattr(torch, out)) == want


def test_regs_route_limits_follow_the_source():
    assert _constant(CNN_SRC, "RG_MAX_T") == tck.REGS_MAX_T
    assert RG_THREADS == tck.REGS_THREADS


def test_cpu_wrappers_take_plain_versions_without_counting():
    tck.reset_launch_counts()
    pk.reset_launch_counts()
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.standard_normal((5, 2, 41)).astype(np.float32))
    w1p = torch.from_numpy(r.standard_normal((3, 48)).astype(np.float32))
    b1 = torch.from_numpy(r.standard_normal(48).astype(np.float32))
    for out in (torch.bfloat16, torch.float32):
        assert torch.equal(tck.conv1_stacked(x, w1p, b1, out_dtype=out),
                           tck.conv1_stacked_plain(x, w1p, b1, out))
    h = torch.from_numpy(r.integers(-128, 128, 1_000_003).astype(np.int8))
    assert torch.equal(pk.copy_bytes(h), h)
    assert tck.conv1_stacked.launches == 0
    assert tck.route_launch_counts()["conv1_stacked"] == {"regs": 0, "general": 0}
    assert pk.copy_bytes.launches == 0


def _bf16_bits(v: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bits, rounded to nearest even (__floats2bfloat162_rn)."""
    u = v.view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16).astype(np.uint16)


def _regs_replay(x, w1p, b1, out: str, lead: int, grid: int):
    """The register route in NumPy, as out's bits: x placed ``lead`` floats
    into a buffer, frames dealt to ``grid`` persistent blocks (frame f to
    block f % grid, each staged whole from the buffer), a row's 2C channels
    to 2C / CH threads of CH channels (thread g: channels g*CH .. g*CH+CH-1,
    plane g*CH >= C), rows to RG_THREADS / (2C / CH) slots (slot s: rows s,
    s + slots, ...); per channel acc = 0, + x0*w0, + x1*w1, + x2*w2, + b,
    then max with 0, in float32 with each step rounded. Also returns how
    many times each output was written."""
    b, _, t = x.shape
    c = w1p.shape[1]
    ch = 8 if out == "bfloat16" else 4
    groups, t_out = 2 * c // ch, t - 2
    slots = RG_THREADS // groups
    assert slots >= 1 and c % ch == 0
    buf = np.full(lead + x.size, np.nan, np.float32)
    buf[lead:] = x.reshape(-1)
    res = np.zeros((b, t_out, 2 * c), np.float32)
    writes = np.zeros((b, t_out, 2 * c), np.int64)
    g = np.arange(groups)
    n = g[:, None] * ch + np.arange(ch)                    # (groups, CH) channels
    h = (g * ch >= c).astype(np.int64)
    cc = n - h[:, None] * c
    w = [w1p[k][cc] for k in range(3)]
    bias = b1[cc]
    for blk in range(min(grid, b)):
        for f in range(blk, b, grid):
            xf = buf[lead + f * 2 * t:lead + (f + 1) * 2 * t]   # the staged frame
            for s in range(slots):
                rows = np.arange(s, t_out, slots)
                xp = xf[h[None, :] * t + rows[:, None]]         # (rows, groups)
                acc = np.zeros((rows.size, groups, ch), np.float32)
                for k in range(3):
                    xk = xf[h[None, :] * t + rows[:, None] + k][..., None]
                    acc = (acc + (xk * w[k]).astype(np.float32)).astype(np.float32)
                v = np.maximum((acc + bias).astype(np.float32), np.float32(0))
                assert np.isfinite(xp).all()                    # never read past the frame
                res[f, rows[:, None, None], n[None]] = v
                writes[f, rows[:, None, None], n[None]] += 1
    bits = _bf16_bits(res) if out == "bfloat16" else res.view(np.uint32)
    return bits, writes


def _conv1_inputs(kind: str, b: int, t: int, c: int, seed: int):
    r = np.random.default_rng(seed)
    if kind == "seeded":
        return (r.standard_normal((b, 2, t)).astype(np.float32),
                (r.standard_normal((3, c)) / np.sqrt(3)).astype(np.float32),
                (0.1 * r.standard_normal(c)).astype(np.float32))
    if kind == "ties":
        # x of 9 significant bits in [1, 2) (mostly odd: a bf16 tie when a
        # tap passes it alone), taps one-hot or two-hot powers of two, bias
        # 0 or a multiple of 2^-8: every product and sum exact in float32,
        # and many outputs exactly halfway between two bf16 values.
        x = (r.integers(256, 512, (b, 2, t)) / 256.0).astype(np.float32)
        w = np.zeros((3, c), np.float32)
        ch = np.arange(c)
        w[ch % 3, ch] = 2.0 ** (ch % 5 - 2)
        w[(ch + 1) % 3, ch] += np.where(ch % 4 == 0, 2.0 ** (ch % 3 - 1), 0.0)
        bias = np.where(ch % 2 == 0, 0.0, (ch % 7 - 3) / 256.0).astype(np.float32)
        return x, w, bias
    # large: products near 2^120, sums near 2^122, bias near 2^100.
    return ((r.standard_normal((b, 2, t)) * 2.0 ** 60).astype(np.float32),
            (r.standard_normal((3, c)) * 2.0 ** 60 / np.sqrt(3)).astype(np.float32),
            (r.standard_normal(c) * 2.0 ** 100).astype(np.float32))


REPLAY_SHAPES = {f"t{t}_c{c}": (t, c) for t in (3, 41, 128) for c in (8, 48, 256)}


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", REPLAY_SHAPES, ids=list(REPLAY_SHAPES))
def test_regs_route_arithmetic_equals_plain(shape, out):
    t, c = REPLAY_SHAPES[shape]
    b = 3
    assert tck.conv1_route(t, c, getattr(torch, out)) == "regs"
    for i, kind in enumerate(("seeded", "ties", "large")):
        x, w1p, b1 = _conv1_inputs(kind, b, t, c, seed=t * c + i)
        bits, writes = _regs_replay(x, w1p, b1, out, lead=i % 2, grid=2)
        assert (writes == 1).all(), kind
        plain = tck.conv1_stacked_plain(*(torch.from_numpy(a) for a in (x, w1p, b1)),
                                        getattr(torch, out))
        want = plain.view(torch.int16).numpy().view(np.uint16) if out == "bfloat16" \
            else plain.numpy().view(np.uint32)
        np.testing.assert_array_equal(bits, want, err_msg=kind)
        got = (bits.astype(np.uint32) << 16).view(np.float32) if out == "bfloat16" \
            else bits.view(np.float32)
        assert np.isfinite(got).all(), kind
        jax_out = np.asarray(jck.conv1_stacked(*(jnp.asarray(a) for a in (x, w1p, b1)),
                                               out_dtype=getattr(jnp, out), block_b=2,
                                               interpret=True), np.float32)
        if kind == "ties":
            np.testing.assert_array_equal(got, jax_out, err_msg=kind)
            if out == "bfloat16":      # the ties are there: halfway values rounded to even
                exact = plain.float().numpy() != tck.conv1_stacked_plain(
                    *(torch.from_numpy(a) for a in (x, w1p, b1)), torch.float32).numpy()
                assert exact.any()
        else:
            rtol = 2.0 ** -7 if out == "bfloat16" else 0.0
            bound = rtol * np.maximum(np.abs(got), np.abs(jax_out)) \
                + 1e-6 * np.abs(jax_out).max()
            assert (np.abs(got.astype(np.float64) - jax_out) <= bound).all(), kind


def _copy_replay(n_bytes: int, grid: int) -> tuple[np.ndarray, np.ndarray]:
    """How many times the copy kernel writes each 16-byte vector of
    ``n_bytes`` and which tail bytes it writes (one each), at
    ``grid`` blocks of COPY_THREADS: thread j of block k steps through i =
    COPY_UNROLL * COPY_THREADS * k + j, then i + the grid's COPY_UNROLL *
    COPY_THREADS * grid, ... while i < n_vec, each step writing vectors i +
    u * COPY_THREADS < n_vec for u < COPY_UNROLL; then the last block's
    threads j with 16 n_vec + j < n_bytes write that tail byte."""
    n_vec = n_bytes // 16
    step = COPY_UNROLL * COPY_THREADS
    stride = step * grid
    steps = max(1, -(-n_vec // stride))
    vec_writes = np.zeros(n_vec + 1, np.int64)            # the last slot: masked off
    batch = max(1, (1 << 20) // (steps * COPY_THREADS))   # blocks a batch: bounded memory
    for k0 in range(0, grid, batch):
        blk = np.arange(k0, min(grid, k0 + batch))
        i = (step * blk[:, None, None] + np.arange(COPY_THREADS)[None, None, :]
             + stride * np.arange(steps)[None, :, None])  # (blocks, steps, threads)
        live = i < n_vec
        for u in range(COPY_UNROLL):
            idx = i + u * COPY_THREADS
            ok = live & (idx < n_vec)
            vec_writes += np.bincount(np.where(ok, idx, n_vec).ravel(), minlength=n_vec + 1)
    tail = 16 * n_vec + np.arange(COPY_THREADS)
    return vec_writes[:n_vec], tail[tail < n_bytes]       # the last block's threads


def _copy_grid(n_bytes: int, resident: int) -> int:
    """The entry's grid: a block a step of COPY_UNROLL * COPY_THREADS
    vectors, at most COPY_WAVES times the resident blocks, at least 1."""
    steps = -(-(n_bytes // 16) // (COPY_UNROLL * COPY_THREADS))
    return max(1, min(resident * COPY_WAVES, steps))


COPY_SIZES = (0, 1, 15, 16, 37, 1_000_003, 4096 * 16384)


@pytest.mark.parametrize("grid", [1, 132, 2112, "entry"])
@pytest.mark.parametrize("n", COPY_SIZES)
def test_copy_writes_every_byte_once(n, grid):
    """Every byte once at a grid of 1, 132 and 2112 blocks, and at the
    entry's own grid on the H100 (132 SMs x 8 resident blocks of 256)."""
    if grid == "entry":
        grid = _copy_grid(n, 132 * 8)
    vec_writes, tail = _copy_replay(n, grid)
    assert (vec_writes == 1).all()
    np.testing.assert_array_equal(tail, np.arange(16 * vec_writes.size, n))


def test_new_entry_declared_and_sources_name_their_jax_kernels():
    """The register route's C entry is declared with the general entry's
    argument types (the same ABI), its source defines it and names the JAX
    kernel it replaces, the copy's source names its probe kernel, and the
    probes that time both against an earlier body declare them."""
    sig = _build._SIGNATURES
    assert sig["amc_conv1_stacked_regs"] == sig["amc_conv1_stacked"]
    sources = {CNN_SRC: ("amc_conv1_stacked_regs",
                         "Replaces: modulationdetectioncnn_tpu/ops/cnn_kernels.py::_conv1_kernel\n"
                         "//   (ops/cnn_kernels.py:78"),
               PROBE_SRC: ("amc_copy_bytes",
                           "Replaces: scripts/probe.py::probe_r3's `_copy_kernel` (the "
                           "pl.pallas_call\n//   at scripts/probe.py:1044)")}
    for src, (entry, replaces) in sources.items():
        assert re.search(rf'extern "C" int {entry}\(', src)
        assert replaces in src
        assert entry in src[:src.index("#include")]       # the note names the entry
    assert "conv1_stacked" in probe.CNN_ENTRIES
    assert probe.PROBE_ENTRIES == ("copy_bytes", "tap_planes")
    assert os.path.dirname(probe.OLD_PROBE_SRC) == _build.BUILD_DIR
    assert {"conv1_old", "copy_old"} <= set(probe.PROBES)
