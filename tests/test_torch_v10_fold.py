"""The folded conv1 of the v9/v10 conv stages against the JAX package's.

The CUDA body of rows 3 and 4 (``csrc/conv_stage_int8_v10.cu``) computes
conv1 as the JAX package's v10 kernel does, ``[xq_I(t), xq_Q(t), ..., 1, 0]``
times the fold's 8 rows with f32 sums, then truncates ``clip(f, 0, 127)``.
Here, on the CPU, the port's plain version of that (``conv1_folded_plain``)
meets the JAX package's ``_conv_stage_int8_v10_kernel`` in interpret mode:
conv1's whole (B, 126, 512) map, read through pass-through probes of conv2
(``scripts/probe.py::conv1_probe_trees``), and the integer spec
``clip((acc + o1) >> shift1, 0, 127)``, on the committed artifact and on a
seeded model at the edge of the fold's 2^24 bound
(``scripts/probe.py::fold_edge_tree``). The kernel's convert of an f32 sum
(``rq1_bytes``: toward zero to f16 via d + 1024, then an int16 clamp) is
replayed step by step against ``trunc(clip(d, 0, 127))`` on the values where
it could go wrong. A model that breaks the fold is refused when a v9 or v10
stage is built.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch.ops import infer as tinfer
from modulationdetectioncnn_torch.quant import (
    DEFAULT_ARTIFACT, QuantizedModel, int8_weights_from_numpy)
from modulationdetectioncnn_torch.scripts.probe import (
    conv1_from_probe_maps, conv1_probe_trees, fold_edge_tree)
from modulationdetectioncnn_tpu.ops import infer as jinfer
from modulationdetectioncnn_tpu.train.quant import QuantizedModel as JaxQM

B = 8


@pytest.fixture(scope="module")
def trees():
    return {"artifact": QuantizedModel.from_npz(DEFAULT_ARTIFACT).tree(),
            "fold_edge": fold_edge_tree(17)}


@pytest.fixture(scope="module")
def frames(trees):
    """Seeded frames, the last two saturated (every sample +-300 s_x)."""
    rng = np.random.default_rng(17)
    x = 0.7 * rng.standard_normal((B, 2, 128))
    x[-2:] = 300.0 * float(trees["artifact"]["s_x"]) * rng.choice([-1.0, 1.0], (2, 2, 128))
    return x.astype(np.float32)


def _jax_v10(tree: dict, frames: np.ndarray) -> np.ndarray:
    qm = JaxQM.from_tree(tree)
    out = jinfer.make_conv_stage(qm, "v10", block_b=B, chunk=4, interpret=True)(
        jnp.asarray(frames))
    return np.asarray(out)[:, :124, :qm.m2.shape[0]]


@pytest.mark.parametrize("model", ("artifact", "fold_edge"))
def test_folded_conv1_matches_pallas_v10_and_the_integer_spec(trees, frames, model):
    tree = trees[model]
    qw = int8_weights_from_numpy(tree, device="cpu")
    x = torch.from_numpy(frames)
    got = tinfer.conv1_folded_plain(x, qw).numpy()
    assert got.shape == (B, 126, 512) and got.dtype == np.int8
    np.testing.assert_array_equal(got, tinfer.conv1_int8_plain(x, qw).numpy())
    probes = conv1_probe_trees(tree)
    want = conv1_from_probe_maps([_jax_v10(t, frames) for t, _, _ in probes], probes)
    np.testing.assert_array_equal(got, want)
    assert 0 < (got > 0).mean() < 1 and (got == 127).any()   # live, and clipped too


def test_fold_edge_stage_matches_pallas_v9_and_v10(trees, frames):
    """The whole conv stage on the edge model: the port's v9 and v10 (their
    plain version on the CPU) against the JAX package's kernels."""
    tree = trees["fold_edge"]
    qm = JaxQM.from_tree(tree)
    qw = int8_weights_from_numpy(tree, device="cpu")
    x = torch.from_numpy(frames)
    for version in ("v9", "v10"):
        want = np.asarray(jinfer.make_conv_stage(qm, version, block_b=B, chunk=4, interpret=True)(
            jnp.asarray(frames)))[:, :124, :80]
        got = getattr(tinfer, f"conv_stage_int8_{version}")(x, qw).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < (got > 0).mean() < 1


def _toward_zero(exact: np.ndarray, rounded: np.ndarray) -> np.ndarray:
    """``rounded`` (round to nearest of ``exact``) moved one step toward zero
    where it rounded away from zero: round toward zero."""
    away = np.abs(rounded.astype(np.float64)) > np.abs(exact)
    return np.where(away, np.nextafter(rounded, rounded.dtype.type(0)), rounded)


def _rq1_as_the_kernel(d: np.ndarray) -> np.ndarray:
    """``rq1_bytes`` of the CUDA body, one output: __fadd_rz(d, 1024), then
    cvt.rz.relu to f16, then max(min(bits - 0x6400, 127), 0) on the half
    read as an int16."""
    s = d.astype(np.float64) + 1024.0                       # exact in f64
    z = _toward_zero(s, s.astype(np.float32))
    with np.errstate(over="ignore"):
        h = _toward_zero(z.astype(np.float64), z.astype(np.float16))
    h = np.where(h < 0, np.float16(0), h)                   # relu: +0
    return np.clip(h.view(np.int16).astype(np.int32) - 0x6400, 0, 127)


def test_the_kernels_convert_is_trunc_of_the_clip():
    """Every sum the fold can give is k * 2^-s, |k| < 2^24: integers and
    halves around the clip's edges, one unit of 2^-s either side of each
    integer (s = 1 .. 31), the -1024 and 1024 corners, and the extremes."""
    ints = np.arange(-2100, 2100, dtype=np.float64)
    vals = [ints, ints + 0.5, np.array([0.0, -0.0, 2.0 ** 24 - 1, -(2.0 ** 24 - 1), 1e7, -1e7])]
    for s in (1, 2, 7, 13, 14, 17, 20, 24, 31):
        u = 2.0 ** -s
        vals += [ints + u, ints - u, np.array([u, -u, 127 - u, 128 - u, 1024 - u, -1024 - u])]
    rng = np.random.default_rng(0)
    for s in (0, 3, 12, 17, 24, 31):
        vals.append(rng.integers(-(2 ** 24) + 1, 2 ** 24, 4000) * 2.0 ** -s)
    d = np.concatenate(vals)
    d = d[d.astype(np.float32).astype(np.float64) == d].astype(np.float32)   # exact in f32
    want = np.floor(np.clip(d.astype(np.float64), 0, 127)).astype(np.int32)
    np.testing.assert_array_equal(_rq1_as_the_kernel(d), want)


def test_a_model_that_breaks_the_fold_is_refused_at_build(trees):
    tree = dict(trees["artifact"], o1=np.array(trees["artifact"]["o1"]).copy())
    tree["o1"][5] = 257                                      # not bf16-exact once scaled
    qw = int8_weights_from_numpy(tree, device="cpu")
    for version in ("v9", "v10"):
        with pytest.raises(ValueError, match="bf16-exact"):
            tinfer.make_conv_stage(qw, version, device="cpu")
        with pytest.raises(ValueError, match="bf16-exact"):
            tinfer.make_int8_predict(qw, version)
    big = dict(trees["artifact"], o1=np.full(512, 2 ** 24, np.int32))      # bf16-exact
    with pytest.raises(ValueError, match="2\\*\\*24"):
        tinfer.make_int8_predict(int8_weights_from_numpy(big, device="cpu"), "v10")
    tinfer.make_int8_predict(qw, "v7")                       # v7 runs it
