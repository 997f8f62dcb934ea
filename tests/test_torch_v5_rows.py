"""Rows 5 and 10 (the v5 and v1 conv stages) against row 1 (v7), on the CPU.

The CUDA body of rows 5 and 10 (``csrc/conv_stage_int8_v5.cu``) is row 1's:
its producers build conv1 from the frames with the integer spec, reading
each plane's taps from the tap-plane conv1 ``w1e``, and its consumers stage
conv2's weight from ``w2l``. Here, on the CPU, the reference itself is held
to that: the JAX package's v5 and v1 Pallas kernels in interpret mode give
the v7 kernel's whole valid map, and so do the port's plain versions, on
the committed artifact and on row 1's edge models
(``scripts/probe.py::conv_v7_edge_cases``). Then the layouts the kernel
reads by: ``w1e[3h+k, h*C1+c] == w1[k, c]`` (zero elsewhere, both plane
blocks equal) and ``w2l[j, k*C2+co] == w2t[co, k*K1+j]``, on every model the
port builds.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from modulationdetectioncnn_torch.ops import infer as tinfer
from modulationdetectioncnn_torch.quant import (
    C1, C2, DEFAULT_ARTIFACT, QuantizedModel, int8_weights_from_numpy)
from modulationdetectioncnn_torch.scripts.probe import (
    conv_v7_edge_cases, fold_edge_tree, narrow_tree)
from modulationdetectioncnn_tpu.ops import infer as jinfer
from modulationdetectioncnn_tpu.train.quant import QuantizedModel as JaxQM

B, BLOCK_B, CHUNK = 16, 8, 4
EDGE_KINDS = ("half_ties", "max_sums", "rq_edges", "narrow", "fold_refused")


@pytest.fixture(scope="module")
def cases():
    """{model: (tree, (B, 2, 128) f32 frames)}: the artifact on seeded
    frames, and row 1's edge models on their own."""
    art = QuantizedModel.from_npz(DEFAULT_ARTIFACT).tree()
    x = (0.7 * np.random.default_rng(18).standard_normal((B, 2, 128))).astype(np.float32)
    return {"artifact": (art, x), **conv_v7_edge_cases(seed=18, b=B)}


def _spec(a):
    return pl.BlockSpec(a.shape, (lambda i: (0,)) if a.ndim == 1 else (lambda i: (0, 0)))


def _pallas(kern, consts, frames: np.ndarray, t_out: int, lanes: int) -> np.ndarray:
    """``kern`` over ``frames`` in blocks of BLOCK_B, interpret mode: the
    (B, t_out, lanes) int8 output."""
    b = frames.shape[0]
    return np.asarray(pl.pallas_call(
        kern, grid=(b // BLOCK_B,),
        in_specs=[pl.BlockSpec((BLOCK_B, 2, 128), lambda i: (i, 0, 0))]
        + [_spec(a) for a in consts],
        out_specs=pl.BlockSpec((BLOCK_B, t_out, lanes), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, t_out, lanes), jnp.int8), interpret=True,
    )(jnp.asarray(frames), *consts))


def _jax_v5(qm, frames: np.ndarray) -> np.ndarray:
    """The JAX package's v5 conv kernel with ``make_int8_classifier_v5``'s
    constants: the valid (B, 124, c2) map."""
    c2, cin = qm.m2.shape[0], qm.w2p.shape[0] // 2
    w2 = np.asarray(qm.w2p).reshape(2, cin, 3, c2).transpose(0, 2, 1, 3)
    consts = [jnp.asarray(a) for a in (
        jinfer.expand_conv1_weights_tapk(qm.w1p), qm.m1, qm.o1,
        jinfer.pack_conv2_weights_tap384(w2), jinfer._pad_cols(qm.m2), jinfer._pad_cols(qm.o2))]
    kern = functools.partial(jinfer._conv_stage_int8_v5_kernel, chunk=CHUNK,
                             inv_sx=float(1.0 / qm.s_x))
    return _pallas(kern, consts, frames, 128, 128)[:, :124, :c2]


def _jax_v1(qm, frames: np.ndarray) -> np.ndarray:
    """The JAX package's v1 conv kernel with ``make_int8_forward``'s
    constants: the (B, 124, c2) map."""
    c2 = qm.m2.shape[0]
    consts = [jnp.asarray(a) for a in (qm.w1p, qm.m1, qm.o1, qm.w2p, qm.m2, qm.o2)]
    kern = functools.partial(jinfer._conv_stage_int8_kernel, chunk=CHUNK, t_in=128, c2=c2,
                             inv_sx=float(1.0 / qm.s_x))
    return _pallas(kern, consts, frames, 124, c2)


@pytest.mark.parametrize("model", ("artifact", "half_ties", "narrow", "fold_refused"))
def test_v5_and_v1_kernels_compute_v7s_map(cases, model):
    """The JAX v5 and v1 kernels, the JAX v7 conv stage and the port's v5
    and v7 plain versions: one whole valid map, bit for bit."""
    tree, frames = cases[model]
    qm = JaxQM.from_tree(tree)
    c2 = qm.m2.shape[0]
    want = np.asarray(jinfer.make_conv_stage(qm, "v7", block_b=BLOCK_B, chunk=CHUNK,
                                             interpret=True)(jnp.asarray(frames)))[:, :124, :c2]
    assert want.shape == (B, 124, c2) and 0 < (want > 0).mean() < 1   # a live map
    np.testing.assert_array_equal(_jax_v5(qm, frames), want)
    np.testing.assert_array_equal(_jax_v1(qm, frames), want)
    qw = int8_weights_from_numpy(tree, device="cpu")
    x = torch.from_numpy(frames)
    for plain in (tinfer.conv_stage_int8_v5_plain, tinfer.conv_stage_int8_v7_plain):
        np.testing.assert_array_equal(plain(x, qw)[..., :c2].numpy(), want)
    for stage in (tinfer.conv_stage_int8_v5, tinfer.conv_stage_int8_v1):
        np.testing.assert_array_equal(stage(x, qw).numpy(), want)


def _seeded_tree(seed: int) -> dict:
    """The artifact with seeded int8 weights of its spread (chip_smoke.py's
    ``seeded`` model)."""
    rng = np.random.default_rng(seed)
    tree = QuantizedModel.from_npz(DEFAULT_ARTIFACT).tree()
    for k in ("w1p", "w2p", "w3", "w4"):
        std = float(tree[k].astype(np.float64).std())
        tree[k] = np.clip(np.rint(rng.normal(0, std, tree[k].shape)), -127, 127).astype(np.int8)
    return tree


def _models() -> dict:
    art = QuantizedModel.from_npz(DEFAULT_ARTIFACT).tree()
    return {"artifact": art, "seeded": _seeded_tree(18), "narrow": narrow_tree(18),
            "fold_edge": fold_edge_tree(18),
            **{f"v7_edge_{k}": t for k, (t, _) in conv_v7_edge_cases(seed=18, b=2).items()}}


@pytest.fixture(scope="module")
def models():
    return {name: int8_weights_from_numpy(tree, device="cpu") for name, tree in _models().items()}


@pytest.mark.parametrize("model", ("artifact", "seeded", "narrow", "fold_edge",
                                   *(f"v7_edge_{k}" for k in EDGE_KINDS)))
def test_layouts_the_v5_body_reads(models, model):
    """w1e's plane blocks are w1 (zero elsewhere, both blocks equal), and
    w2l is w2t's transpose by tap: the producers read each plane's taps
    from its block, the consumers stage conv2 from w2l."""
    qw = models[model]
    w1, w1e = qw.w1.numpy(), qw.w1e.numpy()
    assert w1.shape == (3, C1) and w1e.shape == (8, 2 * C1)
    want = np.zeros_like(w1e)
    for h in range(2):
        want[3 * h:3 * h + 3, h * C1:(h + 1) * C1] = w1
    np.testing.assert_array_equal(w1e, want)
    np.testing.assert_array_equal(w1e[0:3, :C1], w1e[3:6, C1:])
    k1 = 2 * C1
    w2l, w2t = qw.w2l.numpy(), qw.w2t.numpy()
    assert w2l.shape == (k1, 3 * C2) and w2t.shape == (C2, 3 * k1)
    np.testing.assert_array_equal(
        w2l.reshape(k1, 3, C2), w2t.reshape(C2, 3, k1).transpose(2, 1, 0))
    assert np.any(w1) and np.any(w2l)
