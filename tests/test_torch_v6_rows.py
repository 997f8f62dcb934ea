"""Rows 6 and 7 (the v6 and v4 conv stages) against row 1 (v7), on the CPU.

The CUDA body of rows 6 and 7 (``csrc/conv_stage_int8_v6.cu``) is row 1's
and rows 5 and 10's, with producers that read tap planes in place of
quantizing frames: the window of conv1 row t of I/Q plane h is column t of
planes 3h, 3h+1 and 3h+2, against that plane's taps from its own block of
``w1e``. It reads planes 0..5 only, columns 0..125 only, and each plane's
own block of ``w1e`` only. Here, on the CPU, the reference is held to what
that rests on: the JAX package's v4 and v6 Pallas kernels in interpret mode
give the port's plain version's map and the v7 kernel's whole valid map on
the committed artifact and on row 1's edge models
(``scripts/probe.py::conv_v7_edge_cases``); on random planes, all 8 planes
and the two tail columns drawn, the JAX v4 and v6 kernels and the port's
plain version agree bit for bit, and the plain map does not move when
planes 6 and 7 and columns 126 and 127 are drawn again; and ``w1e`` is zero
off each plane's block and in rows 6 and 7 on every model the port builds.
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
    C1, DEFAULT_ARTIFACT, QuantizedModel, int8_weights_from_numpy)
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
    x = (0.7 * np.random.default_rng(19).standard_normal((B, 2, 128))).astype(np.float32)
    return {"artifact": (art, x), **conv_v7_edge_cases(seed=19, b=B)}


def _random_planes(seed: int) -> np.ndarray:
    """(B, 8, 128) int8 planes over all of int8, planes 6 and 7 and the two
    tail columns drawn too."""
    return np.random.default_rng(seed).integers(-128, 128, (B, 8, 128), dtype=np.int8)


def _spec(a):
    return pl.BlockSpec(a.shape, (lambda i: (0,)) if a.ndim == 1 else (lambda i: (0, 0)))


def _jax_planes_stage(qm, planes: np.ndarray, kernel) -> np.ndarray:
    """The JAX package's tap-plane conv kernel ``kernel`` (v4's or v6's)
    with ``make_int8_classifier_v4``'s constants over ``planes`` in blocks
    of BLOCK_B, interpret mode: the valid (B, 124, c2) map of its (B, 128,
    128) output."""
    c2, cin = qm.m2.shape[0], qm.w2p.shape[0] // 2
    w2 = np.asarray(qm.w2p).reshape(2, cin, 3, c2).transpose(0, 2, 1, 3)
    consts = [jnp.asarray(a) for a in (
        jinfer.expand_conv1_weights(qm.w1p), qm.m1, qm.o1,
        jinfer.pack_conv2_weights_tap384(w2), jinfer._pad_cols(qm.m2), jinfer._pad_cols(qm.o2))]
    b = planes.shape[0]
    out = pl.pallas_call(
        functools.partial(kernel, chunk=CHUNK), grid=(b // BLOCK_B,),
        in_specs=[pl.BlockSpec((BLOCK_B, 8, 128), lambda i: (i, 0, 0))]
        + [_spec(a) for a in consts],
        out_specs=pl.BlockSpec((BLOCK_B, 128, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, 128, 128), jnp.int8), interpret=True,
    )(jnp.asarray(planes), *consts)
    return np.asarray(out)[:, :124, :c2]


KERNELS = {"v4": jinfer._conv_stage_int8_v4_kernel, "v6": jinfer._conv_stage_int8_v6_kernel}


@pytest.mark.parametrize("model", ("artifact", *EDGE_KINDS))
def test_v4_and_v6_kernels_compute_v7s_map(cases, model):
    """The JAX v4 and v6 kernels on the JAX prologue's tap planes, the JAX
    v7 conv stage, and the port's planes plain version on the port's tap
    planes: one whole valid map, bit for bit; the port's planes equal the
    JAX prologue's."""
    tree, frames = cases[model]
    qm = JaxQM.from_tree(tree)
    c2 = qm.m2.shape[0]
    want = np.asarray(jinfer.make_conv_stage(qm, "v7", block_b=BLOCK_B, chunk=CHUNK,
                                             interpret=True)(jnp.asarray(frames)))[:, :124, :c2]
    assert want.shape == (B, 124, c2) and 0 < (want > 0).mean() < 1   # a live map
    xq = jnp.clip(jnp.round(jnp.asarray(frames) * float(1.0 / qm.s_x)), -127.0, 127.0)
    jplanes = np.asarray(jinfer.expand_tap_planes(xq.astype(jnp.int8)))
    for kernel in KERNELS.values():
        np.testing.assert_array_equal(_jax_planes_stage(qm, jplanes, kernel), want)
    qw = int8_weights_from_numpy(tree, device="cpu")
    planes = tinfer.tap_planes(torch.from_numpy(frames), qw.inv_sx)
    np.testing.assert_array_equal(planes.numpy(), jplanes)
    np.testing.assert_array_equal(
        tinfer.conv_stage_int8_planes_plain(planes, qw)[..., :c2].numpy(), want)
    for stage in (tinfer.conv_stage_int8_v6, tinfer.conv_stage_int8_v4):
        np.testing.assert_array_equal(stage(planes, qw).numpy(), want)


@pytest.mark.parametrize("model", ("artifact", "max_sums", "rq_edges", "narrow"))
@pytest.mark.parametrize("version", tuple(KERNELS))
def test_random_planes_jax_kernel_and_plain_agree(cases, model, version):
    """On random planes over all of int8, planes 6 and 7 and the tail
    columns drawn too, the JAX kernel and the port's plain version give one
    map, bit for bit: the function rows 6 and 7 claim on any planes."""
    tree, _ = cases[model]
    qm = JaxQM.from_tree(tree)
    c2 = qm.m2.shape[0]
    planes = _random_planes(6)
    got = _jax_planes_stage(qm, planes, KERNELS[version])
    qw = int8_weights_from_numpy(tree, device="cpu")
    want = tinfer.conv_stage_int8_planes_plain(torch.from_numpy(planes), qw)[..., :c2].numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (want > 0).mean()                                          # a live map


@pytest.mark.parametrize("model", ("artifact", *EDGE_KINDS))
def test_planes_the_body_skips_do_not_move_the_map(cases, model):
    """The plain map of random planes is the same when planes 6 and 7 and
    columns 126 and 127 of every plane are drawn again: the planes body,
    which reads neither, computes the plain version's function."""
    tree, _ = cases[model]
    qw = int8_weights_from_numpy(tree, device="cpu")
    planes = _random_planes(7)
    other = planes.copy()
    redraw = _random_planes(8)
    other[:, 6:] = redraw[:, 6:]
    other[:, :, 126:] = redraw[:, :, 126:]
    assert np.any(other != planes)
    maps = [tinfer.conv_stage_int8_planes_plain(torch.from_numpy(p), qw) for p in (planes, other)]
    np.testing.assert_array_equal(maps[0].numpy(), maps[1].numpy())


def _seeded_tree(seed: int) -> dict:
    """The artifact with seeded int8 weights of its spread (chip_smoke.py's
    ``seeded`` model)."""
    rng = np.random.default_rng(seed)
    tree = QuantizedModel.from_npz(DEFAULT_ARTIFACT).tree()
    for k in ("w1p", "w2p", "w3", "w4"):
        std = float(tree[k].astype(np.float64).std())
        tree[k] = np.clip(np.rint(rng.normal(0, std, tree[k].shape)), -127, 127).astype(np.int8)
    return tree


@pytest.fixture(scope="module")
def models():
    trees = {"artifact": QuantizedModel.from_npz(DEFAULT_ARTIFACT).tree(),
             "seeded": _seeded_tree(19), "narrow": narrow_tree(19), "fold_edge": fold_edge_tree(19),
             **{f"v7_edge_{k}": t for k, (t, _) in conv_v7_edge_cases(seed=19, b=2).items()}}
    return {name: int8_weights_from_numpy(tree, device="cpu") for name, tree in trees.items()}


@pytest.mark.parametrize("model", ("artifact", "seeded", "narrow", "fold_edge",
                                   *(f"v7_edge_{k}" for k in EDGE_KINDS)))
def test_w1e_is_zero_where_the_planes_body_does_not_read(models, model):
    """w1e's rows 6 and 7 and each plane's block of the other plane's
    columns are zero, and each plane's own block is live: the layout that
    lets the planes body skip planes 6 and 7 and the other block."""
    w1e = models[model].w1e.numpy()
    assert w1e.shape == (8, 2 * C1)
    assert not np.any(w1e[6:])
    for h in range(2):
        rows = slice(3 * h, 3 * h + 3)
        assert not np.any(w1e[rows, (1 - h) * C1:(2 - h) * C1])
        assert np.any(w1e[rows, h * C1:(h + 1) * C1])
