"""Rows 8 and 9 (the v3 and v2 conv stages) against row 1 (v7), on the CPU.

The CUDA body of rows 8 and 9 (``csrc/conv_stage_int8_v3.cu``) is rows 6
and 7's, with producers that read tap rows in place of tap planes: the
windows of conv1 row t of both I/Q planes are lanes 0..2 and 3..5 of row t,
against each plane's taps from its own block of ``w1e``. It reads lanes
0..5 only, and each lane reads only its own row, never a neighbour's. Here,
on the CPU, the reference is held to what that rests on: the JAX package's
v3 and v2 Pallas kernels in interpret mode give the port's plain version's
map and the v7 kernel's whole valid map on the committed artifact and on
row 1's edge models (``scripts/probe.py::conv_v7_edge_cases``); on random
rows, all 8 lanes of every row drawn on their own (so a row is no shifted
copy of its neighbour, and a body that rebuilt windows from neighbouring
rows would differ), the JAX v3 and v2 kernels and the port's plain version
agree bit for bit; and the plain map does not move when lanes 6 and 7 are
drawn again. ``w1e``'s zeros where the body does not read are held on every
model the port builds by ``tests/test_torch_v6_rows.py``.
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
    DEFAULT_ARTIFACT, QuantizedModel, int8_weights_from_numpy)
from modulationdetectioncnn_torch.scripts.probe import conv_v7_edge_cases
from modulationdetectioncnn_tpu.ops import infer as jinfer
from modulationdetectioncnn_tpu.train.quant import QuantizedModel as JaxQM

B, BLOCK_B, CHUNK, T1 = 16, 8, 4, 126
EDGE_KINDS = ("half_ties", "max_sums", "rq_edges", "narrow", "fold_refused")


@pytest.fixture(scope="module")
def cases():
    """{model: (tree, (B, 2, 128) f32 frames)}: the artifact on seeded
    frames, and row 1's edge models on their own."""
    art = QuantizedModel.from_npz(DEFAULT_ARTIFACT).tree()
    x = (0.7 * np.random.default_rng(21).standard_normal((B, 2, 128))).astype(np.float32)
    return {"artifact": (art, x), **conv_v7_edge_cases(seed=21, b=B)}


def _random_rows(seed: int) -> np.ndarray:
    """(B, 126, 8) int8 rows over all of int8, every lane of every row drawn
    on its own, lanes 6 and 7 too."""
    return np.random.default_rng(seed).integers(-128, 128, (B, T1, 8), dtype=np.int8)


def _spec(a):
    return pl.BlockSpec(a.shape, (lambda i: (0,)) if a.ndim == 1 else (lambda i: (0, 0)))


def _jax_rows_stage(qm, rows: np.ndarray, version: str) -> np.ndarray:
    """The JAX package's tap-row conv kernel of ``version`` (v3's, with
    ``make_int8_classifier_v3``'s constants and its (B, 126, 128) output,
    or v2's, with ``make_int8_forward_v2``'s and its (B, 124, c2) output)
    over ``rows`` in blocks of BLOCK_B, interpret mode: the valid (B, 124,
    c2) map."""
    c2, cin = qm.m2.shape[0], qm.w2p.shape[0] // 2
    w1e = jinfer.expand_conv1_weights(qm.w1p)
    if version == "v3":
        w2 = np.asarray(qm.w2p).reshape(2, cin, 3, c2).transpose(0, 2, 1, 3)
        consts = (w1e, qm.m1, qm.o1, jinfer.pack_conv2_weights_tapk(w2),
                  jinfer._pad_cols(qm.m2), jinfer._pad_cols(qm.o2))
        kernel = functools.partial(jinfer._conv_stage_int8_v3_kernel, chunk=CHUNK, t1=T1)
        out_rows, lanes = T1, 128
    else:
        consts = (w1e, qm.m1, qm.o1, qm.w2p, qm.m2, qm.o2)
        kernel = functools.partial(jinfer._conv_stage_int8_v2_kernel, chunk=CHUNK, t1=T1,
                                   c2=c2)
        out_rows, lanes = T1 - 2, c2
    consts = [jnp.asarray(a) for a in consts]
    b = rows.shape[0]
    out = pl.pallas_call(
        kernel, grid=(b // BLOCK_B,),
        in_specs=[pl.BlockSpec((BLOCK_B * T1, 8), lambda i: (i, 0))]
        + [_spec(a) for a in consts],
        out_specs=pl.BlockSpec((BLOCK_B, out_rows, lanes), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, out_rows, lanes), jnp.int8), interpret=True,
    )(jnp.asarray(rows).reshape(b * T1, 8), *consts)
    return np.asarray(out)[:, :T1 - 2, :c2]


VERSIONS = ("v3", "v2")


@pytest.mark.parametrize("model", ("artifact", *EDGE_KINDS))
def test_v3_and_v2_kernels_compute_v7s_map(cases, model):
    """The JAX v3 and v2 kernels on the JAX prologue's tap rows, the JAX v7
    conv stage, and the port's rows plain version and wrappers on the
    port's tap rows: one whole valid map, bit for bit; the port's rows
    equal the JAX prologue's."""
    tree, frames = cases[model]
    qm = JaxQM.from_tree(tree)
    c2 = qm.m2.shape[0]
    want = np.asarray(jinfer.make_conv_stage(qm, "v7", block_b=BLOCK_B, chunk=CHUNK,
                                             interpret=True)(jnp.asarray(frames)))[:, :124, :c2]
    assert want.shape == (B, 124, c2) and 0 < (want > 0).mean() < 1   # a live map
    xq = jnp.clip(jnp.round(jnp.asarray(frames) * float(1.0 / qm.s_x)), -127.0, 127.0)
    jrows = np.asarray(jinfer.expand_taps(xq.astype(jnp.int8), T1))
    for version in VERSIONS:
        np.testing.assert_array_equal(_jax_rows_stage(qm, jrows, version), want)
    qw = int8_weights_from_numpy(tree, device="cpu")
    rows = tinfer.expand_taps(torch.from_numpy(frames), qw.inv_sx)
    np.testing.assert_array_equal(rows.numpy(), jrows)
    np.testing.assert_array_equal(
        tinfer.conv_stage_int8_taps_plain(rows, qw)[..., :c2].numpy(), want)
    for stage in (tinfer.conv_stage_int8_v3, tinfer.conv_stage_int8_v2):
        np.testing.assert_array_equal(stage(rows, qw).numpy(), want)


@pytest.mark.parametrize("model", ("artifact", "max_sums", "rq_edges", "narrow"))
@pytest.mark.parametrize("version", VERSIONS)
def test_random_rows_jax_kernel_and_plain_agree(cases, model, version):
    """On random rows over all of int8, every lane of every row drawn on
    its own, the JAX kernel and the port's plain version give one map, bit
    for bit: the function rows 8 and 9 claim on any rows, not only on rows
    that are shifted copies of one frame."""
    tree, _ = cases[model]
    qm = JaxQM.from_tree(tree)
    c2 = qm.m2.shape[0]
    rows = _random_rows(8)
    assert np.any(rows[:, 1:, 0] != rows[:, :-1, 1])   # not the shifted copies expand_taps makes
    got = _jax_rows_stage(qm, rows, version)
    qw = int8_weights_from_numpy(tree, device="cpu")
    want = tinfer.conv_stage_int8_taps_plain(torch.from_numpy(rows), qw)[..., :c2].numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (want > 0).mean()                                          # a live map


@pytest.mark.parametrize("model", ("artifact", *EDGE_KINDS))
def test_lanes_the_body_skips_do_not_move_the_map(cases, model):
    """The plain map of random rows is the same when lanes 6 and 7 of every
    row are drawn again: the rows body, which never reads them, computes
    the plain version's function."""
    tree, _ = cases[model]
    qw = int8_weights_from_numpy(tree, device="cpu")
    rows = _random_rows(9)
    other = rows.copy()
    other[:, :, 6:] = _random_rows(10)[:, :, 6:]
    assert np.any(other != rows)
    maps = [tinfer.conv_stage_int8_taps_plain(torch.from_numpy(r), qw) for r in (rows, other)]
    np.testing.assert_array_equal(maps[0].numpy(), maps[1].numpy())
