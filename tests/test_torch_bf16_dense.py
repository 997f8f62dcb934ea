"""The bf16 dense stage (rows 13 and 16 of PERF.md's kernel table) on its
edge maps against the JAX package, on the CPU.

The edge maps and weights are ``scripts/probe.py::dense_bf16_edge_cases``,
the ones chip_smoke.py holds the CUDA kernels to on the card: a map near
2^50 under +-max dense1 weights, exact and one-ulp ties of the logits, and
the narrow 2-class model padded to the kernels' widths, built from the JAX
tests' seeded Flax init with a NumPy seed. The JAX side runs
``_dense_stage_bf16_kernel`` and ``_dense_argmax_bf16_kernel`` alone
through ``pallas_call`` in interpret mode, on the compact (B, 124 * c2) map
with the forwards' weights; the port's wrappers take their plain versions
(``dense_logits_bf16_plain``, ``dense_argmax_bf16_plain``) on CPU tensors.
Tolerances, each with its reason:

- logits: ``2**-7 * sum_d |d1_d| |w4_dc|`` plus 1e-6 of the largest logit
  (each dense1 unit may round to a neighbouring bf16 after f32 sums in
  another order; dense2's f32 sums), classes >= nc at -inf in the port's;
- labels: equal. The near-tie kind's tied logits (classes 3, 5, 7) read
  two dense1 units that each read one map element, so they are exact but
  for rounded adds that no order of the sums changes: bit for bit in both
  packages, and which of the tied classes wins is decided by those adds
  and the lowest index alone.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from modulationdetectioncnn_torch.ops import infer_bf16 as tb
from modulationdetectioncnn_torch.scripts import probe
from modulationdetectioncnn_tpu.models import VTCNN2
from modulationdetectioncnn_tpu.ops import infer as jinfer

RTOL = 2.0 ** -7
KINDS = ("large", "near_tie", "narrow")
NARROW = {"num_classes": 2, "conv1_filters": 32, "conv2_filters": 16, "dense_units": 32}


def _tree(**widths):
    model = VTCNN2(dtype=jnp.float32, **widths)
    params = model.init(jax.random.key(0), jnp.zeros((1, 2, 128)))
    return jax.tree.map(np.asarray, params)["params"]


@pytest.fixture(scope="module")
def edges():
    """{kind: (tree, (37, 124, 80) map, the port's weights)}."""
    cases = probe.dense_bf16_edge_cases(_tree(), _tree(**NARROW), 37, seed=14)
    return {kind: (tree, h, tb.make_bf16_weights(tree, "cpu"))
            for kind, (tree, h) in cases.items()}


def _spec(a):
    return pl.BlockSpec(a.shape, (lambda i: (0,)) if a.ndim == 1 else (lambda i: (0, 0)))


def jax_dense(tree, h, labels):
    """The JAX package's bf16 dense kernel alone (interpret mode) on the
    (B, 124 * c2) map h: ``_dense_argmax_bf16_kernel``'s (B,) labels, or
    ``_dense_stage_bf16_kernel``'s (B, nc) logits."""
    nc = tree["Dense2"]["bias"].shape[0]
    consts = [jnp.asarray(a) for a in (
        np.asarray(tree["Dense1"]["kernel"], np.float32).astype(jnp.bfloat16),
        np.asarray(tree["Dense1"]["bias"], np.float32),
        jinfer._pad_cols(np.asarray(tree["Dense2"]["kernel"], np.float32)).astype(jnp.bfloat16),
        jinfer._pad_cols(np.asarray(tree["Dense2"]["bias"], np.float32)))]
    b, k = h.shape
    width = 1 if labels else 128
    kernel = (functools.partial(jinfer._dense_argmax_bf16_kernel, nc=nc) if labels
              else jinfer._dense_stage_bf16_kernel)
    out = pl.pallas_call(
        kernel, grid=(1,),
        in_specs=[pl.BlockSpec((b, k), lambda i: (i, 0))] + [_spec(a) for a in consts],
        out_specs=pl.BlockSpec((b, width), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((b, width), jnp.int32 if labels else jnp.float32),
        interpret=True,
    )(jnp.asarray(h, jnp.bfloat16), *consts)
    return np.asarray(out)[:, 0] if labels else np.asarray(out)[:, :nc]


def _maps(edges, kind, b):
    tree, h, bw = edges[kind]
    c2 = tree["Conv2"]["bias"].shape[0]
    return tree, bw, torch.from_numpy(h[:b]).to(torch.bfloat16), h[:b, :, :c2].reshape(b, -1)


def test_edge_cases_are_what_they_say(edges):
    """The maps hold bf16 values, zero past the model's lanes; the large
    kind's map sits in [2^50, 2^51] under weights of one magnitude; the
    near-tie kind's plain labels are 3 or 5, both of them (class 7 always
    ties class 3 and loses)."""
    for kind, (tree, h, _) in edges.items():
        c2 = tree["Conv2"]["bias"].shape[0]
        assert h.shape == (37, 124, 80) and h.dtype == np.float32
        assert np.array_equal(torch.from_numpy(h).to(torch.bfloat16).float().numpy(), h)
        assert not h[..., c2:].any() and (h[..., :c2] >= 0).all()
    tree, h, bw = edges["large"]
    assert h.min() >= 2.0 ** 50 and h.max() <= 2.0 ** 51
    assert len(np.unique(np.abs(tree["Dense1"]["kernel"]))) == 1
    _, bw, ht, _ = _maps(edges, "near_tie", 37)
    logits = tb.dense_logits_bf16_plain(ht, bw)
    assert torch.equal(logits[:, 3], logits[:, 7])
    assert set(tb.dense_argmax_bf16_plain(ht, bw).tolist()) == {3, 5}
    assert edges["narrow"][2].nc == 2


@pytest.mark.parametrize("b", [1, 37])
@pytest.mark.parametrize("kind", KINDS)
def test_dense_logits_match_pallas_on_edge_maps(edges, kind, b):
    """Row 13: the port's plain logits (through its CPU wrapper) against
    ``_dense_stage_bf16_kernel`` on the same edge map, within one bf16 ulp
    of every dense1 unit times |w4| plus 1e-6 of the largest logit; classes
    >= nc at -inf."""
    tree, bw, ht, hj = _maps(edges, kind, b)
    got = tb.dense_logits_bf16(ht, bw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, 11)
    assert torch.isinf(got[:, bw.nc:]).all() and (got[:, bw.nc:] < 0).all()
    want = jax_dense(tree, hj, labels=False)
    d1 = tb.dense1_bf16_plain(ht, bw)
    bound = RTOL * (d1.abs() @ bw.w4.to(torch.float32).abs())[:, :bw.nc].numpy()
    diff = np.abs(got[:, :bw.nc].numpy() - want)
    assert np.isfinite(want).all()
    assert (diff <= bound + 1e-6 * np.abs(want).max()).all(), float(diff.max())
    if kind == "near_tie":   # exact but for rounded adds that no sum order changes
        np.testing.assert_array_equal(got[:, [3, 5, 7]].numpy(), want[:, [3, 5, 7]])


@pytest.mark.parametrize("b", [1, 37])
@pytest.mark.parametrize("kind", KINDS)
def test_dense_labels_match_pallas_on_edge_maps(edges, kind, b):
    """Row 16: the port's plain labels (through its CPU wrapper) equal to
    ``_dense_argmax_bf16_kernel``'s on the same edge map."""
    tree, bw, ht, hj = _maps(edges, kind, b)
    got = tb.dense_argmax_bf16(ht, bw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b,)
    np.testing.assert_array_equal(got.numpy(), jax_dense(tree, hj, labels=True))
    np.testing.assert_array_equal(got.numpy(),
                                  tb.argmax_lowest(tb.dense_logits_bf16(ht, bw)).numpy())
