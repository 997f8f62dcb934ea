"""The port's v7 conv stage against the JAX package's on v7's edge inputs.

``scripts/probe.py::conv_v7_edge_cases`` builds the trees and frames that
chip_smoke.py holds the CUDA kernel (row 1) to: quantize ties, the largest
conv1 and conv2 sums of both signs, requantize edges, a narrow model padded
to the kernels' widths and a model the v9/v10 fold refuses. Here, on the
CPU, the port's v7 wrapper (its plain version on a CPU tensor) meets the
JAX package's Pallas v7 kernel in interpret mode on the same trees: the
valid map bit for bit, and the classifier's labels equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch.ops import infer as tinfer
from modulationdetectioncnn_torch.quant import int8_weights_from_numpy
from modulationdetectioncnn_torch.scripts.probe import conv_v7_edge_cases
from modulationdetectioncnn_tpu.ops import infer as jinfer
from modulationdetectioncnn_tpu.train.quant import QuantizedModel as JaxQM

KINDS = ("half_ties", "max_sums", "rq_edges", "narrow", "fold_refused")


@pytest.fixture(scope="module")
def cases():
    return conv_v7_edge_cases(seed=15, b=40)


@pytest.mark.parametrize("kind", KINDS)
def test_v7_matches_pallas_v7_on_edge_inputs(cases, kind):
    tree, frames = cases[kind]
    qm = JaxQM.from_tree(tree)
    c2 = qm.m2.shape[0]
    want = np.asarray(jinfer.make_conv_stage(qm, "v7", block_b=8, chunk=4, interpret=True)(
        jnp.asarray(frames)))[:, :124, :c2]
    qw = int8_weights_from_numpy(tree, device="cpu")
    x = torch.from_numpy(frames)
    got = tinfer.conv_stage_int8_v7(x, qw).numpy()
    assert got.shape == (40, 124, c2) and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert 0 < (got > 0).mean() < 1    # a live map, not all clipped
    want_labels = np.asarray(jinfer.make_int8_predict(qm, "v7", interpret=True)(
        jnp.asarray(frames)))
    np.testing.assert_array_equal(tinfer.make_int8_predict(qw, "v7")(x).numpy(), want_labels)
