"""The port's VT-CNN2 (torch) against the Flax model, on the CPU.

The Flax model is initialised as tests/test_ops_infer.py does it
(``VTCNN2(dtype=float32)``, ``jax.random.key(0)``) and its parameters are
carried to the port by ``params_from_flax``; both run the same numpy frames.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch.config import ModelConfig
from modulationdetectioncnn_torch.models import VTCNN2 as TVTCNN2
from modulationdetectioncnn_torch.models import flax_params, params_from_flax
from modulationdetectioncnn_tpu.models import VTCNN2


@pytest.fixture(scope="module")
def flax_tree():
    model = VTCNN2(dtype=jnp.float32)
    return jax.tree.map(
        np.asarray, model.init(jax.random.key(0), jnp.zeros((1, 2, 128))))


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(7).standard_normal((256, 2, 128)).astype(np.float32)


def _torch_model(tree, dtype):
    m = TVTCNN2(dtype=dtype)
    m.load_state_dict(params_from_flax(tree))
    return m.eval()


def test_fp32_logits_match_flax(flax_tree, frames):
    """fp32 on both sides: within 1e-4 abs (the two libraries sum the conv
    and dense products in different orders; the logits are O(1))."""
    want = np.asarray(VTCNN2(dtype=jnp.float32).apply(flax_tree, jnp.asarray(frames)))
    with torch.no_grad():
        got = _torch_model(flax_tree, "float32")(torch.from_numpy(frames)).numpy()
    assert got.dtype == np.float32 and got.shape == (256, 11)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_bf16_compute_matches_flax_bf16(flax_tree, frames):
    """bf16 compute, fp32 params, on both sides. bf16 keeps 8 significant
    bits and the two libraries round intermediate sums at different
    places, so logits agree within 5e-2 abs (the tolerance the JAX tests
    give bf16 against golden) and labels on >= 99 % of 256 frames."""
    want = np.asarray(VTCNN2(dtype=jnp.bfloat16).apply(flax_tree, jnp.asarray(frames)))
    with torch.no_grad():
        got = _torch_model(flax_tree, "bfloat16")(torch.from_numpy(frames)).numpy()
    assert got.dtype == np.float32
    assert np.max(np.abs(got - want)) < 5e-2
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def test_intermediates_are_the_pre_relu_layer_outputs(flax_tree, frames):
    """The captured Conv1/Conv2/Dense1 outputs equal Flax's
    capture_intermediates (pre-ReLU), up to layout (NCHW vs NHWC)."""
    x = frames[:8]
    _, inter = VTCNN2(dtype=jnp.float32).apply(
        flax_tree, jnp.asarray(x), capture_intermediates=True)
    inter = inter["intermediates"]
    got: dict = {}
    with torch.no_grad():
        _torch_model(flax_tree, "float32")(torch.from_numpy(x), got)
    np.testing.assert_allclose(got["Conv1"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(inter["Conv1"]["__call__"][0]), atol=1e-5)
    np.testing.assert_allclose(got["Conv2"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(inter["Conv2"]["__call__"][0]), atol=1e-5)
    np.testing.assert_allclose(got["Dense1"].numpy(),
                               np.asarray(inter["Dense1"]["__call__"][0]), atol=1e-4)
    assert (got["Conv1"] < 0).any()  # pre-ReLU


def test_flax_params_round_trip(flax_tree):
    back = flax_params(_torch_model(flax_tree, "float32"))
    for layer in ("Conv1", "Conv2", "Dense1", "Dense2"):
        for k in ("kernel", "bias"):
            want = flax_tree["params"][layer][k]
            assert back[layer][k].shape == want.shape
            np.testing.assert_array_equal(back[layer][k], want)


@pytest.mark.parametrize("layer,fan_in", [("conv1", 3), ("conv2", 1536),
                                          ("dense1", 9920), ("dense2", 256)])
def test_flax_style_init(layer, fan_in):
    """lecun_normal: truncated normal with variance 1/fan_in (std within
    10 %), truncated at 2 std of the underlying normal; biases zero."""
    m = TVTCNN2.from_config(ModelConfig(), generator=torch.Generator().manual_seed(0))
    w = getattr(m, layer).weight.detach().double()
    assert (getattr(m, layer).bias == 0).all()
    want = math.sqrt(1.0 / fan_in)
    assert abs(float(w.std()) / want - 1) < 0.1
    assert float(w.abs().max()) <= 2 * want / 0.87962566103423978 + 1e-6
    assert abs(float(w.mean())) < 0.1 * want


def test_init_is_seeded():
    a = TVTCNN2(generator=torch.Generator().manual_seed(3)).state_dict()
    b = TVTCNN2(generator=torch.Generator().manual_seed(3)).state_dict()
    c = TVTCNN2(generator=torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv2.weight"], c["conv2.weight"])


def test_dropout_only_in_train_mode(frames):
    m = TVTCNN2(dtype="float32", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(frames[:4])
    with torch.no_grad():
        e1, e2 = m.eval()(x), m(x)
        torch.manual_seed(0)
        t1 = m.train()(x)
    assert torch.equal(e1, e2) and not torch.equal(e1, t1)
