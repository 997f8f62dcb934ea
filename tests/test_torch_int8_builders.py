"""The port's int8 builders take what the JAX package's take, on the CPU.

The JAX builders (``make_int8_predict``, ``make_int8_classifier_v*``,
``make_int8_forward``, ``make_int8_forward_v2``, ``make_conv_stage``,
``infer_xla.make_int8_forward_xla``) take what ``train/quant.py::quantize``
returns. The port's take that model's fields as a mapping of NumPy arrays,
the port's own ``QuantizedModel`` or a carried ``Int8Weights``, and accept
``interpret``. The same seeded frames go through the JAX builders (Pallas
in interpret mode) and the port's (plain versions on the CPU): labels and
maps are equal, logits within 1 ulp (the JAX kernels' f32 dequantize may
round once where the port rounds twice, as ``tests/test_torch_infer.py``
states).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch.ops import infer as tinfer
from modulationdetectioncnn_torch.ops import infer_xla as txla
from modulationdetectioncnn_torch.quant import (
    Int8Weights,
    QuantizedModel as TorchQM,
    int8_weights_from_numpy,
)
from modulationdetectioncnn_tpu.models import VTCNN2
from modulationdetectioncnn_tpu.ops import infer as jinfer
from modulationdetectioncnn_tpu.ops import infer_xla as jxla

VERSIONS = ("v1", "v2", "v3", "v4", "v5", "v6", "v7", "v9", "v10")
CLASSIFIERS = ("v3", "v4", "v5", "v6", "v7", "v9", "v10")
N_FRAMES = 8


@pytest.fixture(scope="module")
def qm():
    """The JAX tests' random-init VT-CNN2, quantized by train/quant.py: what
    the JAX builders take."""
    from modulationdetectioncnn_tpu.train.quant import quantize

    model = VTCNN2(dtype=jnp.float32)
    params = jax.tree.map(
        np.asarray, model.init(jax.random.key(0), jnp.zeros((1, 2, 128))))
    calib = np.random.default_rng(8).standard_normal((64, 2, 128)).astype(np.float32)
    return quantize(model, params, calib)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(11).standard_normal((N_FRAMES, 2, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_labels(qm, frames):
    """Each JAX classifier's labels on the frames, in interpret mode."""
    return {v: np.asarray(jinfer.make_int8_predict(qm, v, interpret=True)(jnp.asarray(frames)))
            for v in VERSIONS}


@pytest.fixture(scope="module")
def carried(qm):
    return int8_weights_from_numpy(qm.tree(), device="cpu")


@pytest.mark.parametrize("version", VERSIONS)
def test_predict_takes_the_jax_models_arrays(qm, frames, jax_labels, carried, version):
    """``make_int8_predict`` on the JAX ``QuantizedModel``'s fields: the JAX
    builder's labels, and the carried ``Int8Weights`` path's."""
    x = torch.from_numpy(frames)
    got = tinfer.make_int8_predict(qm.tree(), version, device="cpu")(x).numpy()
    via_weights = tinfer.make_int8_predict(carried, version)(x).numpy()
    np.testing.assert_array_equal(got, jax_labels[version])
    np.testing.assert_array_equal(via_weights, jax_labels[version])


@pytest.mark.parametrize("version", CLASSIFIERS)
def test_classifier_names_match_jax(qm, frames, jax_labels, version):
    """The seven ``make_int8_classifier_v*`` names, given the tree and given
    the JAX model object itself (its ``tree()``)."""
    make = getattr(tinfer, f"make_int8_classifier_{version}")
    x = torch.from_numpy(frames)
    np.testing.assert_array_equal(make(qm.tree(), device="cpu")(x).numpy(),
                                  jax_labels[version])
    np.testing.assert_array_equal(make(qm, device="cpu")(x).numpy(), jax_labels[version])


@pytest.mark.parametrize("name", ["make_int8_forward", "make_int8_forward_v2"])
def test_forwards_take_the_tree_and_match_jax(qm, frames, carried, name):
    """v1's and v2's logits from the tree: equal to the ``Int8Weights``
    path's, within 1 ulp of the JAX builder's (interpret mode)."""
    x = torch.from_numpy(frames)
    got = getattr(tinfer, name)(qm.tree(), device="cpu")(x).numpy()
    np.testing.assert_array_equal(got, getattr(tinfer, name)(carried)(x).numpy())
    want = np.asarray(getattr(jinfer, name)(qm, block_b=8, chunk=4, dense_block_b=8,
                                            interpret=True)(jnp.asarray(frames)))
    np.testing.assert_array_max_ulp(got, want[:, :got.shape[1]], maxulp=1)


@pytest.mark.parametrize("version", ["v7", "v9", "v10"])
def test_conv_stage_takes_the_tree_and_matches_jax(qm, frames, version):
    """``make_conv_stage`` from the tree and from the port's
    ``QuantizedModel``: the JAX conv stage's valid map, bit for bit."""
    c2 = qm.m2.shape[0]
    want = np.asarray(jinfer.make_conv_stage(qm, version, block_b=8, chunk=4, interpret=True)(
        jnp.asarray(frames)))[:, :124, :c2]
    x = torch.from_numpy(frames)
    got = tinfer.make_conv_stage(qm.tree(), version, device="cpu")(x).numpy()
    port_qm = TorchQM.from_tree(qm.tree())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tinfer.make_conv_stage(port_qm, version, device="cpu")(x).numpy(), want)


def test_forward_xla_takes_the_tree_and_matches_jax(qm, frames, carried):
    """``make_int8_forward_xla`` from the tree: JAX's XLA chain's logits
    within 1 ulp, and the ``Int8Weights`` path's bit for bit."""
    x = torch.from_numpy(frames)
    got = txla.make_int8_forward_xla(qm.tree(), device="cpu")(x).numpy()
    np.testing.assert_array_equal(got, txla.make_int8_forward_xla(carried)(x).numpy())
    nc = qm.b4.shape[0]
    want = np.asarray(jxla.make_int8_forward_xla(qm)(jnp.asarray(frames)))[:, :nc]
    np.testing.assert_array_max_ulp(got[:, :nc], want, maxulp=1)
    np.testing.assert_array_equal(
        txla.make_int8_predict_xla(qm.tree(), device="cpu")(x).numpy(), got.argmax(-1))


@pytest.mark.parametrize("version", ["v7", "v2"])
def test_interpret_runs_the_plain_versions_on_the_cpu(qm, frames, jax_labels, version):
    """``interpret=True`` carries the model to the CPU with no ``device``."""
    x = torch.from_numpy(frames)
    got = tinfer.make_int8_predict(qm.tree(), version, interpret=True)(x)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), jax_labels[version])
    logits = txla.make_int8_forward_xla(qm.tree(), interpret=True)(x)
    assert logits.device.type == "cpu"


def test_interpret_refuses_weights_on_a_card(carried, monkeypatch):
    """``interpret=True`` with ``Int8Weights`` on a CUDA device raises: the
    weights are never moved silently (the device is faked on the CPU)."""
    monkeypatch.setattr(Int8Weights, "device", property(lambda self: torch.device("cuda", 0)))
    for build in (lambda: tinfer.make_int8_predict(carried, "v7", interpret=True),
                  lambda: tinfer.make_int8_classifier_v10(carried, interpret=True),
                  lambda: tinfer.make_conv_stage(carried, interpret=True),
                  lambda: txla.make_int8_forward_xla(carried, interpret=True)):
        with pytest.raises(ValueError, match="interpret"):
            build()
    with pytest.raises(ValueError, match="interpret"):
        tinfer.make_int8_forward({}, device="cuda", interpret=True)


def test_without_a_card_the_default_device_raises(qm, monkeypatch):
    """With no card and no ``device="cpu"`` the builders raise instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tinfer.make_int8_predict(qm.tree(), "v7"),
                  lambda: tinfer.make_int8_classifier_v3(qm.tree()),
                  lambda: tinfer.make_int8_forward_v2(qm.tree()),
                  lambda: tinfer.make_conv_stage(qm.tree(), "v7"),
                  lambda: txla.make_int8_forward_xla(qm.tree())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    with pytest.raises(TypeError):
        tinfer.make_int8_predict(object(), "v7", device="cpu")
