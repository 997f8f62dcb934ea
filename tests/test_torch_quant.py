"""The port's PTQ and v9/v10 weight layouts against the JAX package, on the CPU.

The float model is the JAX tests' random-init VT-CNN2 (``dtype=float32``,
``jax.random.key(0)``), carried to the port by ``params_from_flax``;
calibration frames come from a numpy seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch.models import VTCNN2 as TVTCNN2
from modulationdetectioncnn_torch.models import params_from_flax
from modulationdetectioncnn_torch.quant import (
    QuantizedModel as TorchQM, fold_conv1_weights, int8_weights_from_numpy)
from modulationdetectioncnn_torch.ops import infer as tinfer
from modulationdetectioncnn_torch.train import quant as tquant
from modulationdetectioncnn_tpu.models import VTCNN2
from modulationdetectioncnn_tpu.ops import infer as jinfer
from modulationdetectioncnn_tpu.train import quant as jquant


@pytest.fixture(scope="module")
def models():
    model = VTCNN2(dtype=jnp.float32)
    params = jax.tree.map(
        np.asarray, model.init(jax.random.key(0), jnp.zeros((1, 2, 128))))
    tmodel = TVTCNN2(dtype="float32")
    tmodel.load_state_dict(params_from_flax(params))
    return model, params, tmodel.eval()


@pytest.fixture(scope="module")
def calib():
    return np.random.default_rng(8).standard_normal((64, 2, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def jqm(models, calib):
    model, params, _ = models
    return jquant.quantize(model, params, calib)


def test_calibrate_activations_matches_jax(models, calib):
    """fp32 models on both sides: the four scales within 1e-5 relative (the
    percentile of activations that agree to float32 rounding)."""
    model, params, tmodel = models
    want = jquant.calibrate_activations(model, params, calib)
    got = tquant.calibrate_activations(tmodel, calib)
    assert set(got) == set(want) == {"s_x", "a1", "a2", "a3"}
    for k in want:
        assert got[k] > 0
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_quantize_equals_jax_given_the_same_scales(models, calib, monkeypatch):
    """The 13 arrays are equal when both quantizers see the same scales
    (the JAX module's calibrate_activations is replaced, for this test,
    by one returning the port's)."""
    model, params, tmodel = models
    scales = tquant.calibrate_activations(tmodel, calib)
    got = tquant.quantize(tmodel, calib)
    monkeypatch.setattr(jquant, "calibrate_activations",
                        lambda *a, **k: dict(scales))
    want = jquant.quantize(model, params, calib)
    got_t, want_t = got.tree(), want.tree()
    assert set(got_t) == set(want_t) and len(got_t) == 13
    for k, v in want_t.items():
        v = np.asarray(v)
        assert got_t[k].dtype == v.dtype and got_t[k].shape == v.shape, k
        np.testing.assert_array_equal(got_t[k], v, err_msg=k)


def test_quantize_takes_the_jax_percentile_keyword(models, calib, monkeypatch):
    """``quantize(..., percentile=99.9)`` calibrates at that percentile as
    the JAX quantizer does (its scales within 1e-5 relative of the JAX
    package's, and not the default 99.99's), and from those scales gives
    the JAX package's 13 arrays."""
    model, params, tmodel = models
    seen = {}
    quantize_params = tquant.quantize_params

    def recording(p, scales):
        seen["scales"] = dict(scales)
        return quantize_params(p, scales)

    monkeypatch.setattr(tquant, "quantize_params", recording)
    got = tquant.quantize(tmodel, calib, percentile=99.9).tree()
    want_scales = jquant.calibrate_activations(model, params, calib, percentile=99.9)
    default = jquant.calibrate_activations(model, params, calib)
    assert any(want_scales[k] != default[k] for k in ("a1", "a2", "a3"))
    for k, v in want_scales.items():
        np.testing.assert_allclose(seen["scales"][k], v, rtol=1e-5, err_msg=k)
    assert tquant.calibrate_activations(tmodel, calib, percentile=99.9) == seen["scales"]
    monkeypatch.setattr(jquant, "calibrate_activations",
                        lambda *a, **k: dict(seen["scales"]))
    want = jquant.quantize(model, params, calib, percentile=99.9).tree()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_quantized_port_model_meets_the_fold_contract(models, calib):
    """A model quantized by the port carries to the v9/v10 layouts."""
    qm = tquant.quantize(models[2], calib)
    assert isinstance(qm, TorchQM)
    qw = int8_weights_from_numpy(qm, device="cpu")
    assert qw.w1f.dtype == torch.bfloat16 and tuple(qw.w1f.shape) == (16, 512)


@pytest.mark.parametrize("n", [1, 2, 7, 1000, (1 << 20) + 3, (1 << 24) + 5])
@pytest.mark.parametrize("q", [99.99, 50.0])
def test_percentile_matches_numpy(n, q):
    """At any size, including above torch.quantile's 2**24-element limit.
    jnp.percentile computes the rank q/100*(n-1) in float32, as the port
    does; above 2**21 elements that rank can differ from numpy's float64
    rank by up to one, so the result must lie within one order statistic
    of numpy's interpolation interval."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = tquant.percentile(torch.from_numpy(x), q)
    assert got.dtype == torch.float32 and got.dim() == 0
    got = float(got)
    if n <= 1 << 21:
        np.testing.assert_allclose(got, np.percentile(x, q), rtol=1e-6, atol=1e-7)
    else:
        s = np.sort(x)
        pos = q / 100 * (n - 1)
        lo, hi = max(int(np.floor(pos)) - 1, 0), min(int(np.ceil(pos)) + 1, n - 1)
        assert s[lo] <= got <= s[hi]


@pytest.mark.parametrize("n", [5, 4097, (1 << 24) + 5])
def test_percentile_matches_jnp(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    want = float(jnp.percentile(jnp.asarray(x), 99.99))
    got = float(tquant.percentile(torch.from_numpy(x), 99.99))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_torch_quantile_refuses_what_the_port_percentile_takes():
    x = torch.zeros((1 << 24) + 1)
    with pytest.raises(RuntimeError):
        torch.quantile(x, 0.9999)
    assert float(tquant.percentile(x, 99.99)) == 0.0


def test_folded_layouts_match_jax(jqm):
    """w1f: the JAX expand_conv1_weights_v9f, as bf16, padded with zero rows
    to K=16. w2l: pack_conv2_weights_lane256 without its lane padding."""
    qw = int8_weights_from_numpy(jqm.tree(), device="cpu")
    w1f = qw.w1f.to(torch.float32).numpy()
    np.testing.assert_array_equal(w1f[:8], jinfer.expand_conv1_weights_v9f(jqm))
    assert (w1f[8:] == 0).all()
    np.testing.assert_array_equal(fold_conv1_weights(jqm.w1p, jqm.m1, jqm.o1), w1f[:8])
    c2 = jqm.m2.shape[0]
    cin = jqm.w2p.shape[0] // 2
    w2 = np.asarray(jqm.w2p).reshape(2, cin, 3, c2).transpose(0, 2, 1, 3)
    lane = jinfer.pack_conv2_weights_lane256(w2)
    assert lane.shape == (512, 256) and (lane[:, 3 * c2:] == 0).all()
    np.testing.assert_array_equal(qw.w2l.numpy(), lane[:, :3 * c2])


def _breach(jqm, breach):
    tree = jqm.tree()
    tree["o1"] = tree["o1"].copy()
    if breach == "not_bf16":
        tree["o1"][5] = 257          # 9 significant bits on the 2^-shift grid
    else:
        tree["o1"][5] = 1 << 24      # bf16-exact, but the sum can reach 2**24
    return tree


@pytest.mark.parametrize("breach,match", [
    ("not_bf16", "bf16-exact"), ("acc_2_24", "2\\*\\*24"),
    ("float_shift", "integer requantize shifts")])
def test_fold_contract_violations_raise(jqm, breach, match):
    """A fold breach raises where a v9/v10 path is made (and from the fold
    itself); float shifts, which no kernel reads, raise at carry time."""
    if breach == "float_shift":
        tree = jqm.tree()
        tree["m1"] = tree["m1"].astype(np.float32)
        with pytest.raises(ValueError, match=match):
            int8_weights_from_numpy(tree, device="cpu")
        return
    tree = _breach(jqm, breach)
    with pytest.raises(ValueError, match=match):
        fold_conv1_weights(tree["w1p"], tree["m1"], tree["o1"])
    for version in ("v9", "v10"):
        qw = int8_weights_from_numpy(tree, device="cpu")
        with pytest.raises(ValueError, match=match):
            tinfer.make_int8_predict(qw, version)
        with pytest.raises(ValueError, match=match):
            tinfer.make_conv_stage(qw, version)


@pytest.mark.parametrize("breach", ["not_bf16", "acc_2_24"])
def test_v7_carries_a_model_the_fold_refuses(jqm, calib, breach):
    """The fold's contract gates only v9/v10: v7 carries and classifies a
    model that breaks it, with the JAX package's v7 labels."""
    tree = _breach(jqm, breach)
    x = calib[:8]
    qw = int8_weights_from_numpy(tree, device="cpu")
    got = tinfer.make_int8_predict(qw, "v7")(torch.from_numpy(x)).numpy()
    want = np.asarray(jinfer.make_int8_predict(
        jquant.QuantizedModel(**tree), "v7", interpret=True)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want.reshape(-1))


def test_pow2_requant_refuses_a_scale_above_one():
    with pytest.raises(ValueError, match="scale >= 1"):
        tquant._pow2_requant(1.0, np.array([4.0]), 1.0, np.zeros(1))


def test_per_channel_scale_and_quant_w_match_jax():
    w = np.random.default_rng(2).standard_normal((3, 5, 7))
    w[:, :, 0] = 0.0                    # an all-zero channel takes the floor
    for axes in ((0, 1), (0,)):
        np.testing.assert_array_equal(tquant._per_channel_scale(w, axes),
                                      jquant._per_channel_scale(w, axes))
    s = tquant._per_channel_scale(w, (0, 1))
    np.testing.assert_array_equal(tquant._quant_w(w, s, (None, None, slice(None))),
                                  jquant._quant_w(w, s, (None, None, slice(None))))
