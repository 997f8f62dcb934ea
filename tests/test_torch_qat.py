"""The port's QAT fake-quant pass against the JAX package, on the CPU.

The JAX tests' seeded Flax init is carried with ``params_from_flax``; frames
and weights come from NumPy seeds. The quantizers are held bit-equal; the
fake-quant forward to a tolerance (the two frameworks' convolutions sum in
other orders, and a last-bit difference can round an activation the other
way), its labels to agreement; the fine-tune to lowering the loss and to
what PTQ and ``quantize`` accept.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from modulationdetectioncnn_torch import cli
from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2 as TVTCNN2
from modulationdetectioncnn_torch.models.vtcnn2 import flax_params, params_from_flax
from modulationdetectioncnn_torch.train import qat as tqat
from modulationdetectioncnn_torch.train.quant import quantize_params
from modulationdetectioncnn_torch.utils import checkpoint as ckpt
from modulationdetectioncnn_tpu.golden import quant as gq
from modulationdetectioncnn_tpu.models import VTCNN2
from modulationdetectioncnn_tpu.train import qat as jqat
from modulationdetectioncnn_tpu.train.quant import calibrate_activations, quantize


@pytest.fixture(scope="module")
def setup():
    model = VTCNN2(dtype=jnp.float32)
    params = model.init(jax.random.key(0), jnp.zeros((1, 2, 128)))
    x = np.random.default_rng(7).standard_normal((64, 2, 128)).astype(np.float32)
    scales = calibrate_activations(model, params, x)
    return model, params, x, scales


@pytest.mark.parametrize("shape,perm", [((1, 3, 1, 256), (3, 2, 0, 1)),
                                        ((2, 3, 256, 80), (3, 2, 0, 1)),
                                        ((9920, 256), (1, 0)), ((256, 11), (1, 0))],
                         ids=["conv1", "conv2", "dense1", "dense2"])
def test_fake_quant_weight_bit_equal_to_jax(shape, perm):
    """Per output channel: axis -1 of the Flax HWIO/(in, out) kernel is
    axis 0 of the torch OIHW/(out, in) weight; the quantize-dequantize is
    bit-equal, and the STE's gradient is all ones."""
    r = np.random.default_rng(len(shape) + shape[-1])
    w = (r.standard_normal(shape) * r.uniform(0.01, 1, shape[-1])).astype(np.float32)
    want = np.asarray(jqat.fake_quant_weight(jnp.asarray(w)))
    tw = torch.from_numpy(np.ascontiguousarray(w.transpose(perm))).requires_grad_(True)
    got = tqat.fake_quant_weight(tw)
    np.testing.assert_array_equal(got.detach().numpy(), want.transpose(perm))
    got.sum().backward()
    assert torch.equal(tw.grad, torch.ones_like(tw))


@pytest.mark.parametrize("relu_domain", [True, False])
@pytest.mark.parametrize("scale", [0.03198115281232699, 0.0156268463360043, 1.0 / 3])
def test_fake_quant_act_bit_equal_to_jax(scale, relu_domain):
    """The f32 reciprocal of the frozen scale, round half to even, the clip
    to [0 or -127, 127]: bit-equal, half-way and clipped values included."""
    r = np.random.default_rng(5)
    x = (r.standard_normal(4096) * 3).astype(np.float32)
    x[:8] = np.float32(scale) * np.array([0.5, 1.5, 2.5, -0.5, -1.5, 127.5, -130, 200],
                                         np.float32)
    want = np.asarray(jqat.fake_quant_act(jnp.asarray(x), scale, relu_domain))
    got = tqat.fake_quant_act(torch.from_numpy(x), scale, relu_domain).numpy()
    np.testing.assert_array_equal(got, want)


def test_qat_apply_matches_jax(setup):
    """The fake-quant forward from the same carried weights and scales:
    logits within 5e-3 absolute (a fake-quant rounding that falls the other
    way on a last-bit difference moves a logit by about one a3 step times a
    dense2 weight, ~1e-3), labels equal on >= 99 % of frames."""
    _, params, x, scales = setup
    want = np.asarray(jqat.qat_apply(params, jnp.asarray(x), scales))
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    got = tqat.qat_apply(sd, torch.from_numpy(x), scales).detach().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (64, 11)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def test_qat_forward_tracks_int8_chain(setup):
    """As the JAX test: the fake-quant labels predict like the real int8
    deployment chain (golden/quant.py) on >= 90 % of frames."""
    model, params, x, scales = setup
    qm = quantize(model, params, x)
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    logits = tqat.qat_apply(sd, torch.from_numpy(x), scales).detach().numpy()
    assert (logits.argmax(-1) == gq.int8_forward(qm, x).argmax(-1)).mean() >= 0.9


def test_dropout_in_train_mode_only(setup):
    _, params, x, scales = setup
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x[:8])
    e = tqat.qat_apply(sd, xt, scales)
    g = torch.Generator().manual_seed(0)
    t1 = tqat.qat_apply(sd, xt, scales, train=True, generator=g)
    t2 = tqat.qat_apply(sd, xt, scales, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(e, tqat.qat_apply(sd, xt, scales, train=True, dropout_rate=0.0))
    assert torch.equal(t1, t2) and not torch.equal(e, t1)


def test_finetune_qat_improves_fit(setup):
    """As the JAX test: 30 QAT steps reduce the fake-quant loss, the input
    is not changed, and PTQ accepts the result."""
    _, params, _, _ = setup
    r = np.random.default_rng(3)
    x = r.standard_normal((512, 2, 128)).astype(np.float32)
    y = r.integers(0, 11, 512)
    model = TVTCNN2(dtype="float32")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    from modulationdetectioncnn_torch.train.quant import calibrate_activations as tcal

    scales = tcal(model, x[:64])
    sd = {k: v.clone() for k, v in model.state_dict().items()}

    def loss_of(p):
        with torch.no_grad():
            logits = tqat.qat_apply(p, torch.from_numpy(x[:256]), scales)
            return float(F.cross_entropy(logits, torch.from_numpy(y[:256])))

    before = loss_of(sd)
    tuned = tqat.finetune_qat(sd, scales, x, y, num_steps=30, batch_size=128,
                              learning_rate=1e-3, dropout_rate=0.0)
    assert loss_of(tuned) < before
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    assert set(tuned) == set(sd) and all(t.dtype == torch.float32 for t in tuned.values())
    qm = quantize_params(flax_params(tuned), scales)
    assert qm.w1p.shape == (3, 256)


def test_qat_command_writes_what_quantize_reads(tmp_path, capsys):
    """``qat`` on a checkpoint writes ``<dir>_qat/0/params.npz``, which
    ``quantize train.checkpoint_dir=<dir>_qat`` exports to int8."""
    d = str(tmp_path / "ck")
    model = TVTCNN2(num_classes=2, conv1_filters=32, conv2_filters=16, dense_units=32,
                    generator=torch.Generator().manual_seed(0))
    ckpt.save(d, 5, model.state_dict())
    common = ["device=cpu", "data.classes=BPSK,QPSK", "model.num_classes=2",
              "model.conv1_filters=32", "model.conv2_filters=16", "model.dense_units=32",
              "data.frames_per_class_per_snr=4", "data.snr_db_min=10",
              "data.snr_db_max=18", "data.snr_db_step=8", "quant.calib_frames=16"]
    assert cli.main(["qat", *common, f"train.checkpoint_dir={d}", "train.num_steps=3",
                     "train.batch_size=16"]) == 0
    assert f'"qat_checkpoint": "{d}_qat"' in capsys.readouterr().out
    assert os.listdir(f"{d}_qat") == ["0"]
    tuned, _ = ckpt.restore(f"{d}_qat")
    assert not torch.equal(tuned["dense1.weight"], model.state_dict()["dense1.weight"])
    assert cli.main(["quantize", *common, f"train.checkpoint_dir={d}_qat"]) == 0
    assert os.path.isfile(f"{d}_qat_int8/int8.npz")
