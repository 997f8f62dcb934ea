"""The port's v4, v5 and v6 conv stages, the padded carry of narrow models
and the ``xla_int8`` chain, against the JAX package on the CPU.

The model is the JAX tests' random-init VT-CNN2 quantized by the JAX
package's ``train/quant.py``; frames come from numpy seeds. The JAX side
runs its Pallas classifiers in interpret mode and its NumPy golden chain;
the port's wrappers run their plain versions on CPU tensors. The integer
chain is held bit-exact: maps and labels must be equal, with no tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch.ops import infer as tinfer
from modulationdetectioncnn_torch.ops import infer_xla
from modulationdetectioncnn_torch.quant import (
    QuantizedModel as TorchQM, expand_conv1_weights, int8_weights_from_numpy,
    load_int8, pad_to_kernel_widths)
from modulationdetectioncnn_tpu.golden import quant as gq
from modulationdetectioncnn_tpu.models import VTCNN2
from modulationdetectioncnn_tpu.ops import infer as jinfer

VERSIONS = ("v5", "v6", "v4")


@pytest.fixture(scope="module")
def qm():
    from modulationdetectioncnn_tpu.train.quant import quantize

    model = VTCNN2(dtype=jnp.float32)
    params = jax.tree.map(
        np.asarray, model.init(jax.random.key(0), jnp.zeros((1, 2, 128))))
    calib = np.random.default_rng(8).standard_normal((64, 2, 128)).astype(np.float32)
    return quantize(model, params, calib)


@pytest.fixture(scope="module")
def qw(qm):
    return int8_weights_from_numpy(qm.tree(), device="cpu")


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(7).standard_normal((16, 2, 128)).astype(np.float32)


def _golden_map(qm, x):
    a1 = gq.conv1_int8(gq.quantize_input(x, qm.s_x), qm.w1p, qm.m1, qm.o1)
    return gq.conv2_int8(a1, qm.w2p, qm.m2, qm.o2)


def test_tap_planes_equal_jax_expand_tap_planes(qm, qw, frames):
    """The v4/v6 prologue: quantize, then JAX's expand_tap_planes."""
    x = frames.copy()
    x[0, 0, :4] = (np.arange(4) + 0.5).astype(np.float32) * np.float32(qm.s_x)
    want = np.asarray(jinfer.expand_tap_planes(
        jnp.asarray(gq.quantize_input(x, qm.s_x))))
    got = tinfer.tap_planes(torch.from_numpy(x), qw.inv_sx).numpy()
    assert got.dtype == np.int8 and got.shape == (16, 8, 128)
    np.testing.assert_array_equal(got, want)


def test_tap_plane_conv1_weights_equal_jax(qm, qw):
    np.testing.assert_array_equal(qw.w1e.numpy(), jinfer.expand_conv1_weights(qm.w1p))
    np.testing.assert_array_equal(expand_conv1_weights(qm.w1p),
                                  jinfer.expand_conv1_weights(qm.w1p))


@pytest.mark.parametrize("version", VERSIONS)
def test_conv_stage_map_equals_golden(qm, qw, frames, version):
    """The whole valid conv map of the v5/v6/v4 plain versions (reached
    through make_conv_stage, prologue included) equals golden's, bit for
    bit."""
    got = tinfer.make_conv_stage(qw, version)(torch.from_numpy(frames)).numpy()
    assert got.shape == (16, 124, 80) and got.dtype == np.int8
    np.testing.assert_array_equal(got, _golden_map(qm, frames))
    assert 0 < (got > 0).mean() < 1


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("n", [16, 5])
def test_labels_match_pallas_and_golden(qm, qw, frames, version, n):
    """Full and ragged batches: labels equal the Pallas classifier's of the
    same version (interpret mode) and golden's."""
    x = frames[:n]
    want_pallas = np.asarray(jinfer.make_int8_predict(qm, version, interpret=True)(
        jnp.asarray(x)))
    got = tinfer.make_int8_predict(qw, version)(torch.from_numpy(x)).numpy()
    assert got.shape == (n,) and got.dtype == np.int32
    np.testing.assert_array_equal(want_pallas, gq.int8_predict(qm, x))
    np.testing.assert_array_equal(got, want_pallas)


def test_wrappers_take_plain_versions_on_cpu_without_counting(qw, frames):
    tinfer.reset_launch_counts()
    x = torch.from_numpy(frames)
    xp = tinfer.tap_planes(x, qw.inv_sx)
    want = tinfer.conv_stage_int8_v7_plain(x, qw).numpy()
    np.testing.assert_array_equal(tinfer.conv_stage_int8_v5(x, qw).numpy(), want)
    np.testing.assert_array_equal(tinfer.conv_stage_int8_v5_plain(x, qw).numpy(), want)
    for stage in (tinfer.conv_stage_int8_v6, tinfer.conv_stage_int8_v4):
        np.testing.assert_array_equal(stage(xp, qw).numpy(), want)
    assert set(tinfer.launch_counts().values()) == {0}
    assert len(tinfer.launch_counts()) == 11


def test_make_conv_stage_defaults_to_v10(qm):
    """As in the JAX package (ops/infer.py make_conv_stage): the default
    builds the v10 fold, so a model the fold refuses raises there, and v7
    named explicitly still runs it."""
    import inspect

    assert inspect.signature(jinfer.make_conv_stage).parameters["version"].default == "v10"
    assert inspect.signature(tinfer.make_conv_stage).parameters["version"].default == "v10"
    tree = qm.tree()
    tree["o1"] = tree["o1"].copy()
    tree["o1"][5] = 257
    qw = int8_weights_from_numpy(tree, device="cpu")
    with pytest.raises(ValueError, match="bf16-exact"):
        tinfer.make_conv_stage(qw)
    assert tinfer.make_conv_stage(qw, "v7")(torch.zeros((1, 2, 128))).shape == (1, 124, 80)


@pytest.mark.parametrize("breach", ["not_bf16", "acc_2_24"])
def test_planes_versions_run_a_model_the_fold_refuses(qm, frames, breach):
    """v4/v5/v6 need no fold: a model that v9/v10 refuse still classifies,
    with the Pallas v5 labels and golden's map."""
    tree = qm.tree()
    tree["o1"] = tree["o1"].copy()
    tree["o1"][5] = 257 if breach == "not_bf16" else 1 << 24
    qw = int8_weights_from_numpy(tree, device="cpu")
    with pytest.raises(ValueError):
        tinfer.make_int8_predict(qw, "v10")
    jqm = type(qm)(**tree)
    want = np.asarray(jinfer.make_int8_predict(jqm, "v5", interpret=True)(
        jnp.asarray(frames)))
    for version in VERSIONS:
        got = tinfer.make_int8_predict(qw, version)(torch.from_numpy(frames)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tinfer.make_conv_stage(qw, version)(torch.from_numpy(frames)).numpy(),
            _golden_map(jqm, frames))


# ------------------------------------------------------- narrow models


def _narrow_qm(c1=32, c2=16, d=32, nc=2, seed=0):
    """A narrow VT-CNN2 (the JAX package's training tests use conv1 32 and
    2 classes), quantized by the JAX package."""
    from modulationdetectioncnn_tpu.train.quant import quantize

    model = VTCNN2(num_classes=nc, conv1_filters=c1, conv2_filters=c2,
                   dense_units=d, dtype=jnp.float32)
    params = jax.tree.map(
        np.asarray, model.init(jax.random.key(seed), jnp.zeros((1, 2, 128))))
    calib = np.random.default_rng(9).standard_normal((64, 2, 128)).astype(np.float32)
    return quantize(model, params, calib)


def _unpadded(tqm: TorchQM, monkeypatch_ctx):
    """The carry without the padding: the plain chain at the model's own
    widths."""
    monkeypatch_ctx.setattr("modulationdetectioncnn_torch.quant.pad_to_kernel_widths",
                            lambda q: q)
    return int8_weights_from_numpy(tqm, device="cpu")


@pytest.mark.parametrize("widths", [(32, 16, 32, 2), (256, 80, 256, 2), (8, 80, 17, 11)],
                         ids=["c32_c16_d32_nc2", "full_but_nc2", "c8_c80_d17_nc11"])
def test_narrow_model_padded_carry_gives_unpadded_and_golden_labels(widths, monkeypatch):
    """A narrower model is padded to the kernels' widths at carry time; its
    map is the unpadded model's ([:, :, :c2]) and every version's labels
    equal the unpadded plain chain's and golden's."""
    qm = _narrow_qm(*widths)
    tqm = TorchQM.from_tree(qm.tree())
    qw = int8_weights_from_numpy(tqm, device="cpu")
    c1, c2, d, nc = widths
    assert tuple(qw.w2l.shape) == (512, 240) and tuple(qw.w3t.shape) == (256, 9920)
    assert qw.c2 == c2 and tuple(qw.w4.shape) == (256, 11)
    assert qw.w1f.shape == (16, 512)               # the fold accepts the padding
    with monkeypatch.context() as m:
        qw_raw = _unpadded(tqm, m)
    assert qw_raw.c2 == c2 and qw_raw.m2.shape[0] == c2
    x = (np.random.default_rng(4).standard_normal((24, 2, 128)) * 2).astype(np.float32)
    xt = torch.from_numpy(x)
    want_map = tinfer.conv_stage_int8_v7_plain(xt, qw_raw).numpy()
    np.testing.assert_array_equal(want_map, _golden_map(qm, x))
    want = gq.int8_predict(qm, x)
    np.testing.assert_array_equal(tinfer.make_int8_predict(qw_raw, "v7")(xt).numpy(), want)
    for version in ("v4", "v5", "v6", "v7", "v9", "v10"):
        np.testing.assert_array_equal(
            tinfer.make_conv_stage(qw, version)(xt).numpy(), want_map)
        got = tinfer.make_int8_predict(qw, version)(xt).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.max() < nc
    padded = tinfer.conv_stage_int8_v7_plain(xt, qw).numpy()
    assert (padded[..., c2:] == 0).all()


@pytest.mark.parametrize("widths", [(32, 16, 32, 2), (8, 80, 17, 11)],
                         ids=["c32_c16_d32_nc2", "c8_c80_d17_nc11"])
def test_narrow_model_on_v3_and_v2(widths, monkeypatch):
    """v3 and v2 run a narrow model padded to the kernels' widths: the map
    and labels are the unpadded model's and golden's, and v2's logits are
    the unpadded plain dense stage's for the model's own classes."""
    qm = _narrow_qm(*widths)
    tqm = TorchQM.from_tree(qm.tree())
    qw = int8_weights_from_numpy(tqm, device="cpu")
    with monkeypatch.context() as m:
        qw_raw = _unpadded(tqm, m)
    c1, c2, d, nc = widths
    assert qw.nc == nc and qw.b4.shape[0] == 11
    x = torch.from_numpy((np.random.default_rng(6).standard_normal((24, 2, 128)) * 2
                          ).astype(np.float32))
    want_map = tinfer.conv_stage_int8_v7_plain(x, qw_raw)
    want = gq.int8_predict(qm, x.numpy())
    for version in ("v3", "v2"):
        np.testing.assert_array_equal(tinfer.make_conv_stage(qw, version)(x).numpy(),
                                      want_map.numpy())
        np.testing.assert_array_equal(tinfer.make_int8_predict(qw, version)(x).numpy(), want)
    logits = tinfer.make_int8_forward_v2(qw)(x)
    assert logits.shape == (24, nc)
    np.testing.assert_array_equal(logits.numpy(),
                                  tinfer.dense_int8_plain(want_map, qw_raw).numpy())


def test_pad_to_kernel_widths_layout():
    qm = TorchQM.from_tree(_narrow_qm().tree())
    p = pad_to_kernel_widths(qm)
    assert p.widths() == (128, 256, 80, 256, 11)
    np.testing.assert_array_equal(p.w1p[:, :32], qm.w1p)
    assert (p.w1p[:, 32:] == 0).all()
    for k in ("m1", "o1"):
        full = getattr(p, k).reshape(2, 256)
        np.testing.assert_array_equal(full[:, :32], getattr(qm, k).reshape(2, 32))
        assert (full[:, 32:] == 0).all()
    w2 = p.w2p.reshape(2, 256, 3, 80)
    np.testing.assert_array_equal(w2[:, :32, :, :16], qm.w2p.reshape(2, 32, 3, 16))
    assert w2[:, 32:].sum() == 0 and w2[..., 16:].sum() == 0
    w3 = p.w3.reshape(124, 80, 256)
    np.testing.assert_array_equal(w3[:, :16, :32], qm.w3.reshape(124, 16, 32))
    assert (p.s4[2:] == 0).all() and np.isneginf(p.b4[2:]).all()
    assert (p.m2[16:] == 0).all() and (p.o2[16:] == 0).all()


@pytest.mark.parametrize("change", ["wider_conv1", "more_classes", "frame_len_64"])
def test_models_the_kernels_cannot_take_are_not_padded_and_the_card_refuses(change):
    """Wider than the compiled widths, or another frame length: carried
    unchanged (the plain versions run it on the CPU), and the CUDA launch
    path raises ValueError before any kernel."""
    if change == "frame_len_64":
        from modulationdetectioncnn_tpu.train.quant import quantize

        model = VTCNN2(num_classes=2, conv1_filters=8, conv2_filters=4,
                       dense_units=8, dtype=jnp.float32)
        params = jax.tree.map(
            np.asarray, model.init(jax.random.key(0), jnp.zeros((1, 2, 64))))
        calib = np.random.default_rng(9).standard_normal((32, 2, 64)).astype(np.float32)
        qm = TorchQM.from_tree(quantize(model, params, calib).tree())
    else:
        widths = (288, 16, 32, 2) if change == "wider_conv1" else (32, 16, 32, 12)
        qm = TorchQM.from_tree(_narrow_qm(*widths).tree())
    assert pad_to_kernel_widths(qm) is qm
    qw = int8_weights_from_numpy(qm, device="cpu")
    t = qm.widths()[0]
    x = torch.zeros((2, 2, t))
    assert tinfer.make_int8_predict(qw, "v7")(x).shape == (2,)
    for stage, inp in ((tinfer.conv_stage_int8_v7, x), (tinfer.conv_stage_int8_v5, x),
                       (tinfer.conv_stage_int8_v6, torch.zeros((2, 8, t), dtype=torch.int8))):
        with pytest.raises(ValueError, match="built for"):
            tinfer._launch(stage, inp.to("meta"), qw)


# ---------------------------------------------------------- xla_int8


@pytest.mark.parametrize("n", [24, 3])
def test_xla_int8_chain_is_bit_exact_with_the_plain_chain(qm, qw, n):
    """The library-op chain (torch._int_mm on the CPU, any shape) gives the
    plain chain's labels and golden's logits."""
    x = (np.random.default_rng(n).standard_normal((n, 2, 128)) * 1.5).astype(np.float32)
    xt = torch.from_numpy(x)
    got = infer_xla.make_int8_predict_xla(qw)(xt).numpy()
    np.testing.assert_array_equal(got, tinfer.make_int8_predict(qw, "v7")(xt).numpy())
    np.testing.assert_array_equal(got, gq.int8_predict(qm, x))
    logits = infer_xla.make_int8_forward_xla(qw)(xt).numpy()
    np.testing.assert_array_equal(logits, gq.int8_forward(qm, x).astype(np.float32))


def test_xla_int8_chain_on_the_committed_artifact():
    from modulationdetectioncnn_tpu.config import DataConfig
    from modulationdetectioncnn_tpu.data.synthetic import make_dataset

    x, _, _ = make_dataset(DataConfig(), snrs=[0, 18], frames_per_class_per_snr=4, seed=5)
    art = load_int8(device="cpu")
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(infer_xla.make_int8_predict_xla(art)(xt).numpy(),
                                  tinfer.make_int8_predict(art, "v5")(xt).numpy())


def test_int_mm_shape_rules():
    """On the card _int_mm needs more than 16 rows and K, N multiples of 8;
    the chain takes it there only then (dense2's N=11 is padded to 16)."""
    from types import SimpleNamespace

    assert infer_xla._int_mm_takes(torch.zeros((3, 5), dtype=torch.int8),
                                   torch.zeros((5, 11), dtype=torch.int8))
    for rows, k, n, ok in ((17, 8, 16, True), (16, 8, 16, False),
                           (17, 12, 16, False), (17, 8, 11, False)):
        a = SimpleNamespace(device=torch.device("cuda"), shape=(rows, k))
        assert infer_xla._int_mm_takes(a, SimpleNamespace(shape=(k, n))) == ok
