"""The port's int8 path against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages. The JAX side runs
its Pallas kernels in interpret mode, as tests/test_ops_infer.py does, and
its NumPy golden chain; the port's wrappers take their plain versions on
CPU tensors. The integer chain is held bit-exact: the conv map and the
labels must be equal, with no tolerance.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch.ops import infer as tinfer
from modulationdetectioncnn_torch.ops.requant import quantize_input, requantize
from modulationdetectioncnn_torch.quant import (
    DEFAULT_ARTIFACT,
    QuantizedModel as TorchQM,
    int8_weights_from_numpy,
    load_int8,
)
from modulationdetectioncnn_tpu.golden import quant as gq
from modulationdetectioncnn_tpu.models import VTCNN2
from modulationdetectioncnn_tpu.ops import infer as jinfer
from modulationdetectioncnn_tpu.ops.cnn_kernels import requantize as jrequantize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def qm():
    """The JAX tests' random-init VT-CNN2, quantized by train/quant.py."""
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_requantize_matches_jax_exactly(seed):
    """Negative sums, shift boundaries and both clip edges."""
    r = np.random.default_rng(seed)
    shift = r.integers(0, 20, 64).astype(np.int32)
    offset = r.integers(-(1 << 20), 1 << 20, 64).astype(np.int32)
    acc = r.integers(-(1 << 26), 1 << 26, (32, 64)).astype(np.int32)
    # exact multiples of 2**shift, one below, and values landing on 0/127/128
    acc[0] = (1 << shift) - offset
    acc[1] = (1 << shift) - offset - 1
    acc[2] = 127 * (1 << shift) - offset
    acc[3] = 128 * (1 << shift) - offset
    acc[4] = -offset
    acc[5] = -offset - 1
    want = np.asarray(jrequantize(jnp.asarray(acc), jnp.asarray(shift),
                                  jnp.asarray(offset), relu=True))
    got = requantize(torch.from_numpy(acc), torch.from_numpy(shift),
                     torch.from_numpy(offset)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert {0, 127} <= set(np.unique(got).tolist())


def test_quantize_input_matches_golden(qm):
    """Round half to even on the f32 product with the f32 reciprocal,
    including exact .5 ties and the clip."""
    x = np.random.default_rng(3).standard_normal((8, 2, 128)).astype(np.float32) * 2
    x[0, 0, :8] = (np.arange(8) + 0.5).astype(np.float32) * np.float32(qm.s_x)
    x[0, 1, :2] = (1e3, -1e3)
    inv = float(np.float32(1.0 / np.float64(np.float32(qm.s_x))))
    got = quantize_input(torch.from_numpy(x), inv).numpy()
    np.testing.assert_array_equal(got, gq.quantize_input(x, qm.s_x))


def test_weight_layouts(qm, qw):
    """The carried-across layouts are transposes of the JAX package's."""
    c2, k1 = qm.m2.shape[0], qm.w2p.shape[0]
    w2t = qw.w2t.numpy()
    for k in range(3):
        np.testing.assert_array_equal(
            w2t[:, k * k1:(k + 1) * k1], qm.w2p[:, k * c2:(k + 1) * c2].T)
    np.testing.assert_array_equal(qw.w3t.numpy(), qm.w3.T)
    assert qw.inv_sx == float(np.float32(1.0 / np.float64(np.float32(qm.s_x))))


def test_conv_stage_matches_pallas_v7_and_golden(qm, qw, frames):
    want_pallas = np.asarray(
        jinfer.make_conv_stage(qm, "v7", block_b=8, chunk=4, interpret=True)(
            jnp.asarray(frames)))[:, :124, :80]
    a1 = gq.conv1_int8(gq.quantize_input(frames, qm.s_x), qm.w1p, qm.m1, qm.o1)
    want_golden = gq.conv2_int8(a1, qm.w2p, qm.m2, qm.o2)
    got = tinfer.make_conv_stage(qw, "v7")(torch.from_numpy(frames)).numpy()
    assert got.shape == (16, 124, 80) and got.dtype == np.int8
    np.testing.assert_array_equal(want_pallas, want_golden)
    np.testing.assert_array_equal(got, want_golden)
    assert 0 < (got > 0).mean() < 1  # a live map, not all clipped


@pytest.mark.parametrize("n", [16, 5])
def test_labels_match_pallas_v7_and_golden(qm, qw, frames, n):
    """Full and ragged batches: labels equal the Pallas v7 classifier's and
    the golden chain's."""
    x = frames[:n]
    want_pallas = np.asarray(jinfer.make_int8_predict(qm, "v7", interpret=True)(
        jnp.asarray(x)))
    want_golden = gq.int8_predict(qm, x)
    got = tinfer.make_int8_predict(qw, "v7")(torch.from_numpy(x)).numpy()
    assert got.shape == (n,) and got.dtype == np.int32
    np.testing.assert_array_equal(want_pallas, want_golden)
    np.testing.assert_array_equal(got, want_golden)


def test_dense_stage_ties_go_to_lowest_index(qm, frames):
    """With dense2 zeroed the logits are the biases; a tie between classes 3
    and 7 goes to 3, as the reference's masked argmax and golden give."""
    tree = qm.tree()
    tree["w4"] = np.zeros_like(tree["w4"])
    tree["b4"] = np.zeros_like(tree["b4"])
    tree["b4"][[3, 7]] = 1.0
    tied = int8_weights_from_numpy(tree, device="cpu")
    got = tinfer.make_int8_predict(tied)(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(got, 3)
    np.testing.assert_array_equal(
        gq.int8_predict(TorchQM.from_tree(tree), frames), got)


def test_cpu_wrappers_take_plain_versions_without_counting(qw, frames):
    tinfer.reset_launch_counts()
    x = torch.from_numpy(frames)
    conv = tinfer.conv_stage_int8_v7(x, qw)
    np.testing.assert_array_equal(
        conv.numpy(), tinfer.conv_stage_int8_v7_plain(x, qw).numpy())
    labels = tinfer.dense_argmax_int8(conv, qw)
    np.testing.assert_array_equal(
        labels.numpy(), tinfer.dense_argmax_int8_plain(conv, qw).numpy())
    assert tinfer.conv_stage_int8_v7.launches == 0
    assert tinfer.dense_argmax_int8.launches == 0


@pytest.mark.parametrize("version", ["v1", "bf16"])
def test_unported_versions_raise(qw, version, frames):
    """Every int8 version of the JAX package is ported: v1 (the last one)
    builds a classifier with golden's labels, and any other name (``bf16``)
    raises ValueError, as the JAX package's ``make_int8_predict`` does."""
    if version == "v1":
        got = tinfer.make_int8_predict(qw, version)(torch.from_numpy(frames[:4])).numpy()
        np.testing.assert_array_equal(
            got, tinfer.make_int8_predict(qw, "v7")(torch.from_numpy(frames[:4])).numpy())
        return
    with pytest.raises(ValueError, match="unknown int8 kernel version"):
        tinfer.make_int8_predict(qw, version)
    with pytest.raises(ValueError, match="unknown int8 kernel version"):
        tinfer.make_conv_stage(qw, version)
    with pytest.raises(ValueError):
        jinfer.make_int8_predict(None, version)


def test_committed_npz_equals_orbax_artifact():
    """The committed .npz holds the Orbax artifact's 13 arrays unchanged."""
    from modulationdetectioncnn_tpu.utils.checkpoint import load_tree

    tree = load_tree(os.path.join(REPO, "artifacts", "ckpt_rml11_int8"))
    npz = TorchQM.from_npz(DEFAULT_ARTIFACT).tree()
    assert set(npz) == set(tree)
    for k, v in tree.items():
        v = np.asarray(v)
        assert npz[k].dtype == v.dtype and npz[k].shape == v.shape, k
        np.testing.assert_array_equal(npz[k], v, err_msg=k)


def test_full_width_artifact_labels_match_golden():
    """The deployed model, 256 frames of the synthetic RML-style data:
    labels equal the golden int8 chain exactly."""
    from modulationdetectioncnn_tpu.data.synthetic import make_dataset
    from modulationdetectioncnn_tpu.config import DataConfig

    x, _, _ = make_dataset(DataConfig(), snrs=[0, 10, 18],
                           frames_per_class_per_snr=8, seed=5)
    x = x[:256]
    qm_np = TorchQM.from_npz(DEFAULT_ARTIFACT)
    got = tinfer.make_int8_predict(load_int8(device="cpu"))(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), gq.int8_predict(qm_np, x))
    assert len(np.unique(got.numpy())) > 3


# ------------------------------------------------------------- v9 / v10


@pytest.mark.parametrize("version", ["v9", "v10"])
def test_folded_conv_stage_matches_pallas_and_golden(qm, qw, frames, version):
    """The whole valid conv map of the folded plain version (float32 conv1
    product of bf16-exact values, int8 conv2 with the shift-add) equals the
    Pallas v9/v10 kernel's in interpret mode and golden's integer chain,
    bit for bit."""
    want_pallas = np.asarray(
        jinfer.make_conv_stage(qm, version, block_b=8, chunk=4, interpret=True)(
            jnp.asarray(frames)))[:, :124, :80]
    a1 = gq.conv1_int8(gq.quantize_input(frames, qm.s_x), qm.w1p, qm.m1, qm.o1)
    want_golden = gq.conv2_int8(a1, qm.w2p, qm.m2, qm.o2)
    got = tinfer.make_conv_stage(qw, version)(torch.from_numpy(frames)).numpy()
    assert got.shape == (16, 124, 80) and got.dtype == np.int8
    np.testing.assert_array_equal(want_pallas, want_golden)
    np.testing.assert_array_equal(got, want_golden)
    assert 0 < (got > 0).mean() < 1


def test_folded_conv1_equals_integer_conv1(qm, qw, frames):
    """The fold itself: clip of the float32 product, truncated, equals the
    integer requantize of golden conv1 on every activation."""
    got = tinfer.conv1_folded_plain(torch.from_numpy(frames), qw).numpy()
    want = gq.conv1_int8(gq.quantize_input(frames, qm.s_x), qm.w1p, qm.m1, qm.o1)
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got > 0).any()


@pytest.mark.parametrize("version", ["v9", "v10"])
@pytest.mark.parametrize("n", [16, 5])
def test_folded_labels_match_pallas_and_golden(qm, qw, frames, version, n):
    """Full and ragged batches: labels equal the Pallas v9/v10 classifier's
    (interpret mode) and golden's."""
    x = frames[:n]
    want_pallas = np.asarray(jinfer.make_int8_predict(qm, version, interpret=True)(
        jnp.asarray(x)))
    want_golden = gq.int8_predict(qm, x)
    got = tinfer.make_int8_predict(qw, version)(torch.from_numpy(x)).numpy()
    assert got.shape == (n,) and got.dtype == np.int32
    np.testing.assert_array_equal(want_pallas, want_golden)
    np.testing.assert_array_equal(got, want_golden)


@pytest.mark.parametrize("version", ["v9", "v10"])
def test_folded_path_on_the_committed_artifact(version):
    """The deployed model on 256 frames of synthetic RML-style data: the
    folded conv map equals v7's (the integer spec) and the labels equal
    golden's."""
    from modulationdetectioncnn_tpu.config import DataConfig
    from modulationdetectioncnn_tpu.data.synthetic import make_dataset

    x, _, _ = make_dataset(DataConfig(), snrs=[0, 10, 18],
                           frames_per_class_per_snr=8, seed=5)
    x = torch.from_numpy(x[:256])
    art = load_int8(device="cpu")
    np.testing.assert_array_equal(
        tinfer.make_conv_stage(art, version)(x).numpy(),
        tinfer.conv_stage_int8_v7_plain(x, art).numpy())
    got = tinfer.make_int8_predict(art, version)(x).numpy()
    np.testing.assert_array_equal(
        got, gq.int8_predict(TorchQM.from_npz(DEFAULT_ARTIFACT), x.numpy()))


def test_folded_cpu_wrappers_take_plain_versions_without_counting(qw, frames):
    tinfer.reset_launch_counts()
    x = torch.from_numpy(frames)
    want = tinfer.conv_stage_int8_folded_plain(x, qw).numpy()
    for stage in (tinfer.conv_stage_int8_v9, tinfer.conv_stage_int8_v10):
        np.testing.assert_array_equal(stage(x, qw).numpy(), want)
    assert tinfer.launch_counts() == {
        "conv_stage_int8_v7": 0, "conv_stage_int8_v9": 0,
        "conv_stage_int8_v10": 0, "conv_stage_int8_v5": 0,
        "conv_stage_int8_v6": 0, "conv_stage_int8_v4": 0,
        "conv_stage_int8_v3": 0, "conv_stage_int8_v2": 0,
        "conv_stage_int8_v1": 0, "dense_argmax_int8": 0, "dense_int8": 0}


# ---------------------------------------------------- v3 / v2 / dense


def test_expand_taps_matches_jax(qm, frames):
    """The v2/v3 prologue: quantize, then lane 3h+k of row t is
    xq[h, t+k] (tests/test_ops_infer.py's layout), lanes 6 and 7 zero."""
    x = np.concatenate([frames, frames[:1] * 40])           # hits the clip
    inv = float(np.float32(1.0 / np.float64(np.float32(qm.s_x))))
    got = tinfer.expand_taps(torch.from_numpy(x), inv).numpy()
    want = np.asarray(jinfer.expand_taps(jnp.asarray(gq.quantize_input(x, qm.s_x)), 126))
    assert got.shape == (17, 126, 8) and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert (got[..., 6:] == 0).all() and {-127, 127} <= set(np.unique(got).tolist())


def _pallas_conv_map(qm, x, version, block_b=8, chunk=4):
    """The JAX package's v3 or v2 conv kernel alone, in interpret mode,
    fed as its classifier feeds it (the XLA quantize + expand_taps
    prologue): the valid (B, 124, C2) map of its output."""
    import functools

    from jax.experimental import pallas as pl

    b, c2, t1 = x.shape[0], qm.m2.shape[0], 126
    x_i8 = jnp.clip(jnp.round(jnp.asarray(x) * float(1.0 / qm.s_x)), -127.0, 127.0
                    ).astype(jnp.int8)
    xe = jinfer.expand_taps(x_i8, t1).reshape(b * t1, 8)
    w1e = jinfer.expand_conv1_weights(qm.w1p)
    if version == "v2":
        consts = (w1e, qm.m1, qm.o1, qm.w2p, qm.m2, qm.o2)
        kern = functools.partial(jinfer._conv_stage_int8_v2_kernel, chunk=chunk, t1=t1, c2=c2)
        out_block, out_shape = (block_b, t1 - 2, c2), (b, t1 - 2, c2)
    else:
        cin = qm.w2p.shape[0] // 2
        w2 = np.asarray(qm.w2p).reshape(2, cin, 3, c2).transpose(0, 2, 1, 3)
        consts = (w1e, qm.m1, qm.o1, jinfer.pack_conv2_weights_tapk(w2),
                  jinfer._pad_cols(qm.m2), jinfer._pad_cols(qm.o2))
        kern = functools.partial(jinfer._conv_stage_int8_v3_kernel, chunk=chunk, t1=t1)
        out_block, out_shape = (block_b, t1, 128), (b, t1, 128)
    consts = [jnp.asarray(a) for a in consts]
    specs = [pl.BlockSpec(a.shape, (lambda i: (0,)) if a.ndim == 1 else (lambda i: (0, 0)))
             for a in consts]
    out = pl.pallas_call(
        kern, grid=(b // block_b,),
        in_specs=[pl.BlockSpec((block_b * t1, 8), lambda i: (i, 0))] + specs,
        out_specs=pl.BlockSpec(out_block, lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.int8), interpret=True,
    )(xe, *consts)
    return np.asarray(out)[:, :124, :c2]


@pytest.mark.parametrize("version", ["v3", "v2"])
def test_taps_conv_stage_matches_pallas_and_golden(qm, qw, frames, version):
    """The whole valid conv map of v3/v2 (plain version on the CPU) equals
    the JAX package's v3/v2 Pallas kernel (interpret mode) and golden's
    integer chain, bit for bit."""
    a1 = gq.conv1_int8(gq.quantize_input(frames, qm.s_x), qm.w1p, qm.m1, qm.o1)
    want_golden = gq.conv2_int8(a1, qm.w2p, qm.m2, qm.o2)
    want_pallas = _pallas_conv_map(qm, frames, version)
    got = tinfer.make_conv_stage(qw, version)(torch.from_numpy(frames)).numpy()
    assert got.shape == (16, 124, 80) and got.dtype == np.int8
    np.testing.assert_array_equal(want_pallas, want_golden)
    np.testing.assert_array_equal(got, want_golden)
    assert 0 < (got > 0).mean() < 1


@pytest.mark.parametrize("version", ["v3", "v2"])
@pytest.mark.parametrize("n", [16, 5])
def test_taps_labels_match_pallas_and_golden(qm, qw, frames, version, n):
    """Full and ragged batches: labels equal the JAX package's v3/v2
    classifier (``make_int8_predict``, interpret mode) and golden's."""
    x = frames[:n]
    want_pallas = np.asarray(jinfer.make_int8_predict(qm, version, interpret=True)(
        jnp.asarray(x)))
    got = tinfer.make_int8_predict(qw, version)(torch.from_numpy(x)).numpy()
    assert got.shape == (n,) and got.dtype == np.int32
    np.testing.assert_array_equal(want_pallas, gq.int8_predict(qm, x))
    np.testing.assert_array_equal(got, want_pallas)


@pytest.mark.parametrize("version", ["v3", "v2"])
def test_taps_path_on_the_committed_artifact(version):
    """The deployed model on 256 frames of synthetic RML-style data: the
    v3/v2 map equals v7's (the integer spec) and the labels golden's."""
    from modulationdetectioncnn_tpu.config import DataConfig
    from modulationdetectioncnn_tpu.data.synthetic import make_dataset

    x, _, _ = make_dataset(DataConfig(), snrs=[0, 10, 18],
                           frames_per_class_per_snr=8, seed=5)
    x = torch.from_numpy(x[:256])
    art = load_int8(device="cpu")
    np.testing.assert_array_equal(tinfer.make_conv_stage(art, version)(x).numpy(),
                                  tinfer.conv_stage_int8_v7_plain(x, art).numpy())
    np.testing.assert_array_equal(
        tinfer.make_int8_predict(art, version)(x).numpy(),
        gq.int8_predict(TorchQM.from_npz(DEFAULT_ARTIFACT), x.numpy()))


@pytest.mark.parametrize("n", [16, 5])
def test_v2_logits_match_pallas_within_one_ulp(qm, qw, frames, n):
    """v2's logits: equal, bit for bit, to ``float32(acc4) * s4`` then
    ``+ b4`` rounded separately (the port's plain version and its CUDA
    kernel); the JAX package's interpret-mode kernel is within 1 ulp of
    them, because XLA's CPU backend fuses its multiply-add into an FMA (it
    equals the fused form bit for bit)."""
    x = frames[:n]
    got = tinfer.make_int8_forward_v2(qw)(torch.from_numpy(x)).numpy()
    want = np.asarray(jinfer.make_int8_forward_v2(qm, interpret=True)(jnp.asarray(x)))
    assert got.shape == want.shape == (n, 11) and got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    a1 = gq.conv1_int8(gq.quantize_input(x, qm.s_x), qm.w1p, qm.m1, qm.o1)
    h = gq.conv2_int8(a1, qm.w2p, qm.m2, qm.o2).reshape(n, -1).astype(np.int64)
    acc3 = h @ qm.w3.astype(np.int64)
    a3 = np.clip((acc3 + qm.o3) >> qm.m3, 0, 127)
    acc4 = (a3 @ qm.w4.astype(np.int64)).astype(np.float32)
    np.testing.assert_array_equal(got, (acc4 * qm.s4).astype(np.float32) + qm.b4)
    fused = (acc4.astype(np.float64) * qm.s4 + qm.b4).astype(np.float32)
    np.testing.assert_array_equal(want, fused)
    np.testing.assert_array_equal(tinfer.argmax_lowest(torch.from_numpy(got)).numpy(),
                                  gq.int8_predict(qm, x))


def test_dense_stage_logits_and_labels_agree(qw, frames):
    """The logits stage and the dense + argmax stage read the same map: the
    argmax of one is the other, including on a padded-class model."""
    x = torch.from_numpy(frames)
    conv = tinfer.conv_stage_int8_v7_plain(x, qw)
    logits = tinfer.dense_int8(conv, qw)
    assert logits.shape == (16, 11) and logits.dtype == torch.float32
    np.testing.assert_array_equal(tinfer.argmax_lowest(logits).numpy(),
                                  tinfer.dense_argmax_int8(conv, qw).numpy())


def test_taps_cpu_wrappers_take_plain_versions_without_counting(qw, frames):
    tinfer.reset_launch_counts()
    x = torch.from_numpy(frames)
    xe = tinfer.expand_taps(x, qw.inv_sx)
    want = tinfer.conv_stage_int8_v7_plain(x, qw).numpy()
    for stage in (tinfer.conv_stage_int8_v3, tinfer.conv_stage_int8_v2):
        np.testing.assert_array_equal(stage(xe, qw).numpy(), want)
    np.testing.assert_array_equal(tinfer.dense_int8(torch.from_numpy(want), qw).numpy(),
                                  tinfer.dense_int8_plain(torch.from_numpy(want), qw).numpy())
    assert set(tinfer.launch_counts().values()) == {0}


def test_fold_refused_model_runs_on_v3_and_v2(qm, frames):
    """v3 and v2 need no fold: a conv1 offset that is not bf16-exact is
    refused by v9/v10 and runs on v3/v2 with golden's labels."""
    tree = qm.tree()
    tree["o1"] = np.asarray(tree["o1"]).copy()
    tree["o1"][5] = 257
    refused = int8_weights_from_numpy(tree, device="cpu")
    with pytest.raises(ValueError, match="bf16"):
        tinfer.make_int8_predict(refused, "v10")
    want = gq.int8_predict(TorchQM.from_tree(tree), frames)
    for v in ("v3", "v2"):
        np.testing.assert_array_equal(
            tinfer.make_int8_predict(refused, v)(torch.from_numpy(frames)).numpy(), want)


# ------------------------------------------------------------------- v1


def test_v1_conv_stage_matches_pallas_and_golden(qm, qw, frames):
    """The whole valid v1 map (plain version on the CPU) equals golden's and
    the JAX package's v1 conv kernel (``_conv_stage_int8_kernel``, interpret
    mode): bit-exact."""
    import functools

    from jax.experimental import pallas as pl

    consts = [jnp.asarray(a) for a in (qm.w1p, qm.m1, qm.o1, qm.w2p, qm.m2, qm.o2)]
    kern = functools.partial(jinfer._conv_stage_int8_kernel, chunk=4, t_in=128, c2=80,
                             inv_sx=float(1.0 / qm.s_x))
    want_pallas = np.asarray(pl.pallas_call(
        kern, grid=(2,),
        in_specs=[pl.BlockSpec((8, 2, 128), lambda i: (i, 0, 0))]
        + [pl.BlockSpec(a.shape, (lambda i: (0,)) if a.ndim == 1 else (lambda i: (0, 0)))
           for a in consts],
        out_specs=pl.BlockSpec((8, 124, 80), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((16, 124, 80), jnp.int8), interpret=True,
    )(jnp.asarray(frames), *consts))
    a1 = gq.conv1_int8(gq.quantize_input(frames, qm.s_x), qm.w1p, qm.m1, qm.o1)
    want_golden = gq.conv2_int8(a1, qm.w2p, qm.m2, qm.o2)
    got = tinfer.make_conv_stage(qw, "v1")(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(want_pallas, want_golden)
    np.testing.assert_array_equal(got, want_golden)
    np.testing.assert_array_equal(
        tinfer.conv_stage_int8_v1(torch.from_numpy(frames), qw).numpy(), want_golden)


@pytest.mark.parametrize("n", [16, 5])
def test_v1_logits_and_labels_match_pallas_and_golden(qm, qw, frames, n):
    """v1's logits (``make_int8_forward``): bit for bit ``float32(acc4) *
    s4`` then ``+ b4`` from golden's integer chain, and within 1 ulp of the
    JAX package's interpret-mode forward (XLA's CPU backend fuses that
    multiply-add); its labels equal golden's and the JAX v1 classifier's."""
    x = frames[:n]
    got = tinfer.make_int8_forward(qw)(torch.from_numpy(x)).numpy()
    want = np.asarray(jinfer.make_int8_forward(qm, block_b=8, chunk=4, dense_block_b=8,
                                               interpret=True)(jnp.asarray(x)))
    assert got.shape == want.shape == (n, 11) and got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    a1 = gq.conv1_int8(gq.quantize_input(x, qm.s_x), qm.w1p, qm.m1, qm.o1)
    h = gq.conv2_int8(a1, qm.w2p, qm.m2, qm.o2).reshape(n, -1).astype(np.int64)
    a3 = np.clip((h @ qm.w3.astype(np.int64) + qm.o3) >> qm.m3, 0, 127)
    acc4 = (a3 @ qm.w4.astype(np.int64)).astype(np.float32)
    np.testing.assert_array_equal(got, (acc4 * qm.s4).astype(np.float32) + qm.b4)
    labels = tinfer.make_int8_predict(qw, "v1")(torch.from_numpy(x)).numpy()
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(labels, gq.int8_predict(qm, x))
    np.testing.assert_array_equal(
        labels, np.asarray(jinfer.make_int8_predict(qm, "v1", interpret=True)(jnp.asarray(x))))


def test_v1_on_a_narrow_padded_model(frames):
    """A narrow model (conv1 32, conv2 16, dense 32, 2 classes) padded to
    the kernels' widths: v1's map is the model's own 16 channels and its
    logits its own 2 classes, both golden's."""
    from modulationdetectioncnn_tpu.train.quant import quantize

    model = VTCNN2(num_classes=2, conv1_filters=32, conv2_filters=16, dense_units=32,
                   dtype=jnp.float32)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(1), jnp.zeros((1, 2, 128))))
    qm = quantize(model, params, frames)
    qw = int8_weights_from_numpy(qm.tree(), device="cpu")
    x = torch.from_numpy(frames)
    a1 = gq.conv1_int8(gq.quantize_input(frames, qm.s_x), qm.w1p, qm.m1, qm.o1)
    np.testing.assert_array_equal(tinfer.make_conv_stage(qw, "v1")(x).numpy(),
                                  gq.conv2_int8(a1, qm.w2p, qm.m2, qm.o2))
    assert tinfer.make_int8_forward(qw)(x).shape == (16, 2)
    np.testing.assert_array_equal(tinfer.make_int8_predict(qw, "v1")(x).numpy(),
                                  gq.int8_predict(qm, frames))


def test_v1_cpu_wrapper_takes_the_plain_version_without_counting(qw, frames):
    tinfer.reset_launch_counts()
    x = torch.from_numpy(frames)
    np.testing.assert_array_equal(tinfer.conv_stage_int8_v1(x, qw).numpy(),
                                  tinfer.conv_stage_int8_v5_plain(x, qw).numpy())
    tinfer.make_int8_predict(qw, "v1")(x)
    assert tinfer.conv_stage_int8_v1.launches == 0 and tinfer.dense_int8.launches == 0
    assert "conv_stage_int8_v1" in tinfer.launch_counts()
