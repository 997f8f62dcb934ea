"""The port's bf16 v4 classifier against the JAX package, on the CPU.

Float weights come from the JAX tests' seeded Flax init and are carried with
``params_from_flax``; frames from NumPy seeds. The JAX side runs its Pallas
kernels in interpret mode (``make_bf16_classifier_v4(..., interpret=True)``
and, for the map, its conv kernel through the same ``pallas_call``); the
port's wrappers take their plain versions on CPU tensors. bf16 has no
integer spec: the map is held to the tolerance the card's check uses,
``rtol = 2**-7`` (one bf16 ulp) plus ``atol = 1e-3 * max|map|`` (near-zero
elements on the ReLU edge), and labels to agreement counts.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2 as TVTCNN2
from modulationdetectioncnn_torch.models.vtcnn2 import params_from_flax
from modulationdetectioncnn_torch.ops import infer_bf16 as tb
from modulationdetectioncnn_tpu.golden import cnn as gcnn
from modulationdetectioncnn_tpu.models import VTCNN2
from modulationdetectioncnn_tpu.ops import infer as jinfer
from modulationdetectioncnn_tpu.ops.cnn_kernels import pack_conv1_weights

RTOL = 2.0 ** -7


def _params(**widths):
    model = VTCNN2(dtype=jnp.float32, **widths)
    return jax.tree.map(np.asarray, model.init(jax.random.key(0), jnp.zeros((1, 2, 128))))


@pytest.fixture(scope="module")
def params():
    return _params()


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(7).standard_normal((16, 2, 128)).astype(np.float32)


def jax_conv_map(params, x, chunk=4, block_b=8):
    """The JAX package's bf16 v4 conv kernel alone (interpret mode), with
    the weights and the (B, 8, T) bf16 planes ``make_bf16_classifier_v4``
    builds; returns its valid (B, 124, c2) map as float32."""
    p = params["params"]
    c2 = p["Conv2"]["bias"].shape[0]
    w1e = jinfer.expand_conv1_weights(pack_conv1_weights(p["Conv1"]["kernel"]).astype(np.float32))
    w1e[6, :] = np.concatenate([p["Conv1"]["bias"]] * 2)
    consts = [jnp.asarray(w1e.astype(jnp.bfloat16)),
              jnp.asarray(jinfer.pack_conv2_weights_tap384(
                  p["Conv2"]["kernel"].astype(np.float32)).astype(jnp.bfloat16)),
              jnp.asarray(jinfer._pad_cols(p["Conv2"]["bias"]).astype(np.float32))]
    b, t = x.shape[0], x.shape[-1]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    cols = [jnp.pad(xb[:, h, k:k + t - 2], [(0, 0), (0, 2)]) for h in range(2) for k in range(3)]
    xp = jnp.concatenate([jnp.stack(cols, axis=-2), jnp.ones((b, 1, t), jnp.bfloat16),
                          jnp.zeros((b, 1, t), jnp.bfloat16)], axis=-2)
    out = pl.pallas_call(
        functools.partial(jinfer._conv_stage_bf16_v4_kernel, chunk=chunk),
        grid=(b // block_b,),
        in_specs=[pl.BlockSpec((block_b, 8, t), lambda i: (i, 0, 0))]
        + [pl.BlockSpec(a.shape, (lambda i: (0,)) if a.ndim == 1 else (lambda i: (0, 0)))
           for a in consts],
        out_specs=pl.BlockSpec((block_b, t, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, t, 128), jnp.bfloat16), interpret=True,
    )(xp, *consts)
    return np.asarray(out[:, :t - 4, :c2].astype(jnp.float32))


def jax_labels(params, x):
    return np.asarray(jinfer.make_bf16_classifier_v4(
        params, block_b=8, chunk=4, dense_block_b=16, interpret=True)(jnp.asarray(x)))


def assert_map_close(got: np.ndarray, want: np.ndarray):
    """Every element within one bf16 ulp of ``want`` plus 1e-3 of its
    largest magnitude."""
    atol = 1e-3 * np.abs(want).max()
    bad = np.abs(got - want) > RTOL * np.abs(want) + atol
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


@pytest.mark.parametrize("widths", [{}, {"num_classes": 2, "conv1_filters": 32,
                                         "conv2_filters": 16, "dense_units": 32}],
                         ids=["full_width", "narrow_padded"])
def test_bf16_v4_plain_matches_pallas(frames, widths):
    """At full width and for a narrow model padded to the kernels' widths:
    the plain conv stage's map is within the card's tolerance of the JAX
    kernel's, and the classifier's labels agree on >= 15 of 16 frames."""
    params = _params(**widths)
    bw = tb.make_bf16_weights(params, "cpu")
    x = torch.from_numpy(frames)
    got = tb.conv_stage_bf16_v4(x, bw)
    want = jax_conv_map(params, frames)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert_map_close(got.to(torch.float32).numpy(), want)
    assert 0 < (want > 0).mean() < 1
    labels = tb.make_bf16_classifier_v4(params, "cpu")(x).numpy()
    assert labels.dtype == np.int32 and labels.shape == (16,)
    assert labels.max() < params["params"]["Dense2"]["bias"].shape[0]
    assert (labels == jax_labels(params, frames)).sum() >= 15


def test_bf16_v4_classifier_agrees_with_golden(params, frames):
    """As the JAX package's own test (tests/test_ops_infer.py:100): labels
    agree with the float golden argmax on >= 85 % of frames, from a state
    dict carried with ``params_from_flax``."""
    got = tb.make_bf16_classifier_v4(params_from_flax(params), "cpu")(
        torch.from_numpy(frames)).numpy()
    want = gcnn.vtcnn2_forward(params, frames).argmax(-1)
    assert (got == want).mean() >= 0.85


def test_conv1_rounding_points(params, frames):
    """conv1 is the frame rounded to bf16 times bf16 taps, plus the bf16
    bias, summed in f32 in the kernel's order, then ReLU and bf16: equal,
    bit for bit, to that computation in NumPy."""
    bw = tb.make_bf16_weights(params, "cpu")
    got = tb.conv1_bf16_plain(torch.from_numpy(frames), bw).to(torch.float32).numpy()
    p = params["params"]
    bf = lambda a: torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16).float().numpy()  # noqa: E731
    xb, w, b = bf(frames), bf(p["Conv1"]["kernel"].reshape(3, -1)), bf(p["Conv1"]["bias"])
    halves = []
    for h in range(2):
        acc = xb[:, h, 0:126, None] * w[0]
        acc = acc + xb[:, h, 1:127, None] * w[1]
        acc = acc + xb[:, h, 2:128, None] * w[2]
        halves.append(acc + b)
    want = bf(np.maximum(np.concatenate(halves, axis=-1), 0))
    np.testing.assert_array_equal(got, want)


def test_weight_carry(params):
    """The packing of make_bf16_classifier_v4: w1e rows 3h+k and the bias
    row 6 rounded to bf16, conv2 taps on N, dense1 transposed in the Flax
    t*c2+c order, biases b2/b3/b4 in f32; a Flax tree and its state dict
    pack the same."""
    p = params["params"]
    bw = tb.make_bf16_weights(params, "cpu")
    sd = tb.make_bf16_weights(TVTCNN2(dtype="float32").state_dict() | params_from_flax(params),
                              "cpu")
    for f in ("w1e", "w2t", "b2", "w3t", "b3", "w4", "b4"):
        assert torch.equal(getattr(bw, f), getattr(sd, f)), f
    bf = lambda a: torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)  # noqa: E731
    w1 = p["Conv1"]["kernel"].reshape(3, 256)
    assert torch.equal(bw.w1e[4, 256:], bf(w1[1])) and torch.equal(bw.w1e[6, :256],
                                                                     bf(p["Conv1"]["bias"]))
    assert not bw.w1e[7].any() and not bw.w1e[3, :256].any()
    assert torch.equal(bw.w2t[2 * 80 + 5, 256 + 7], bf(p["Conv2"]["kernel"][1, 2, 7, 5]))
    assert torch.equal(bw.w3t[9, 3 * 80 + 4], bf(p["Dense1"]["kernel"][3 * 80 + 4, 9]))
    assert bw.b2.dtype == bw.b3.dtype == bw.b4.dtype == torch.float32
    assert (bw.c2, bw.nc) == (80, 11)


def test_narrow_model_pads_and_masks():
    """A 2-class narrow model pads to the kernels' widths with zero weights,
    and classes >= 2 read -inf in the plain logits."""
    params = _params(num_classes=2, conv1_filters=32, conv2_filters=16, dense_units=32)
    bw = tb.make_bf16_weights(params, "cpu")
    assert tuple(bw.w1e.shape) == (8, 512) and tuple(bw.w3t.shape) == (256, 9920)
    assert (bw.c2, bw.nc) == (16, 2)
    assert not bw.w2t[:, 32:256].any() and not bw.w3t[32:].any()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 2, 128)).astype(np.float32))
    logits = tb.dense_logits_bf16_plain(tb.conv_stage_bf16_v4_plain(x, bw), bw)
    assert torch.isinf(logits[:, 2:]).all() and torch.isfinite(logits[:, :2]).all()


def test_cpu_wrappers_take_plain_versions_without_counting(params, frames):
    tb.reset_launch_counts()
    bw = tb.make_bf16_weights(params, "cpu")
    x = torch.from_numpy(frames)
    conv = tb.conv_stage_bf16_v4(x, bw)
    assert torch.equal(conv, tb.conv_stage_bf16_v4_plain(x, bw))
    assert torch.equal(tb.dense_argmax_bf16(conv, bw), tb.dense_argmax_bf16_plain(conv, bw))
    assert tb.launch_counts() == dict.fromkeys(
        ("conv_stage_bf16_v4", "dense_argmax_bf16", "conv_stage_bf16_v2",
         "dense_logits_bf16", "conv_stage_bf16"), 0)


def test_cuda_wrappers_reject_what_the_kernel_does_not_take(params):
    """Checks that run before any launch: device, dtype, shape, and a model
    wider than the kernels (which packs unpadded and runs on the CPU only)."""
    bw = tb.make_bf16_weights(params, "cpu")
    frames = torch.zeros((1, 2, 128), device="meta")
    conv_map = torch.zeros((1, 124, 80), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tb.conv_stage_bf16_v4(frames, bw)
    with pytest.raises(ValueError, match="unsupported device"):
        tb.dense_argmax_bf16(conv_map, bw)
    with pytest.raises(ValueError, match="expected"):
        tb.conv_stage_bf16_v4(frames.to(torch.bfloat16), bw)
    with pytest.raises(ValueError, match="expected"):
        tb.dense_argmax_bf16(conv_map.to(torch.float32), bw)
    wide = tb.make_bf16_weights(_params(conv1_filters=300), "cpu")
    assert tuple(wide.w1e.shape) == (8, 600)
    with pytest.raises(ValueError, match="built for"):
        tb.conv_stage_bf16_v4(frames, wide)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 2, 128)).astype(np.float32))
    assert tb.make_bf16_classifier_v4(_params(conv1_filters=300), "cpu")(x).shape == (2,)
    assert tb.launch_counts() == dict.fromkeys(
        ("conv_stage_bf16_v4", "dense_argmax_bf16", "conv_stage_bf16_v2",
         "dense_logits_bf16", "conv_stage_bf16"), 0)
