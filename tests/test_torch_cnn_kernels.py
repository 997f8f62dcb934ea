"""The port's stand-alone conv kernels (``ops/cnn_kernels.py``, kernel-table
rows 17-20) against the JAX package's Pallas kernels in interpret mode, on
the CPU (the wrappers take their plain versions for CPU tensors).

The same NumPy inputs, made from a seed, go to both, at the default widths
(T 128, C 256, Co 80) and at a narrow odd shape (T 40, C 33, Co 7).
Tolerances, relative to the map's largest magnitude:

- int8 conv1 and conv2: equal (integer arithmetic);
- float32 conv1: 1e-6 (the JAX function under ``jit`` on the CPU fuses the
  products and sums into FMAs; the port rounds each as the TPU kernel
  wrote it);
- float32 conv2: 1e-5 (the two libraries sum the 1536 products in other
  orders);
- bf16 out: one bf16 ulp of the larger value (2^-7 relative) plus 1e-6 of
  the largest magnitude (elements at the ReLU edge).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch.ops import cnn_kernels as tck
from modulationdetectioncnn_tpu.golden import quant as gq
from modulationdetectioncnn_tpu.ops import cnn_kernels as jck

SHAPES = {"default": (5, 128, 256, 80), "narrow_odd": (3, 40, 33, 7)}  # B, T, C, Co
BF16_RTOL = 2.0 ** -7


def _float_inputs(b, t, c, co, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, 2, t)).astype(np.float32)
    w1p = (r.standard_normal((3, c)) / np.sqrt(3)).astype(np.float32)
    b1 = (0.1 * r.standard_normal(c)).astype(np.float32)
    w2p = (r.standard_normal((2 * c, 3 * co)) / np.sqrt(6 * c)).astype(np.float32)
    b2 = (0.1 * r.standard_normal(co)).astype(np.float32)
    return x, w1p, b1, w2p, b2


def _int8_inputs(b, t, c, co, seed):
    r = np.random.default_rng(seed)
    x = r.integers(-127, 128, (b, 2, t)).astype(np.int8)
    w1p = r.integers(-127, 128, (3, c)).astype(np.int8)
    m1 = r.integers(4, 10, 2 * c).astype(np.int32)
    o1 = r.integers(-2000, 2000, 2 * c).astype(np.int32)
    w2p = r.integers(-127, 128, (2 * c, 3 * co)).astype(np.int8)
    m2 = r.integers(10, 16, co).astype(np.int32)
    o2 = r.integers(-20000, 20000, co).astype(np.int32)
    return x, w1p, m1, o1, w2p, m2, o2


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_close(got, want, rtol, atol_of_max):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = rtol * np.maximum(np.abs(got), np.abs(want)) + atol_of_max * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


@pytest.mark.parametrize("shape", SHAPES, ids=list(SHAPES))
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_conv1_stacked_matches_jax(shape, out):
    b, t, c, co = SHAPES[shape]
    x, w1p, b1, _, _ = _float_inputs(b, t, c, co, seed=0)
    got = tck.conv1_stacked(_t(x), _t(w1p), _t(b1), out_dtype=getattr(torch, out))
    want = jck.conv1_stacked(*_j(x, w1p, b1), out_dtype=getattr(jnp, out), block_b=4,
                             interpret=True)
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == (b, t - 2, 2 * c)
    rtol = BF16_RTOL if out == "bfloat16" else 0.0
    _assert_close(got.float().numpy(), np.asarray(want, np.float32), rtol, 1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=list(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2_stacked_matches_jax(shape, dtype):
    """float32 in and out within 1e-5; bf16 activations and weights (the
    port's tensor-core path) to bf16 out within one ulp."""
    b, t, c, co = SHAPES[shape]
    x, w1p, b1, w2p, b2 = _float_inputs(b, t, c, co, seed=1)
    a1 = np.asarray(jck.conv1_stacked(*_j(x, w1p, b1), out_dtype=jnp.float32,
                                      interpret=True))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tck.conv2_stacked(_t(a1).to(tdt), _t(w2p).to(tdt), _t(b2), out_dtype=tdt)
    want = jck.conv2_stacked(jnp.asarray(a1, jdt), jnp.asarray(w2p, jdt),
                             jnp.asarray(b2), out_dtype=jdt, block_b=4, interpret=True)
    assert got.dtype == tdt and tuple(got.shape) == (b, t - 4, co)
    if dtype == "float32":
        _assert_close(got.numpy(), np.asarray(want), 0.0, 1e-5)
    else:
        _assert_close(got.float().numpy(), np.asarray(want, np.float32), BF16_RTOL, 1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=list(SHAPES))
def test_int8_convs_equal_jax_and_golden(shape):
    b, t, c, co = SHAPES[shape]
    x, w1p, m1, o1, w2p, m2, o2 = _int8_inputs(b, t, c, co, seed=2)
    a1 = tck.conv1_stacked_int8(_t(x), _t(w1p), _t(m1), _t(o1))
    a1_j = jck.conv1_stacked_int8(*_j(x, w1p, m1, o1), block_b=4, interpret=True)
    np.testing.assert_array_equal(a1.numpy(), np.asarray(a1_j))
    np.testing.assert_array_equal(a1.numpy(), gq.conv1_int8(x, w1p, m1, o1))
    live = float((a1.numpy() > 0).mean())
    assert 0.05 < live < 0.95, live                   # the clip is not saturated
    a2 = tck.conv2_stacked_int8(a1, _t(w2p), _t(m2), _t(o2))
    a2_j = jck.conv2_stacked_int8(a1_j, *_j(w2p, m2, o2), block_b=4, interpret=True)
    assert a2.dtype == torch.int8 and tuple(a2.shape) == (b, t - 4, co)
    np.testing.assert_array_equal(a2.numpy(), np.asarray(a2_j))
    np.testing.assert_array_equal(a2.numpy(), gq.conv2_int8(a1.numpy(), w2p, m2, o2))


def test_int8_chain_of_quantized_model_equals_jax():
    """The JAX test's own inputs: a seeded float VT-CNN2 quantized by the JAX
    quantizer, its calibration frames through both packages' int8 conv1 and
    conv2 (tests/test_ops_conv.py's arrays)."""
    import jax

    from modulationdetectioncnn_tpu.models import VTCNN2
    from modulationdetectioncnn_tpu.train.quant import quantize

    model = VTCNN2(dtype=jnp.float32)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0), jnp.zeros((1, 2, 128))))
    calib = np.random.default_rng(3).standard_normal((64, 2, 128)).astype(np.float32)
    qm = quantize(model, params, calib)
    x_i8 = gq.quantize_input(calib[:6], float(qm.s_x))
    w1p, m1, o1, w2p, m2, o2 = (np.asarray(a) for a in (qm.w1p, qm.m1, qm.o1, qm.w2p,
                                                         qm.m2, qm.o2))
    a1 = tck.conv1_stacked_int8(_t(x_i8), _t(w1p), _t(m1), _t(o1))
    a2 = tck.conv2_stacked_int8(a1, _t(w2p), _t(m2), _t(o2))
    a1_j = jck.conv1_stacked_int8(*_j(x_i8, w1p, m1, o1), block_b=4, interpret=True)
    a2_j = jck.conv2_stacked_int8(a1_j, *_j(w2p, m2, o2), block_b=4, interpret=True)
    np.testing.assert_array_equal(a1.numpy(), np.asarray(a1_j))
    np.testing.assert_array_equal(a2.numpy(), np.asarray(a2_j))


@pytest.mark.parametrize("block_b", [1, 4, 16, 64])
def test_block_b_does_not_change_the_result(block_b):
    b, t, c, co = SHAPES["narrow_odd"]
    x, w1p, b1, w2p, b2 = _float_inputs(b, t, c, co, seed=4)
    xi, w1i, m1, o1, w2i, m2, o2 = _int8_inputs(b, t, c, co, seed=4)
    a1 = tck.conv1_stacked(_t(x), _t(w1p), _t(b1), block_b=block_b)
    assert torch.equal(a1, tck.conv1_stacked(_t(x), _t(w1p), _t(b1)))
    assert torch.equal(tck.conv2_stacked(a1, _t(w2p).bfloat16(), _t(b2), block_b=block_b),
                       tck.conv2_stacked(a1, _t(w2p).bfloat16(), _t(b2)))
    q1 = tck.conv1_stacked_int8(_t(xi), _t(w1i), _t(m1), _t(o1), block_b=block_b)
    assert torch.equal(q1, tck.conv1_stacked_int8(_t(xi), _t(w1i), _t(m1), _t(o1)))
    assert torch.equal(tck.conv2_stacked_int8(q1, _t(w2i), _t(m2), _t(o2), block_b=block_b),
                       tck.conv2_stacked_int8(q1, _t(w2i), _t(m2), _t(o2)))
    with pytest.raises(ValueError, match="block_b"):
        tck.conv1_stacked(_t(x), _t(w1p), _t(b1), block_b=0)


def test_requantize_legacy_branch_matches_jax():
    """relu=False: an integer shift raises the JAX package's TypeError; a
    float multiplier rounds half to even and clips to +-127, as JAX does."""
    r = np.random.default_rng(5)
    acc = r.integers(-40000, 40000, (4, 9)).astype(np.int32)
    shift = np.full(9, 7, np.int32)
    with pytest.raises(TypeError, match="relu=False"):
        jck.requantize(jnp.asarray(acc), jnp.asarray(shift), jnp.asarray(shift), relu=False)
    with pytest.raises(TypeError, match="relu=False"):
        tck.requantize(_t(acc), _t(shift), _t(shift), relu=False)
    with pytest.raises(TypeError, match="relu=False"):
        tck.requantize(_t(acc), 7, 0, relu=False)
    mult = (r.random(9) * 0.01).astype(np.float32)
    off = r.standard_normal(9).astype(np.float32)
    want = np.asarray(jck.requantize(jnp.asarray(acc), jnp.asarray(mult), jnp.asarray(off),
                                     relu=False))
    got = tck.requantize(_t(acc), _t(mult), _t(off), relu=False)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tck.requantize(_t(acc), _t(shift), _t(shift)).numpy(),
        np.asarray(jck.requantize(jnp.asarray(acc), jnp.asarray(shift), jnp.asarray(shift))))


def test_conv1_accumulate_equals_jax_op_by_op():
    """The shared sum, float32 and int32, against the JAX function run op by
    op (outside ``jit``, so XLA fuses nothing): bit for bit."""
    import jax

    b, t, c, _ = SHAPES["narrow_odd"]
    x, w1p, _, _, _ = _float_inputs(b, t, c, 1, seed=6)
    with jax.disable_jit():
        want = np.asarray(jck.conv1_accumulate(jnp.asarray(x), jnp.asarray(w1p), t - 2,
                                               jnp.float32))
    got = tck.conv1_accumulate(_t(x), _t(w1p), t - 2, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    xi, w1i = (np.asarray(a) for a in _int8_inputs(b, t, c, 1, seed=6)[:2])
    want_i = np.asarray(jck.conv1_accumulate(jnp.asarray(xi, jnp.int32),
                                             jnp.asarray(w1i, jnp.int32), t - 2, jnp.int32))
    np.testing.assert_array_equal(
        tck.conv1_accumulate(_t(xi), _t(w1i), t - 2, torch.int32).numpy(), want_i)


def test_cpu_wrappers_take_plain_versions_without_counting():
    tck.reset_launch_counts()
    b, t, c, co = SHAPES["narrow_odd"]
    x, w1p, b1, w2p, b2 = _float_inputs(b, t, c, co, seed=7)
    a1 = tck.conv1_stacked(_t(x), _t(w1p), _t(b1))
    assert torch.equal(a1, tck.conv1_stacked_plain(_t(x), _t(w1p), _t(b1)))
    assert torch.equal(tck.conv2_stacked(a1, _t(w2p), _t(b2)),
                       tck.conv2_stacked_plain(a1, _t(w2p), _t(b2)))
    empty = tck.conv1_stacked(_t(x[:0]), _t(w1p), _t(b1))
    assert tuple(empty.shape) == (0, t - 2, 2 * c)
    assert tck.launch_counts() == dict.fromkeys(
        ("conv1_stacked", "conv2_stacked", "conv1_stacked_int8", "conv2_stacked_int8"), 0)


# conv2's route on the card, from the widths and the dtype: (K, Co) per
# shape, then the route per dtype. K must be whole 16-byte rows for TMA, Co
# a multiple of 4; bf16 and int8 take the Hopper route up to K 512 (the
# resident weight), float32 the FFMA route at any K (the weight streamed).
ROUTE_SHAPES = {"default": (512, 80), "narrow_odd": (66, 7), "t300": (512, 80),
                "k200_not_16_bytes_in_int8": (200, 80), "co100": (96, 100),
                "k1024_too_wide": (1024, 80), "co90_not_4": (512, 90)}
ROUTES = {"default": ("wgmma", "ffma", "wgmma"),                # bf16, float32, int8
          "narrow_odd": ("general", "general", "general"),
          "t300": ("wgmma", "ffma", "wgmma"),
          "k200_not_16_bytes_in_int8": ("wgmma", "ffma", "general"),
          "co100": ("wgmma", "ffma", "wgmma"),
          "k1024_too_wide": ("general", "ffma", "general"),
          "co90_not_4": ("general", "general", "general")}


@pytest.mark.parametrize("shape", ROUTE_SHAPES, ids=list(ROUTE_SHAPES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_conv2_route_by_shape_and_dtype(shape, dtype):
    k, co = ROUTE_SHAPES[shape]
    want = dict(zip(("bfloat16", "float32", "int8"), ROUTES[shape]))[dtype]
    assert tck.conv2_route(k, co, getattr(torch, dtype)) == want
    assert tck.conv2_route(k, co, getattr(torch, dtype), aligned=False) == "general"


def test_conv2_route_counts_start_at_zero():
    tck.reset_launch_counts()
    assert tck.route_launch_counts() == {
        "conv2_stacked": {"wgmma": 0, "ffma": 0, "general": 0},
        "conv2_stacked_int8": {"wgmma": 0, "ffma": 0, "general": 0},
        "conv1_stacked_int8": {"dp4a": 0, "general": 0}}


def test_conv2_int8_saturated_sums_equal_jax():
    """conv2's int8 edge (chip_smoke.py's ``int8_saturated`` at B 2): a map
    all 127 under weights all +-127, sums up to 2.5e7 in magnitude, shifts
    and offsets that put the requantized values below, inside and above
    [0, 127]: the port's plain version equals the JAX kernel and golden."""
    r = np.random.default_rng(8)
    b, t, k, co = 2, 126, 512, 80
    plus = r.random((k, 3, co)) < np.linspace(0.0, 1.0, co)
    w2p = np.where(plus, 127, -127).astype(np.int8).reshape(k, 3 * co)
    m2 = r.integers(17, 19, co).astype(np.int32)
    o2 = r.integers(-(1 << 22), 1 << 22, co).astype(np.int32)
    a1 = np.full((b, t, k), 127, np.int8)
    got = tck.conv2_stacked_int8(_t(a1), _t(w2p), _t(m2), _t(o2)).numpy()
    want = np.asarray(jck.conv2_stacked_int8(*_j(a1, w2p, m2, o2), block_b=2, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, gq.conv2_int8(a1, w2p, m2, o2))
    assert (got == 0).any() and (got == 127).any() and ((got > 0) & (got < 127)).any()


def test_conv2_float32_wide_range_within_tolerance_of_jax():
    """chip_smoke.py's ``f32_wide_range`` conv2 edge (``probe.conv2_f32_wide_range``)
    at B 2: map channels spanning 2^-20 .. 2^20 under weights of both
    signs. The port's plain version is within 1e-5 of the map's largest
    magnitude of the JAX kernel, and the ReLU cuts a good share of the sums."""
    from modulationdetectioncnn_torch.scripts.probe import conv2_f32_wide_range

    a1, w2p, b2 = conv2_f32_wide_range(2, seed=10)
    got = tck.conv2_stacked(_t(a1), _t(w2p), _t(b2), out_dtype=torch.float32).numpy()
    want = jck.conv2_stacked(*_j(a1, w2p, b2), out_dtype=jnp.float32, block_b=2, interpret=True)
    _assert_close(got, np.asarray(want), 0.0, 1e-5)
    assert 0.3 < float((got == 0).mean()) < 0.7, float((got == 0).mean())


def test_conv2_ffma_modes_edit_the_kernel_source():
    """``scripts/conv2_ffma_modes.py`` times copies of ``csrc/cnn_kernels.cu``
    with parts of the FFMA body changed: each mode's edit still finds its
    text exactly once (the whole body is the source itself), and the script
    exits without a card."""
    import os

    from modulationdetectioncnn_torch.ops import _build
    from modulationdetectioncnn_torch.scripts import conv2_ffma_modes as modes

    with open(os.path.join(_build.CSRC_DIR, "cnn_kernels.cu")) as f:
        src = f.read()
    for name, edit in modes.MODES.items():
        assert (edit(src) == src) == (name == "whole"), name
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            modes.main(["check"])


def test_float_conv_weights_pack_a_state_dict_as_the_flax_layout_packs():
    """``float_conv_weights`` of a torch VT-CNN2 state dict equals the
    packing helpers applied to the same weights in Flax's layout."""
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2

    st = VTCNN2(generator=torch.Generator().manual_seed(9)).state_dict()
    w1p, b1, w2p, b2 = tck.float_conv_weights(st, "cpu")
    flax_w1 = st["conv1.weight"].permute(2, 3, 1, 0).numpy()     # (1, 3, 1, C1)
    flax_w2 = st["conv2.weight"].permute(2, 3, 1, 0).numpy()     # (2, 3, C1, C2)
    np.testing.assert_array_equal(w1p.numpy(), tck.pack_conv1_weights(flax_w1))
    np.testing.assert_array_equal(w2p.numpy(), tck.pack_conv2_weights(flax_w2))
    assert torch.equal(b1, st["conv1.bias"].float()) and torch.equal(b2, st["conv2.bias"].float())
