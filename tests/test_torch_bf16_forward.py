"""The port's bf16 forwards (``make_bf16_forward_v2``, ``make_bf16_forward``)
and their three stages against the JAX package, on the CPU.

Float weights come from the JAX tests' seeded Flax init (full width, and a
narrow model the port pads to the kernels' widths) and are carried with the
port's ``make_bf16_weights``; frames from ``default_rng(7)``, B = 16. The
JAX side runs its Pallas kernels in interpret mode: each conv kernel and the
dense kernel alone through its own ``pallas_call`` (as ``make_bf16_forward``
and ``make_bf16_forward_v2`` call them), and both whole forwards; the port's
wrappers take their plain versions on CPU tensors. Tolerances, each with
its reason:

- conv maps: ``2**-7 * |ref| + 1e-3 * max|ref|`` (one bf16 ulp, plus the
  elements next to the ReLU edge): the frameworks sum conv2's f32 products
  in other orders, and the map is rounded to bf16 after;
- dense logits, on the same map: ``2**-7 * sum_d |d1_d| |w4_dc|`` (each
  dense1 unit may round to a neighbouring bf16 after sums in another
  order) plus 1e-6 of the largest logit (dense2's f32 sums);
- whole forwards: ``2**-7 * max|logits|`` against JAX, and the JAX tests'
  own bound against golden (max |dlogit| < 5e-2, tests/test_ops_infer.py).
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
from modulationdetectioncnn_tpu.ops.cnn_kernels import (
    conv1_accumulate, pack_conv1_weights, pack_conv2_weights)

RTOL = 2.0 ** -7
WIDTHS = {"full_width": {},
          "narrow_padded": {"num_classes": 2, "conv1_filters": 32, "conv2_filters": 16,
                            "dense_units": 32}}
WRAPPERS = ("conv_stage_bf16_v4", "dense_argmax_bf16", "conv_stage_bf16_v2",
            "dense_logits_bf16", "conv_stage_bf16")


@pytest.fixture(scope="module", params=list(WIDTHS), ids=list(WIDTHS))
def case(request):
    """(params, frames, the JAX forwards' logits, the port's weights) for one
    width; each JAX forward is built and run once per module."""
    model = VTCNN2(dtype=jnp.float32, **WIDTHS[request.param])
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0), jnp.zeros((1, 2, 128))))
    x = np.random.default_rng(7).standard_normal((16, 2, 128)).astype(np.float32)
    kw = {"block_b": 8, "chunk": 4, "dense_block_b": 16, "interpret": True}
    logits = {"v1": np.asarray(jinfer.make_bf16_forward(params, **kw)(jnp.asarray(x))),
              "v2": np.asarray(jinfer.make_bf16_forward_v2(params, **kw)(jnp.asarray(x)))}
    return params, x, logits, tb.make_bf16_weights(params, "cpu")


def _consts(params):
    p = params["params"]
    w1p = pack_conv1_weights(p["Conv1"]["kernel"]).astype(np.float32)
    b1 = np.concatenate([p["Conv1"]["bias"]] * 2).astype(np.float32)
    w2p = pack_conv2_weights(p["Conv2"]["kernel"]).astype(jnp.bfloat16)
    b2 = p["Conv2"]["bias"].astype(np.float32)
    return p, w1p, b1, w2p, b2


def _spec(a):
    return pl.BlockSpec(a.shape, (lambda i: (0,)) if a.ndim == 1 else (lambda i: (0, 0)))


def jax_conv_map(params, x, version, block_b=8, chunk=4):
    """The JAX package's bf16 conv kernel alone (interpret mode): v2
    (``_conv_stage_bf16_v2_kernel``) on the bf16 tap rows with the bias
    lane, as ``make_bf16_forward_v2`` feeds it, or the f32-conv1 kernel
    (``_conv_stage_bf16_kernel``) on the f32 frames, as ``make_bf16_forward``
    does. Returns its (B, 124, c2) map as float32."""
    p, w1p, b1, w2p, b2 = _consts(params)
    b, c2 = x.shape[0], b2.shape[0]
    if version == "v2":
        w1e = jinfer.expand_conv1_weights(w1p)
        w1e[6, :] = b1
        consts = [jnp.asarray(a) for a in (w1e.astype(jnp.bfloat16), w2p, b2)]
        xe = jinfer.expand_taps(jnp.asarray(x).astype(jnp.bfloat16), 126)
        inp = xe.at[..., 6].set(jnp.bfloat16(1.0)).reshape(b * 126, 8)
        kernel = functools.partial(jinfer._conv_stage_bf16_v2_kernel, chunk=chunk, t1=126,
                                   c2=c2)
        in_spec = pl.BlockSpec((block_b * 126, 8), lambda i: (i, 0))
    else:
        consts = [jnp.asarray(a) for a in (w1p, b1, w2p, b2)]
        inp = jnp.asarray(x)
        kernel = functools.partial(jinfer._conv_stage_bf16_kernel, chunk=chunk, t_in=128,
                                   c2=c2)
        in_spec = pl.BlockSpec((block_b, 2, 128), lambda i: (i, 0, 0))
    out = pl.pallas_call(
        kernel, grid=(b // block_b,), in_specs=[in_spec] + [_spec(a) for a in consts],
        out_specs=pl.BlockSpec((block_b, 124, c2), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, 124, c2), jnp.bfloat16), interpret=True,
    )(inp, *consts)
    return np.asarray(out.astype(jnp.float32))


def jax_dense_logits(params, h, block_b=8):
    """The JAX package's ``_dense_stage_bf16_kernel`` alone (interpret mode)
    on the (B, 124 * c2) bf16 map ``h``, with the forwards' weights; its
    (B, nc) logits."""
    p = params["params"]
    nc = p["Dense2"]["bias"].shape[0]
    consts = [jnp.asarray(a) for a in (
        p["Dense1"]["kernel"].astype(jnp.bfloat16), p["Dense1"]["bias"].astype(np.float32),
        jinfer._pad_cols(p["Dense2"]["kernel"]).astype(jnp.bfloat16),
        jinfer._pad_cols(p["Dense2"]["bias"]).astype(np.float32))]
    b, k = h.shape
    out = pl.pallas_call(
        jinfer._dense_stage_bf16_kernel, grid=(b // block_b,),
        in_specs=[pl.BlockSpec((block_b, k), lambda i: (i, 0))] + [_spec(a) for a in consts],
        out_specs=pl.BlockSpec((block_b, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((b, 128), jnp.float32), interpret=True,
    )(jnp.asarray(h), *consts)
    return np.asarray(out)[:, :nc]


def assert_map_close(got: np.ndarray, want: np.ndarray):
    atol = 1e-3 * np.abs(want).max()
    bad = np.abs(got - want) > RTOL * np.abs(want) + atol
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


def _map(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("version", ["v2", "f32_conv1"])
def test_conv_map_matches_pallas(case, version):
    """Rows 14 and 12: the port's plain conv map (through its CPU wrapper)
    within the map tolerance of the JAX kernel's, at both widths."""
    params, x, _, bw = case
    xt = torch.from_numpy(x)
    if version == "v2":
        got = tb.conv_stage_bf16_v2(tb.expand_taps_bf16(xt), bw)
    else:
        got = tb.conv_stage_bf16(xt, bw)
    want = jax_conv_map(params, x, "v2" if version == "v2" else "v1")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert_map_close(_map(got), want)
    assert 0 < (want > 0).mean() < 1


def test_v2_map_equals_v4_map(case):
    """Row 14 computes row 15's function from the tap rows of the same
    frames: the plain maps are equal bit for bit, and so are their conv1s."""
    _, x, _, bw = case
    xt = torch.from_numpy(x)
    xe = tb.expand_taps_bf16(xt)
    assert torch.equal(tb.conv_stage_bf16_v2_plain(xe, bw), tb.conv_stage_bf16_v4_plain(xt, bw))
    assert torch.equal(tb.conv1_bf16_rows_plain(xe, bw), tb.conv1_bf16_plain(xt, bw))


def test_expand_taps_bf16_layout(case):
    """The v2 prologue: lane 3h+k of row t is the bf16 frame's x[h, t+k],
    lane 6 is 1.0 and lane 7 zero, as JAX ``expand_taps`` + ``.at[..., 6]``."""
    _, x, _, _ = case
    got = tb.expand_taps_bf16(torch.from_numpy(x))
    want = jinfer.expand_taps(jnp.asarray(x).astype(jnp.bfloat16), 126).at[..., 6].set(1.0)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (16, 126, 8)
    np.testing.assert_array_equal(_map(got), np.asarray(want.astype(jnp.float32)))


def test_f32_conv1_is_conv1_accumulate_bit_for_bit(case):
    """Row 12's conv1 before ReLU and its bf16 rounding: equal, bit for bit,
    to the JAX package's ``conv1_accumulate`` + b1 on the unrounded frames
    with the f32 taps, each op run on its own (as the TPU's vector unit
    rounds each product and sum). Under ``jax.jit`` XLA's CPU backend fuses
    the products and sums into FMAs, which round once; the kernel does not
    (``__fmul_rn``, ``__fadd_rn``)."""
    params, x, _, bw = case
    _, w1p, b1, _, _ = _consts(params)
    got = tb.conv1_f32_plain(torch.from_numpy(x), bw)
    c1 = w1p.shape[1]
    want = np.asarray(conv1_accumulate(jnp.asarray(x), jnp.asarray(w1p), 126, jnp.float32)
                      + jnp.asarray(b1))
    assert got.dtype == torch.float32
    padded = got.numpy()[..., np.r_[0:c1, 256:256 + c1]]
    np.testing.assert_array_equal(padded, want)
    # Padded channels compute exact zeros.
    assert not got[..., c1:256].any() and not got[..., 256 + c1:].any()


def test_dense_logits_match_pallas(case):
    """Row 13: the port's plain logits (through its CPU wrapper) on the port's
    plain v2 map against the JAX dense kernel on the same map, within one
    bf16 ulp of every dense1 unit times |w4|; classes >= nc at -inf."""
    params, x, _, bw = case
    conv = tb.conv_stage_bf16_v2_plain(tb.expand_taps_bf16(torch.from_numpy(x)), bw)
    got = tb.dense_logits_bf16(conv, bw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 11)
    assert torch.isinf(got[:, bw.nc:]).all()
    h = conv[..., :bw.c2].reshape(16, -1)
    want = jax_dense_logits(params, np.asarray(h.to(torch.float32).numpy(), jnp.bfloat16))
    d1 = tb.dense1_bf16_plain(conv, bw)
    bound = RTOL * (d1.abs() @ bw.w4.to(torch.float32).abs())[:, :bw.nc].numpy()
    diff = np.abs(got[:, :bw.nc].numpy() - want)
    assert (diff <= bound + 1e-6 * np.abs(want).max()).all(), float(diff.max())


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_forward_matches_jax_and_golden(case, version):
    """Both whole forwards on the CPU: (16, nc) f32 logits within one bf16
    ulp of the largest JAX logit of the JAX forward (interpret mode), within
    the JAX tests' 5e-2 of golden, and labels equal to the JAX forward's on
    >= 15 of 16 frames (near-ties may flip)."""
    params, x, logits, _ = case
    make = tb.make_bf16_forward_v2 if version == "v2" else tb.make_bf16_forward
    got = make(params, "cpu")(torch.from_numpy(x)).numpy()
    want = logits[version]
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    assert np.abs(got - gcnn.vtcnn2_forward(params, x)).max() < 5e-2
    assert (got.argmax(-1) == want.argmax(-1)).sum() >= 15


def test_weight_carry_of_the_f32_conv1(case):
    """The f32 conv1 fields: ``w1p`` (3, 256) the Flax taps unrounded, ``b1``
    (512,) the bias duplicated over the planes, zero-padded for the narrow
    model; a Flax tree and its state dict pack the same, every field."""
    params, _, _, bw = case
    p = params["params"]
    c1 = p["Conv1"]["bias"].shape[0]
    w1 = torch.from_numpy(np.array(p["Conv1"]["kernel"], np.float32).reshape(3, c1))
    b1 = torch.from_numpy(np.array(p["Conv1"]["bias"], np.float32))
    assert bw.w1p.dtype == bw.b1.dtype == torch.float32
    assert tuple(bw.w1p.shape) == (3, 256) and tuple(bw.b1.shape) == (512,)
    assert torch.equal(bw.w1p[:, :c1], w1) and not bw.w1p[:, c1:].any()
    assert torch.equal(bw.b1[:c1], b1) and torch.equal(bw.b1[256:256 + c1], b1)
    assert not bw.b1[c1:256].any() and not bw.b1[256 + c1:].any()
    widths = {k: v for k, v in zip(("conv1_filters", "conv2_filters", "dense_units",
                                    "num_classes"),
                                   (c1, p["Conv2"]["bias"].shape[0],
                                    p["Dense1"]["bias"].shape[0],
                                    p["Dense2"]["bias"].shape[0]))}
    from modulationdetectioncnn_torch.config import ModelConfig

    sd = TVTCNN2.from_config(ModelConfig(**widths)).state_dict() | params_from_flax(params)
    bsd = tb.make_bf16_weights(sd, "cpu")
    for f in ("w1e", "w1p", "b1", "w2t", "b2", "w3t", "b3", "w4", "b4"):
        assert torch.equal(getattr(bw, f), getattr(bsd, f)), f


def test_cpu_wrappers_take_plain_versions_without_counting(case):
    """On CPU tensors the three new wrappers return their plain versions'
    results, and no wrapper counts a launch; B = 0 gives empty results from
    both forwards and the v4 classifier (whose plain dense stage raised on
    an empty batch before)."""
    params, x, _, bw = case
    tb.reset_launch_counts()
    xt = torch.from_numpy(x)
    xe = tb.expand_taps_bf16(xt)
    c2 = bw.c2
    assert torch.equal(tb.conv_stage_bf16_v2(xe, bw), tb.conv_stage_bf16_v2_plain(xe, bw)[..., :c2])
    assert torch.equal(tb.conv_stage_bf16(xt, bw), tb.conv_stage_bf16_plain(xt, bw)[..., :c2])
    conv = tb.conv_stage_bf16_plain(xt, bw)
    assert torch.equal(tb.dense_logits_bf16(conv, bw), tb.dense_logits_bf16_plain(conv, bw))
    for make in (tb.make_bf16_forward_v2, tb.make_bf16_forward):
        assert tuple(make(params, "cpu")(xt[:0]).shape) == (0, bw.nc)
    assert tuple(tb.make_bf16_classifier_v4(params, "cpu")(xt[:0]).shape) == (0,)
    assert tb.launch_counts() == dict.fromkeys(WRAPPERS, 0)


def test_cuda_wrappers_reject_what_the_kernel_does_not_take(case):
    """Checks that run before any launch: device (a meta tensor stands in
    for a tensor on no card), dtype and shape, and a model wider than the
    kernels; no launch is counted."""
    params, _, _, bw = case
    tb.reset_launch_counts()
    frames = torch.zeros((1, 2, 128), device="meta")
    rows = torch.zeros((1, 126, 8), dtype=torch.bfloat16, device="meta")
    conv_map = torch.zeros((1, 124, 80), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tb.conv_stage_bf16_v2(rows, bw)
    with pytest.raises(ValueError, match="unsupported device"):
        tb.conv_stage_bf16(frames, bw)
    with pytest.raises(ValueError, match="unsupported device"):
        tb.dense_logits_bf16(conv_map, bw)
    with pytest.raises(ValueError, match="expected"):
        tb.conv_stage_bf16_v2(rows.to(torch.float32), bw)
    with pytest.raises(ValueError, match="expected"):
        tb.conv_stage_bf16_v2(torch.zeros((1, 2, 128), dtype=torch.bfloat16, device="meta"), bw)
    with pytest.raises(ValueError, match="expected"):
        tb.conv_stage_bf16(frames.to(torch.bfloat16), bw)
    with pytest.raises(ValueError, match="expected"):
        tb.dense_logits_bf16(conv_map.to(torch.float32), bw)
    model = VTCNN2(dtype=jnp.float32, conv1_filters=300)
    wide = tb.make_bf16_weights(jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 2, 128)))), "cpu")
    assert tuple(wide.w1p.shape) == (3, 300) and tuple(wide.b1.shape) == (600,)
    with pytest.raises(ValueError, match="built for"):
        tb.conv_stage_bf16(frames, wide)
    with pytest.raises(ValueError, match="built for"):
        tb.conv_stage_bf16_v2(rows, wide)
    assert tb.launch_counts() == dict.fromkeys(WRAPPERS, 0)


@pytest.mark.parametrize("entry", ["make_bf16_forward_v2", "make_bf16_forward", "bench"])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(entry):
    """Both forwards and bench ``pallas_bf16`` run on the card unless the
    caller passes device=cpu: without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the entry point would run on it")
    if entry == "bench":
        from modulationdetectioncnn_torch import cli

        with pytest.raises(RuntimeError, match="device=cpu"):
            cli.main(["bench", "bench.backend=pallas_bf16"])
        return
    with pytest.raises(RuntimeError, match="device=cpu"):
        getattr(tb, entry)(TVTCNN2().state_dict())
