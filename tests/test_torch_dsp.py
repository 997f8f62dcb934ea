"""The port's streaming front end against the JAX package, on the CPU.

Same numpy-seeded inputs through both packages' plane APIs, with the
tolerances tests/test_dsp.py states against the golden chain: 2e-4 for the
channelizer, exact for overlap-save blocks and frames. Power and CFO
normalization do the same f32 arithmetic in the same order; only matmul
summation order differs between the two libraries.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch.data import synthetic as tsyn
from modulationdetectioncnn_torch.dsp import channelizer as tch
from modulationdetectioncnn_torch.dsp import framer as tfr
from modulationdetectioncnn_torch.dsp import normalize as tnorm
from modulationdetectioncnn_tpu.data import synthetic as jsyn
from modulationdetectioncnn_tpu.dsp import channelizer as jch
from modulationdetectioncnn_tpu.dsp import framer as jfr
from modulationdetectioncnn_tpu.dsp import normalize as jnorm
from modulationdetectioncnn_tpu.golden import dsp as gold


@pytest.fixture(scope="module")
def stream():
    r = np.random.default_rng(5)
    t = np.arange(4096)
    x = (np.exp(2j * np.pi * 0.07 * t) + 0.5 * np.exp(2j * np.pi * -0.21 * t)
         + 0.1 * (r.standard_normal(4096) + 1j * r.standard_normal(4096)))
    return x.astype(np.complex64)


def _qpsk_frames(n_frames=6, n=128, seed=11):
    r = np.random.default_rng(seed)
    cfo = r.uniform(-4e-3, 4e-3, n_frames)
    syms = r.integers(0, 4, (n_frames, n))
    x = np.exp(1j * (np.pi / 2 * syms + np.pi / 4)) * np.exp(
        2j * np.pi * cfo[:, None] * np.arange(n))
    x = x + 0.05 * (r.standard_normal((n_frames, n)) + 1j * r.standard_normal((n_frames, n)))
    return x.astype(np.complex64), cfo


def test_design_prototype_equals_golden():
    for m, taps in ((16, 8), (8, 4)):
        np.testing.assert_array_equal(tch.design_prototype(m, taps),
                                      gold.design_prototype(m, taps))


@pytest.mark.parametrize("m,taps", [(16, 8), (8, 8)])
def test_channelizer_matches_jax_and_golden(stream, m, taps):
    h = gold.design_prototype(m, taps)
    got = tch.channelize(tfr.to_planes(stream), h, m).numpy()
    want_jax = np.asarray(jch.channelize(jfr.to_planes(stream), h, m))
    want_gold = gold.pfb_channelize(stream.astype(np.complex128), h, m)
    assert got.shape == want_jax.shape == (2, len(stream) // m, m)
    np.testing.assert_allclose(got, want_jax, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[0], want_gold.real, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[1], want_gold.imag, rtol=2e-4, atol=2e-4)


def test_dft_iq_matches_numpy_fft():
    v = np.random.default_rng(2).standard_normal((3, 2, 64, 16)).astype(np.float32)
    got = tch.dft_iq(torch.from_numpy(v)).numpy()
    want = np.fft.fft(v[:, 0] + 1j * v[:, 1], axis=-1)
    np.testing.assert_allclose(got[:, 0], want.real, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[:, 1], want.imag, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("block,halo", [(512, 64), (1000, 112), (4096, 0)])
def test_overlap_save_blocks_equal_jax(stream, block, halo):
    x = tfr.to_planes(stream)
    got = tfr.overlap_save_blocks(x, block, halo).numpy()
    want = np.asarray(jfr.overlap_save_blocks(jfr.to_planes(stream), block, halo))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tfr.trim_halo(torch.from_numpy(want.copy()), halo).numpy(),
        np.asarray(jfr.trim_halo(jnp.asarray(want), halo)))
    blocks_g = gold.overlap_save_blocks(stream, block_len=block, halo=halo)
    np.testing.assert_array_equal(got[0], blocks_g.real.astype(np.float32))


@pytest.mark.parametrize("t_len,flen,hop", [(517, 128, 128), (517, 128, 32),
                                            (1024, 128, 64), (100, 128, 128)])
def test_frames_from_stream_equal_jax(t_len, flen, hop):
    x = np.random.default_rng(123).standard_normal((3, 2, t_len)).astype(np.float32)
    got = tfr.frames_from_stream(torch.from_numpy(x), flen, hop).numpy()
    want = np.asarray(jfr.frames_from_stream(jnp.asarray(x), flen, hop))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_to_planes_equals_jax(stream):
    np.testing.assert_array_equal(tfr.to_planes(stream).numpy(),
                                  np.asarray(jfr.to_planes(stream)))


def test_power_normalize_matches_jax():
    r = np.random.default_rng(17)
    x = ((r.standard_normal((5, 128)) + 1j * r.standard_normal((5, 128))) * 3.0)
    planes = np.stack([x.real, x.imag], axis=-2).astype(np.float32)
    got = tnorm.power_normalize(torch.from_numpy(planes)).numpy()
    want = np.asarray(jnorm.power_normalize(jnp.asarray(planes)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose((got ** 2).sum(axis=-2).mean(axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("pad_factor", [4, 2])
def test_estimate_cfo_matches_jax_and_golden(pad_factor):
    x, cfo = _qpsk_frames()
    planes = np.stack([x.real, x.imag], axis=-2).astype(np.float32)
    got = tnorm.estimate_cfo(torch.from_numpy(planes), pad_factor=pad_factor).numpy()
    want = np.asarray(jnorm.estimate_cfo(jnp.asarray(planes), pad_factor=pad_factor))
    assert got.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, cfo, rtol=0, atol=2e-4)
    if pad_factor == 4:
        want_gold = np.array([gold.estimate_cfo(f) for f in x])
        np.testing.assert_allclose(got, want_gold, rtol=0, atol=5e-5)


def test_correct_cfo_matches_jax():
    x, cfo = _qpsk_frames()
    planes = np.stack([x.real, x.imag], axis=-2).astype(np.float32)
    c = cfo.astype(np.float32)
    got = tnorm.correct_cfo(torch.from_numpy(planes), torch.from_numpy(c)).numpy()
    want = np.asarray(jnorm.correct_cfo(jnp.asarray(planes), jnp.asarray(c)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    resid = tnorm.estimate_cfo(torch.from_numpy(got)).numpy()
    assert np.all(np.abs(resid) < 2e-4)


@pytest.mark.parametrize("mod", ["BPSK", "QPSK", "GFSK", "QAM16", "CPFSK",
                                 "WBFM", "AM-SSB"])
def test_generate_frames_equal_jax(mod):
    """The port's copy of the generator draws the same frames from a seed."""
    got = tsyn.generate_frames(np.random.default_rng(4), mod, 3, 10.0,
                               tsyn.DataConfig(frame_len=256))
    want = jsyn.generate_frames(np.random.default_rng(4), mod, 3, 10.0,
                                jsyn.DataConfig(frame_len=256))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------ resampler and timing
#
# The resampler is a float32 matmul in both packages (XLA's and PyTorch's
# CPU kernels sum in their own orders), so it is held to the JAX package at
# 1e-5 and to the golden at the 3e-4 of tests/test_dsp.py. The timing
# correction does the JAX kernel's multiplies and adds in its order; XLA's
# CPU backend contracts some multiply-adds into FMAs, which the port (like
# its CUDA kernel) does not, so it is held within 2e-6 of the JAX package on
# unit-power frames, and at tests/test_dsp.py's 1e-4 to the golden.

from modulationdetectioncnn_torch.dsp import fir as tfir  # noqa: E402
from modulationdetectioncnn_tpu.dsp import fir as jfir  # noqa: E402


def _planes_of(x):
    return np.stack([x.real, x.imag], axis=-2).astype(np.float32)


def test_design_filters_equal_jax_and_golden():
    for taps, cutoff in ((33, 0.25), (33, 0.5 / 3), (65, 0.1)):
        np.testing.assert_array_equal(tfir.design_lowpass(taps, cutoff),
                                      jfir.design_lowpass(taps, cutoff))
    for p, t in ((32, 8), (16, 4)):
        np.testing.assert_array_equal(tch.design_interp(p, t), gold.design_interp(p, t))
        np.testing.assert_array_equal(tnorm._interp_bank(p, t), jnorm._interp_bank(p, t))


@pytest.mark.parametrize("up,down", [(1, 2), (2, 1), (3, 2), (2, 3)])
def test_resample_window_matrix_equals_jax(up, down):
    h = jfir.design_lowpass(33, 0.5 / max(up, down))
    halo, k_pad, r_tile = tfir.resample_geometry(33, up, down)
    assert r_tile > 0
    np.testing.assert_array_equal(
        tfir._resample_window_matrix(tuple(h.tolist()), up, down, r_tile, k_pad, halo),
        jfir._resample_window_matrix(h, up, down, r_tile, k_pad, halo))


@pytest.mark.parametrize("up,down", [(1, 2), (2, 1), (3, 2), (2, 3)])
def test_fir_resample_matches_jax_and_golden(stream, up, down):
    h = jfir.design_lowpass(33, 0.5 / max(up, down) * 0.8)
    got = tfir.fir_resample_iq(tfr.to_planes(stream), h, up, down).numpy()
    want_jax = np.asarray(jfir.fir_resample_iq(jfr.to_planes(stream), h, up, down))
    want_gold = _planes_of(gold.fir_resample(stream, h, up, down))
    assert got.shape == want_jax.shape == want_gold.shape == (2, -(-4096 * up // down))
    np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_gold, rtol=3e-4, atol=3e-4)


def test_fir_resample_degenerate_geometry_takes_the_conv_form(stream):
    """301 taps at 1/3: the window would hold more history than new
    samples, so both packages fall back to the zero-stuffed strided conv;
    leading axes are kept."""
    h = jfir.design_lowpass(301, 0.5 / 3)
    assert tfir.resample_geometry(301, 1, 3)[2] == 0
    x = np.stack([_planes_of(stream[:1000]), _planes_of(stream[1000:2000])])
    got = tfir.fir_resample_iq(torch.from_numpy(x), h, 1, 3).numpy()
    want_jax = np.asarray(jfir.fir_resample_iq(jnp.asarray(x), h, 1, 3))
    assert got.shape == want_jax.shape == (2, 2, 334)
    np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-5)
    want_gold = _planes_of(gold.fir_resample(stream[:1000], h, 1, 3))
    np.testing.assert_allclose(got[0], want_gold, rtol=3e-4, atol=3e-4)


def test_fir_filter_matches_jax_and_golden(stream):
    h = gold.design_prototype(4, 8)
    got = tfir.fir_filter_iq(tfr.to_planes(stream), h).numpy()
    np.testing.assert_allclose(got, np.asarray(jfir.fir_filter_iq(jfr.to_planes(stream), h)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _planes_of(gold.fir_filter(stream, h)),
                               rtol=2e-4, atol=2e-4)


def _rrc_bpsk(n_frames=5, sps=8, seed=13):
    from modulationdetectioncnn_tpu.data.synthetic import rrc_filter

    r = np.random.default_rng(seed)
    out = []
    for _ in range(n_frames):
        syms = (r.integers(0, 2, 32) * 2 - 1).astype(np.float64)
        up = np.zeros(len(syms) * sps)
        up[::sps] = syms
        x = np.convolve(up, rrc_filter(0.35, sps, 6))[:len(up)]
        out.append(np.roll(x, r.integers(0, sps)) + 0.05 * r.standard_normal(len(up)))
    return np.asarray(out).astype(np.complex64)


def test_estimate_timing_matches_jax_and_golden():
    """Sums over the frame in another order, and atan2: within 1e-5
    samples of the JAX package, 1e-3*sps of the golden (tests/test_dsp.py)."""
    x = _rrc_bpsk()
    planes = _planes_of(x)
    got = tnorm.estimate_timing(torch.from_numpy(planes), 8).numpy()
    want = np.asarray(jnorm.estimate_timing(jnp.asarray(planes), 8))
    assert got.shape == (5,) and np.all((got >= 0) & (got < 8))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want_gold = np.array([gold.estimate_timing(f, 8) for f in x])
    np.testing.assert_allclose(got, want_gold, rtol=0, atol=1e-3 * 8)


# tau at both ends of the wrap to [-sps/2, sps/2), on the rounding
# boundaries of tau_c*32 beside them (x.5 rounds to even), at 0 and beyond
# one period: the delay d runs over 0..8 and d + i reaches 16.
TAUS = np.array([-4.0, -4.0 + 1e-6, 4.0 - 1e-6, 4.0, 0.0, -1e-6, 8.0 - 1e-6, 12.0,
                 -3.984375, 3.984375, 0.015625, -0.015625, 1.3, 6.25, 2.5, 7.9],
                np.float32)


def _fir_loop(x, c, fused):
    """The timing FIR as a NumPy float32 loop over the 17 taps: each
    multiply and add rounded (``fused`` False), or one rounding per
    multiply-add, an FMA (float64 holds the product exactly)."""
    xp = np.pad(x, [(0, 0), (0, 0), (8, 8)])
    acc = np.zeros_like(x)
    for j in range(17):
        xs, cj = xp[..., j:j + x.shape[-1]], c[:, None, j:j + 1]
        if fused:
            acc = (acc.astype(np.float64) + xs.astype(np.float64) * cj).astype(np.float32)
        else:
            acc = (acc + (xs * cj).astype(np.float32)).astype(np.float32)
    return acc


@pytest.mark.parametrize("lead", [(16,), (4, 4), (2, 2, 4)], ids=["b16", "b4x4", "b2x2x4"])
def test_correct_timing_matches_jax_with_the_same_tau(lead):
    """Same frames, same tau (so the same phase and delay per frame):
    within 2e-6 of the JAX package. The difference is XLA's: its CPU
    backend fuses each multiply-add of the interpret-mode kernel into an
    FMA (it equals the fused loop bit for bit), where the port rounds the
    multiply and the add (it equals the unfused loop bit for bit), as the
    CUDA kernel does."""
    x = np.random.default_rng(21).standard_normal(lead + (2, 128)).astype(np.float32)
    tau = TAUS.reshape(lead)
    got = tnorm.correct_timing(torch.from_numpy(x), torch.from_numpy(tau), 8).numpy()
    want = np.asarray(jnorm.correct_timing(jnp.asarray(x), jnp.asarray(tau), 8))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    c = tnorm.timing_filters(torch.from_numpy(tau), 8).numpy()
    flat = x.reshape(-1, 2, 128)
    np.testing.assert_array_equal(got.reshape(flat.shape), _fir_loop(flat, c, fused=False))
    np.testing.assert_array_equal(want.reshape(flat.shape), _fir_loop(flat, c, fused=True))


def test_correct_timing_matches_golden():
    """tests/test_dsp.py's case through the port: within 1e-4 of the
    golden polyphase fractional delay."""
    r = np.random.default_rng(21)
    xs = (r.standard_normal((6, 128)) + 1j * r.standard_normal((6, 128))).astype(np.complex64)
    taus = np.array([0.0, 1.3, 7.9, 4.0, 6.25, 2.5])
    want = np.stack([gold.correct_timing(x, t, 8) for x, t in zip(xs, taus)])
    got = tnorm.correct_timing(torch.from_numpy(_planes_of(xs)),
                               torch.from_numpy(taus.astype(np.float32)), 8).numpy()
    np.testing.assert_allclose(got[:, 0], want.real, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[:, 1], want.imag, rtol=1e-4, atol=1e-4)


def test_timing_filters_place_the_phase_at_the_delay():
    """Each frame's 17 weights are the reversed phase filter of the bank
    shifted by the integer delay d, zero elsewhere; the wrap ends reach
    d = 0 and d = 8 (the last lane)."""
    c = tnorm.timing_filters(torch.from_numpy(TAUS), 8).numpy()
    g = tnorm._interp_bank(32, 8)[:, ::-1]
    tau_c = np.mod(TAUS.astype(np.float64) + 4.0, 8.0) - 4.0
    s = np.round(tau_c * 32).astype(np.int64) + 128
    d, p = s // 32, s % 32
    assert d.min() == 0 and d.max() == 8
    for i in range(len(TAUS)):
        want = np.zeros(17, np.float32)
        want[d[i]:d[i] + 9] = g[p[i]]
        np.testing.assert_array_equal(c[i], want)


def test_timing_fir_plain_rounds_each_multiply_and_add():
    """The plain version's order of arithmetic, which the CUDA kernel
    repeats: acc = acc + x*c[j] for j = 0..16 in float32, from 0, with
    zeros outside the frame. Equal to a NumPy float32 loop, bit for bit."""
    r = np.random.default_rng(4)
    x = r.standard_normal((3, 2, 128)).astype(np.float32)
    c = r.standard_normal((3, 17)).astype(np.float32)
    got = tnorm.correct_timing_fir_plain(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, _fir_loop(x, c, fused=False))


def test_timing_fir_wrapper_takes_plain_on_cpu_and_checks_cuda_args():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 2, 128)).astype(np.float32))
    c = tnorm.timing_filters(torch.tensor([0.0, 1.0, 2.0, 7.5]), 8)
    tnorm.correct_timing_fir.launches = 0
    np.testing.assert_array_equal(tnorm.correct_timing_fir(x, c).numpy(),
                                  tnorm.correct_timing_fir_plain(x, c).numpy())
    assert tnorm.correct_timing_fir.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tnorm.correct_timing_fir(x.to("meta"), c.to("meta"))
    with pytest.raises(ValueError, match="does not match"):
        tnorm.correct_timing(x, torch.zeros(3), 8)
