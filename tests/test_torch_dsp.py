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
