"""The JAX package's public names in the port, each held to the JAX one on
seeded inputs on the CPU, and the command line's handling of words without
``=`` (ignored with a warning, as the JAX CLI ignores them; a backend name
to ``bench``)."""
import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import modulationdetectioncnn_torch as tpkg
import modulationdetectioncnn_tpu as jpkg
from modulationdetectioncnn_torch import bench as tbench
from modulationdetectioncnn_torch import cli as tcli
from modulationdetectioncnn_torch import data as tdata
from modulationdetectioncnn_torch.data import synthetic as tsyn
from modulationdetectioncnn_torch.dsp import channelizer as tchan
from modulationdetectioncnn_torch.dsp import fir as tfir
from modulationdetectioncnn_torch.dsp import framer as tfr
from modulationdetectioncnn_tpu import cli as jcli
from modulationdetectioncnn_tpu import data as jdata
from modulationdetectioncnn_tpu.data import synthetic as jsyn
from modulationdetectioncnn_tpu.dsp import channelizer as jchan
from modulationdetectioncnn_tpu.dsp import fir as jfir
from modulationdetectioncnn_tpu.dsp import framer as jfr

PACKAGE_NAMES = ("AmcConfig", "MODULATIONS", "generate_frames", "make_dataset",
                 "load_radioml_pickle", "VTCNN2")
DATA_NAMES = ("MODULATIONS", "generate_frames", "make_dataset", "load_radioml_pickle")


def _complex(shape, seed=0) -> np.ndarray:
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("name", PACKAGE_NAMES)
def test_package_exports_the_jax_public_names(name):
    """The JAX package's own ``__init__`` exports ``AmcConfig``; the others
    are public in its ``data`` and ``models`` packages. The port's package
    exports all six."""
    from modulationdetectioncnn_tpu import models as jmodels

    assert any(hasattr(m, name) for m in (jpkg, jdata, jmodels))
    assert name in tpkg.__all__ and hasattr(tpkg, name)


@pytest.mark.parametrize("name", DATA_NAMES)
def test_data_package_exports_the_jax_names(name):
    assert getattr(tdata, name) is getattr(tpkg, name)
    assert hasattr(jdata, name)


def test_modulations_and_generator_version_equal_jax():
    assert tpkg.MODULATIONS == jdata.MODULATIONS == tsyn.MODULATIONS
    assert tsyn.GENERATOR_VERSION == jsyn.GENERATOR_VERSION == 3


def test_package_data_functions_equal_jax(tmp_path):
    got = tpkg.generate_frames(np.random.default_rng(3), "QPSK", 4, 10.0)
    want = jdata.generate_frames(np.random.default_rng(3), "QPSK", 4, 10.0)
    np.testing.assert_array_equal(got, want)
    tcfg = dataclasses.replace(tpkg.AmcConfig().data, classes=("BPSK", "WBFM"),
                               frames_per_class_per_snr=2, snr_db_min=0, snr_db_step=10)
    jcfg = dataclasses.replace(jpkg.AmcConfig().data, classes=("BPSK", "WBFM"),
                               frames_per_class_per_snr=2, snr_db_min=0, snr_db_step=10)
    for a, b in zip(tpkg.make_dataset(tcfg), jdata.make_dataset(jcfg)):
        np.testing.assert_array_equal(a, b)
    path = tmp_path / "rml.pkl"
    r = np.random.default_rng(0)
    with open(path, "wb") as f:
        pickle.dump({("QPSK", 2): r.standard_normal((3, 2, 128)).astype(np.float32),
                     ("BPSK", -4): r.standard_normal((2, 2, 128)).astype(np.float32)}, f)
    for a, b in zip(tpkg.load_radioml_pickle(str(path)), jdata.load_radioml_pickle(str(path))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fir_filter_equals_jax():
    x = _complex((3, 500))
    h = tfir.design_lowpass(33, 0.2)
    got = tfir.fir_filter(x, h)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (3, 500)
    np.testing.assert_allclose(got.numpy(), np.asarray(jfir.fir_filter(jnp.asarray(x), h)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("up,down", [(1, 2), (2, 3), (3, 2)])
def test_fir_resample_equals_jax(up, down):
    x = _complex((2, 600), seed=1)
    h = tfir.design_lowpass(33, 0.5 / max(up, down)) * up
    got = tfir.fir_resample(torch.from_numpy(x), h, up, down)
    want = np.asarray(jfir.fir_resample(jnp.asarray(x), h, up, down))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_concat_blocks_equals_jax_and_inverts_the_blocks():
    x = np.random.default_rng(2).standard_normal((2, 1000)).astype(np.float32)
    blocks = tfr.trim_halo(tfr.overlap_save_blocks(torch.from_numpy(x), 256, 40), 40)
    got = tfr.concat_blocks(blocks, 1000)
    np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfr.concat_blocks(jnp.asarray(blocks.numpy()), 1000)))


def test_iq_frames_and_from_planes_equal_jax():
    frames = _complex((2, 5, 128), seed=3)
    got = tfr.iq_frames(torch.from_numpy(frames))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfr.iq_frames(jnp.asarray(frames))))
    planes = got.numpy()
    back = tfr.from_planes(got)
    assert back.dtype == np.complex64
    np.testing.assert_array_equal(back, jfr.from_planes(planes))
    np.testing.assert_array_equal(tfr.from_planes(planes), frames)


@pytest.mark.parametrize("m", [1, 2, 5, 8, 16])
def test_subband_center_freqs_equal_jax(m):
    np.testing.assert_array_equal(tchan.subband_center_freqs(m), jchan.subband_center_freqs(m))


ARGV = ["foo", "data.frames_per_class_per_snr=2", "bar", "eval.batch_size=64"]


@pytest.mark.parametrize("cmd", ["eval", "stream", "quantize", "train", "qat", "scaling"])
def test_bare_words_are_ignored_as_in_jax(cmd, monkeypatch, capsys):
    """Both CLIs run the command on the same overrides, the words without
    ``=`` dropped; the port says so on stderr."""
    seen = {}
    jname = "cmd_" + cmd
    monkeypatch.setattr(tcli, jname, lambda cfg: seen.setdefault("port", cfg))
    monkeypatch.setattr(jcli, jname, lambda cfg: seen.setdefault("jax", cfg))
    monkeypatch.setattr("modulationdetectioncnn_tpu.utils.device.warm_transfer_async",
                        lambda: None)
    assert tcli.main([cmd, "device=cpu", *ARGV]) == 0
    assert "ignoring foo bar" in capsys.readouterr().err
    jcli.main([cmd, *ARGV])
    port, ref = seen["port"], seen["jax"]
    assert port.data.frames_per_class_per_snr == ref.data.frames_per_class_per_snr == 2
    assert port.eval.batch_size == ref.eval.batch_size == 64


def test_bench_reads_a_bare_word_as_its_backend(monkeypatch):
    seen = {}
    monkeypatch.setattr(tbench, "run_with_stream_extra", lambda cfg: seen.setdefault("cfg", cfg))
    assert tcli.main(["bench", "pallas_int8_v9", "device=cpu", "bench.batch_size=64"]) == 0
    cfg = seen["cfg"]
    assert cfg.bench.backend == "pallas_int8_v9" and cfg.bench.calibrate is False
    assert cfg.bench.batch_size == 64 and cfg.device == "cpu"
    assert tbench.parse_args(["stream"]).bench.mode == "stream"


def _small_configs():
    """The port's and the JAX package's configs at 2 frames per class and
    SNR (the port's on the CPU)."""
    from modulationdetectioncnn_torch.config import apply_overrides as tapply
    from modulationdetectioncnn_tpu.config import apply_overrides as japply

    small = ["data.frames_per_class_per_snr=2"]
    return (tapply(tpkg.AmcConfig(), [*small, "device=cpu"]),
            japply(jpkg.AmcConfig(), small))


def test_build_dataset_with_snrs_equals_jax():
    """``_build_dataset(cfg, snrs)`` builds the synthetic dataset at those
    SNRs alone in both CLIs: the same frames, labels, SNRs and classes."""
    tcfg, jcfg = _small_configs()
    got = tcli._build_dataset(tcfg, [0, 10, 18])
    want = jcli._build_dataset(jcfg, [0, 10, 18])
    assert tuple(got[3]) == tuple(want[3]) and len(got[3]) == 11
    assert sorted(set(got[2].tolist())) == [0, 10, 18]
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)


def test_cmd_train_passes_snrs_as_jax_does(monkeypatch):
    """``cmd_train(cfg, snrs=...)`` trains on the split of that dataset in
    both CLIs (the training loop replaced by one that records its data)."""
    from modulationdetectioncnn_torch.train import loop as tloop
    from modulationdetectioncnn_tpu.train import loop as jloop

    seen = {}

    def recorder(side):
        def train(cfg, tr, te):
            seen[side] = (tr, te)
            return None, []
        return train

    monkeypatch.setattr(tloop, "train", recorder("port"))
    monkeypatch.setattr(jloop, "train", recorder("jax"))
    tcfg, jcfg = _small_configs()
    got = tcli.cmd_train(tcfg, snrs=[0, 10, 18])
    want = jcli.cmd_train(jcfg, snrs=[0, 10, 18])
    for (ta, tb), (ja, jb) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
    for a, b in zip(got[2], want[2]):            # the held-out (x, y, snr)
        np.testing.assert_array_equal(a, b)
    assert tuple(got[3]) == tuple(want[3])


BF16_BUILDERS = ("make_bf16_forward", "make_bf16_forward_v2", "make_bf16_classifier_v4")


@pytest.mark.parametrize("name", BF16_BUILDERS)
def test_infer_exports_the_jax_bf16_builders(name):
    """The JAX package's ``ops/infer.py`` holds its bf16 builders; the
    port's gives the same names, its ``ops/infer_bf16.py`` builders (held
    to the JAX ones by ``tests/test_torch_bf16*.py``), with the same first
    parameter."""
    import inspect

    from modulationdetectioncnn_torch.ops import infer as tinfer
    from modulationdetectioncnn_torch.ops import infer_bf16
    from modulationdetectioncnn_tpu.ops import infer as jinfer

    fn = getattr(tinfer, name)
    assert fn is getattr(infer_bf16, name)
    assert next(iter(inspect.signature(fn).parameters)) == next(
        iter(inspect.signature(getattr(jinfer, name)).parameters)) == "params"
    with pytest.raises(AttributeError):
        tinfer.make_bf16_nothing


def test_cmd_bench_returns_the_bench_run_as_jax_does(monkeypatch):
    """``cli.cmd_bench(cfg)`` returns the benchmark's ``run(cfg)`` in both
    CLIs (each ``run`` replaced by one that records its config)."""
    import sys
    import types

    jbench = types.ModuleType("bench")
    jbench.run = lambda cfg: {"jax": cfg}
    monkeypatch.setitem(sys.modules, "bench", jbench)
    monkeypatch.setattr(tbench, "run", lambda cfg: {"port": cfg})
    tcfg, jcfg = tpkg.AmcConfig(), jpkg.AmcConfig()
    assert tcli.cmd_bench(tcfg) == {"port": tcfg}
    assert jcli.cmd_bench(jcfg) == {"jax": jcfg}
