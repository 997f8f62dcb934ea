"""The port's stream path as a whole, on the CPU.

- Streamed (overlap-save blocks) labels equal whole-stream labels within the
  port, as tests/test_streaming.py holds for the JAX package.
- The port's ``classify_stream_blocked`` against the JAX one on a short
  demo-style signal through the deployed int8 artifact (the JAX side runs
  its Pallas v7 kernels in interpret mode).
- The demo itself and the CLI, at full width, with ``device=cpu``.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch import cli
from modulationdetectioncnn_torch.config import AmcConfig, RML_CLASSES, StreamConfig
from modulationdetectioncnn_torch.dsp import framer as tfr
from modulationdetectioncnn_torch.dsp import pipeline as tpipe
from modulationdetectioncnn_torch.ops import infer as tinfer
from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, QuantizedModel, load_int8
from modulationdetectioncnn_tpu.config import StreamConfig as JStreamConfig
from modulationdetectioncnn_tpu.dsp import framer as jfr
from modulationdetectioncnn_tpu.dsp import pipeline as jpipe
from modulationdetectioncnn_tpu.ops import infer as jinfer


def _wideband(t_len: int, seed: int = 3) -> np.ndarray:
    r = np.random.default_rng(seed)
    n = np.arange(t_len)
    x = (np.exp(2j * np.pi * 0.13 * n) + 0.5 * np.exp(2j * np.pi * 0.31 * n + 0.7j)
         + 0.3 * (r.standard_normal(t_len) + 1j * r.standard_normal(t_len)))
    return x.astype(np.complex64)


@pytest.fixture(scope="module")
def artifact_predict():
    return tinfer.make_int8_predict(load_int8(device="cpu"))


@pytest.mark.parametrize("hop", [128, 32])
def test_streamed_equals_batch_labels(artifact_predict, hop):
    sc = StreamConfig(num_subbands=8, taps_per_branch=8, frame_hop=hop,
                      block_len=8 * 128 * 2)
    t_len = sc.block_len * 3 + sc.block_len // 2  # ragged tail
    x = tfr.to_planes(_wideband(t_len))
    batch = tpipe.classify_stream(x, artifact_predict, sc).numpy()
    streamed = tpipe.classify_stream_blocked(x, artifact_predict, sc).numpy()
    assert streamed.shape == batch.shape == (8, tpipe.total_frames(sc, t_len))
    np.testing.assert_array_equal(streamed, batch)


@pytest.mark.parametrize("kw", [{}, {"frame_hop": 32}, {"frame_hop": 64, "taps_per_branch": 4}])
def test_plan_matches_jax(kw):
    sc, jsc = StreamConfig(**kw), JStreamConfig(**kw)
    plan, jplan = tpipe.plan_frontend(sc), jpipe.plan_frontend(jsc)
    for f in ("m", "frame_len", "hop", "halo_in", "n_hist_sub", "n_lead_frames"):
        assert getattr(plan, f) == getattr(jplan, f), f
    for t_len in (0, 100, 5000, 131072):
        assert tpipe.total_frames(sc, t_len) == jpipe.total_frames(jsc, t_len)
    assert tpipe.check_block_alignment(sc, sc.block_len) == \
        jpipe.check_block_alignment(jsc, jsc.block_len)


def test_blocked_stream_matches_jax_on_demo_style_signal(artifact_predict):
    """Demo-style signal (the demo's generator, block_len cut to 8192 so the
    JAX side's interpret-mode kernels stay quick), deployed int8 model. The
    occupied subbands must agree exactly; overall >= 99 %: the remaining
    differences are near-ties in the CFO spectrum's argmax on noise-only
    frames, where the two libraries' matmuls round differently."""
    cfg = dataclasses.replace(AmcConfig(device="cpu"),
                              stream=StreamConfig(block_len=8192))
    wide, occupied = tpipe.make_demo_signal(cfg)
    sc = cfg.stream
    got = tpipe.classify_stream_blocked(tfr.to_planes(wide), artifact_predict, sc).numpy()
    qm = jinfer_qm()
    jpredict = jinfer.make_int8_predict(qm, "v7", interpret=True)
    want = np.asarray(jpipe.classify_stream_blocked(
        jfr.to_planes(wide), jpredict, JStreamConfig(block_len=8192)))
    assert got.shape == want.shape == (16, 16)
    occ = sorted(occupied)
    np.testing.assert_array_equal(got[occ], want[occ])
    assert (got == want).mean() >= 0.99
    for k, mod in occupied.items():
        assert RML_CLASSES[np.bincount(got[k]).argmax()] == mod


def jinfer_qm():
    """The committed artifact as the JAX package's QuantizedModel."""
    from modulationdetectioncnn_tpu.train.quant import QuantizedModel as JQM

    return JQM.from_tree(QuantizedModel.from_npz(DEFAULT_ARTIFACT).tree())


def test_stream_demo_cli_on_cpu(capsys):
    """``python -m modulationdetectioncnn_torch stream device=cpu``: the full
    demo (16 subbands x 64 frames) labels subbands 1/5/11 BPSK/QPSK/GFSK."""
    assert cli.main(["stream", "device=cpu"]) == 0
    out = capsys.readouterr().out
    rows = {int(ln.split()[0].rstrip("*")): ln.split()[-1].strip("()")
            for ln in out.splitlines() if ln.startswith("  ") and "*" in ln}
    assert rows == {1: "BPSK", 5: "QPSK", 11: "GFSK"}
    assert "classified 1024 frames (131072 wideband samples)" in out


def test_cli_rejects_bad_input():
    with pytest.raises(SystemExit, match="unknown command"):
        cli.main(["frobnicate"])          # a command neither package has
    with pytest.raises(SystemExit, match="bad override"):
        cli.main(["stream", "stream.nosuchfield=3"])
    assert cli.main(["--help"]) == 0


def test_make_predictor_missing_artifact_raises(tmp_path):
    cfg = AmcConfig(device="cpu")
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, int8_artifact=str(tmp_path / "missing.npz")))
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        tpipe._make_predictor(cfg)


@pytest.mark.parametrize("kernel", ["v9", "v10"])
def test_stream_eval_int8_kernel_selects_the_classifier(kernel, monkeypatch):
    """``stream eval.int8_kernel=v10`` (or v9) parses and runs that
    classifier: the demo's labels equal the default v7 path's."""
    from modulationdetectioncnn_torch.config import apply_overrides

    cfg = AmcConfig(device="cpu")
    picked = apply_overrides(cfg, [f"eval.int8_kernel={kernel}"])
    assert picked == dataclasses.replace(
        cfg, eval=dataclasses.replace(cfg.eval, int8_kernel=kernel))
    want = tpipe.run_stream_demo(cfg)
    seen = []
    real = tinfer.make_int8_predict

    def spy(qw, version="v7"):
        seen.append(version)
        return real(qw, version)

    monkeypatch.setattr(tinfer, "make_int8_predict", spy)
    np.testing.assert_array_equal(tpipe.run_stream_demo(picked), want)
    assert cli.main(["stream", "device=cpu", f"eval.int8_kernel={kernel}"]) == 0
    assert seen == [kernel, kernel]


# --------------------------------------- resampler and timing correction

from modulationdetectioncnn_torch.config import apply_overrides  # noqa: E402
from modulationdetectioncnn_tpu.config import AmcConfig as JAmcConfig  # noqa: E402
from modulationdetectioncnn_tpu.config import apply_overrides as japply  # noqa: E402


@pytest.mark.parametrize("kw", [
    {"resample_up": 1, "resample_down": 2},
    {"resample_up": 2, "resample_down": 3, "frame_hop": 64},
    {"resample_up": 3, "resample_down": 2, "fir_taps": 65, "num_subbands": 8},
    {"resample_up": 2, "resample_down": 1, "taps_per_branch": 4},
])
def test_plan_with_resampling_matches_jax(kw):
    sc, jsc = StreamConfig(**kw), JStreamConfig(**kw)
    plan, jplan = tpipe.plan_frontend(sc), jpipe.plan_frontend(jsc)
    for f in ("m", "up", "down", "frame_len", "hop", "halo_in", "trim_res",
              "n_hist_sub", "n_lead_frames"):
        assert getattr(plan, f) == getattr(jplan, f), f
    assert plan.trim_res >= 0 and (plan.halo_in * plan.up) % plan.down == 0
    for t_len in (0, 100, 5000, 131072):
        assert tpipe.batch_subband_len(sc, t_len) == jpipe.batch_subband_len(jsc, t_len)
        assert tpipe.total_frames(sc, t_len) == jpipe.total_frames(jsc, t_len)
    np.testing.assert_array_equal(tpipe.design_resampler(sc), jpipe.design_resampler(jsc))
    for block in (sc.block_len, 3 * (1 << 14), 1000, 12288):
        try:
            want = jpipe.check_block_alignment(jsc, block)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                tpipe.check_block_alignment(sc, block)
        else:
            assert tpipe.check_block_alignment(sc, block) == want


def test_misaligned_resampled_block_raises():
    sc = StreamConfig(resample_up=1, resample_down=3, block_len=1 << 15)
    with pytest.raises(ValueError, match="resample_down"):
        tpipe.classify_stream_blocked(torch.zeros((2, 1 << 16)), lambda x: x, sc)


@pytest.mark.parametrize("up,down", [(1, 2), (2, 3)])
def test_streamed_equals_batch_with_resampling(artifact_predict, up, down):
    """tests/test_streaming.py's resampling case through the port: the
    blocked path with the composed halo equals the batch path exactly."""
    sc = StreamConfig(num_subbands=4, taps_per_branch=8, resample_up=up,
                      resample_down=down, fir_taps=33, block_len=4 * 128 * 2 * 3)
    t_len = sc.block_len * 3
    x = tfr.to_planes(_wideband(t_len, seed=7))
    batch = tpipe.classify_stream(x, artifact_predict, sc).numpy()
    streamed = tpipe.classify_stream_blocked(x, artifact_predict, sc).numpy()
    f = tpipe.total_frames(sc, t_len)
    assert f > 4 and streamed.shape == (4, f)
    np.testing.assert_array_equal(streamed, batch[:, :f])


def test_streamed_equals_batch_with_timing_normalization(artifact_predict):
    """tests/test_streaming.py's timing case through the port."""
    sc = StreamConfig(num_subbands=8, taps_per_branch=8, block_len=8 * 128 * 2,
                      normalize_timing=True)
    t_len = sc.block_len * 2 + sc.block_len // 2
    x = tfr.to_planes(_wideband(t_len, seed=11))
    batch = tpipe.classify_stream(x, artifact_predict, sc).numpy()
    streamed = tpipe.classify_stream_blocked(x, artifact_predict, sc).numpy()
    assert streamed.shape == batch.shape == (8, tpipe.total_frames(sc, t_len))
    np.testing.assert_array_equal(streamed, batch)


def test_resampled_frames_match_jax_and_golden_chain():
    """tests/test_streaming.py's golden chain (resample -> PFB -> frame ->
    power normalize, complex float64) against the port's subband_frames,
    at its 2e-3; and the JAX package's frames at 1e-4."""
    from modulationdetectioncnn_tpu.golden import dsp as gold

    kw = dict(num_subbands=4, taps_per_branch=8, resample_up=1, resample_down=2,
              normalize_cfo=False, normalize_timing=False)
    sc, jsc = StreamConfig(**kw), JStreamConfig(**kw)
    xc = _wideband(4 * 128 * 8 * 2, seed=9)
    h = gold.design_prototype(4, 8)
    xr = gold.fir_resample(xc, tpipe.design_resampler(sc), 1, 2)
    xr = xr[:len(xr) - len(xr) % 4]
    sub = gold.pfb_channelize(xr, h, 4)
    want = np.stack([np.stack([gold.power_normalize(sub[i * 128:(i + 1) * 128, k])
                               for i in range(len(sub) // 128)]) for k in range(4)])
    got = tpipe.subband_frames(tfr.to_planes(xc), h, sc).numpy()
    assert got.shape == want.shape[:2] + (2, 128)
    np.testing.assert_allclose(got[..., 0, :], want.real, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got[..., 1, :], want.imag, rtol=2e-3, atol=2e-3)
    want_jax = np.asarray(jpipe.subband_frames(jfr.to_planes(xc), h, jsc))
    np.testing.assert_allclose(got, want_jax, rtol=1e-4, atol=1e-4)


def test_blocked_stream_with_timing_matches_jax(artifact_predict):
    """The demo-style signal with timing correction on, deployed int8 model
    (the JAX side's v7 Pallas kernels and timing kernel in interpret mode):
    occupied subbands exact, >= 99 % overall."""
    cfg = apply_overrides(AmcConfig(device="cpu"),
                          ["stream.block_len=8192", "stream.normalize_timing=true"])
    wide, occupied = tpipe.make_demo_signal(cfg)
    got = tpipe.classify_stream_blocked(tfr.to_planes(wide), artifact_predict,
                                        cfg.stream).numpy()
    jpredict = jinfer.make_int8_predict(jinfer_qm(), "v7", interpret=True)
    want = np.asarray(jpipe.classify_stream_blocked(
        jfr.to_planes(wide), jpredict,
        JStreamConfig(block_len=8192, normalize_timing=True)))
    assert got.shape == want.shape == (16, 16)
    occ = sorted(occupied)
    np.testing.assert_array_equal(got[occ], want[occ])
    assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("override", [
    "stream.normalize_timing=false", "stream.normalize_timing=true",
    "stream.resample_up=2", "stream.resample_down=3", "stream.fir_taps=65",
    "stream.timing_phases=16", "stream.sps=4"])
def test_stream_overrides_parse_as_in_jax(override):
    """The JAX package's StreamConfig fields are overrides of the port too,
    with the same defaults and the same parsed values."""
    got = apply_overrides(AmcConfig(), [override]).stream
    want = japply(JAmcConfig(), [override]).stream
    for f in ("resample_up", "resample_down", "fir_taps", "normalize_timing",
              "timing_phases", "sps"):
        assert getattr(got, f) == getattr(want, f), f
        assert getattr(StreamConfig(), f) == getattr(JStreamConfig(), f), f


@pytest.mark.parametrize("extra,frames", [
    (["stream.normalize_timing=true"], 1024),
    (["stream.resample_up=1", "stream.resample_down=2"], 512),
    (["stream.resample_up=1", "stream.resample_down=2", "stream.normalize_timing=true"], 512)])
def test_stream_demo_cli_with_timing_and_resampling_on_cpu(capsys, extra, frames):
    """``stream device=cpu`` with timing correction and/or the resampler at
    the default 16 subbands: the demo runs and classifies every frame;
    streamed == batch (the command's own path against classify_stream)."""
    assert cli.main(["stream", "device=cpu", *extra]) == 0
    assert f"classified {frames} frames (131072 wideband samples)" in capsys.readouterr().out
    cfg = apply_overrides(AmcConfig(device="cpu"), extra)
    wide, _ = tpipe.make_demo_signal(cfg)
    predict = tinfer.make_int8_predict(load_int8(device="cpu"))
    x = tfr.to_planes(wide)
    streamed = tpipe.classify_stream_blocked(x, predict, cfg.stream).numpy()
    batch = tpipe.classify_stream(x, predict, cfg.stream).numpy()
    assert streamed.shape == (16, frames // 16)
    np.testing.assert_array_equal(streamed, batch[:, :streamed.shape[1]])


def test_stream_eval_int8_kernel_v3_and_v2_select_the_classifier():
    """``stream eval.int8_kernel=v3`` (or v2) runs that classifier: the
    demo's labels equal the default v7 path's."""
    want = tpipe.run_stream_demo(AmcConfig(device="cpu"))
    for v in ("v3", "v2"):
        got = tpipe.run_stream_demo(apply_overrides(AmcConfig(device="cpu"),
                                                    [f"eval.int8_kernel={v}"]))
        np.testing.assert_array_equal(got, want)
