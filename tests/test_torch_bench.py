"""The port's bench contract on the CPU (``device=cpu``, tiny batches),
mirroring tests/test_bench_contract.py: the one stdout JSON line and its
fields, per-session calibration, stream mode, an explicit backend honoured,
and no fallback."""
import json

import pytest
import torch

from modulationdetectioncnn_torch import bench
from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides

TINY = ["device=cpu", "bench.batch_size=32", "bench.warmup_iters=1",
        "bench.timed_iters=2"]
KEYS = {"metric", "value", "unit", "vs_baseline", "backend", "fallback"}


def _cfg(*extra):
    return apply_overrides(AmcConfig(), TINY + list(extra))


def _fake_measure(rates, measured):
    def fake(fwd, args, bc, frame_len):
        measured.append(fwd)
        fps = rates[fwd]
        return fps, fps * frame_len, {
            "samples_per_sec_min": round(fps * frame_len),
            "timing_samples_us": [round(1e6 * bc.batch_size / fps, 1)] * 5}
    return fake


@pytest.mark.parametrize("backend", ["pallas_int8_v10", "pallas_int8_v9",
                                     "xla_bf16", "pallas_int8_v6", "pallas_int8_v4",
                                     "pallas_int8_v5", "xla_int8", "pallas_int8_v3",
                                     "pallas_int8"])
def test_bench_run_contract_fields(capsys, backend):
    res = bench.run(_cfg("bench.stream_extra=false"), backend=backend)
    assert set(res) == KEYS
    assert res["metric"] == "classified_iq_samples_per_sec_per_chip"
    assert res["unit"] == "samples/s" and res["value"] > 0
    assert res["backend"] == backend and res["fallback"] is False
    assert abs(res["vs_baseline"] - res["value"] / 1e9) < 5e-5
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == res
    extra = json.loads(out.err.strip().splitlines()[-1])
    assert extra["device"] == "cpu" and extra["batch"] == 32
    assert "pct_of_int8_peak" not in extra      # no device roofline on the CPU
    assert len(extra["timing_samples_us"]) == 5


def test_bench_calibration_headlines_the_fastest_kernel(monkeypatch, capsys):
    """Every candidate gets the full median measurement, the fastest becomes
    the headline, and its own measurement is reused."""
    cands = AmcConfig().bench.calibration_candidates
    assert cands == ("pallas_int8_v7", "pallas_int8_v10")
    rates = {"pallas_int8_v7": 2.0e6, "pallas_int8_v10": 3.0e6}
    measured = []
    monkeypatch.setattr(bench, "make_classifier", lambda cfg, b, n: (b, (None,)))
    monkeypatch.setattr(bench, "_measure", _fake_measure(rates, measured))
    res = bench.run(_cfg("bench.stream_extra=false"))
    assert res["backend"] == "pallas_int8_v10" and res["fallback"] is False
    assert sorted(measured) == sorted(rates)
    cal = json.loads(capsys.readouterr().err.strip().splitlines()[0])
    assert cal["winner"] == "pallas_int8_v10"
    assert set(cal["kernel_calibration"]) == set(rates)


@pytest.mark.parametrize("argv", [["pallas_int8_v7"],
                                  ["bench.backend=pallas_int8_v7"]])
def test_explicit_backend_is_honoured(monkeypatch, argv):
    """Naming a backend turns calibration off: only it is measured, even
    when a faster candidate exists."""
    rates = {"pallas_int8_v7": 2.0e6, "pallas_int8_v10": 3.0e6}
    measured = []
    monkeypatch.setattr(bench, "make_classifier", lambda cfg, b, n: (b, (None,)))
    monkeypatch.setattr(bench, "_measure", _fake_measure(rates, measured))
    cfg = bench.parse_args(TINY + argv + ["bench.stream_extra=false"])
    assert cfg.bench.calibrate is False
    assert bench.run(cfg, quiet=True)["backend"] == "pallas_int8_v7"
    assert measured == ["pallas_int8_v7"]
    measured.clear()
    assert bench.run(_cfg(), quiet=True, backend="pallas_int8_v7")["backend"] \
        == "pallas_int8_v7"
    assert measured == ["pallas_int8_v7"]


def test_stream_bench_contract_fields(capsys):
    cfg = _cfg("bench.mode=stream", "stream.num_subbands=4",
               "stream.taps_per_branch=4", "bench.backend=pallas_int8_v10")
    res = bench.run(cfg)
    assert set(res) == KEYS
    assert res["metric"] == "streamed_iq_samples_per_sec_per_chip"
    assert res["value"] > 0 and res["fallback"] is False
    assert res["backend"] == "pallas_int8_v10"
    err = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert err["mode"] == "stream" and err["frames_per_iter"] == 32


def test_cli_bench_prints_contract_and_stream_extra(capsys):
    from modulationdetectioncnn_torch import cli

    assert cli.main(["bench", *TINY, "bench.calibration_candidates=pallas_int8_v7,pallas_int8_v9",
                     "stream.num_subbands=4"]) == 0
    out = capsys.readouterr()
    res = json.loads(out.out.strip().splitlines()[-1])
    assert set(res) == KEYS and res["fallback"] is False
    err = [json.loads(ln) for ln in out.err.strip().splitlines() if ln.startswith("{")]
    assert set(err[0]["kernel_calibration"]) == {"pallas_int8_v7", "pallas_int8_v9"}
    assert res["backend"] == err[0]["winner"]
    extra = err[-1]
    assert extra["mode"] == "stream_extra" and extra["value"] > 0
    assert not any("stream_extra_error" in e for e in err)


@pytest.mark.parametrize("backend", ["pallas_bf16_v4", "pallas_bf16", "frobnicate"])
def test_unported_backend_raises(backend, capsys):
    """No JAX backend is left unported: ``pallas_bf16_v4`` and
    ``pallas_bf16`` print a contract line naming them, with no fallback;
    a name the JAX bench does not know raises ValueError, as it does
    there."""
    cfg = _cfg("bench.stream_extra=false")
    if backend.startswith("pallas_bf16"):
        res = bench.run(cfg, backend=backend)
        assert set(res) == KEYS and res["backend"] == backend and res["fallback"] is False
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
        return
    with pytest.raises(ValueError, match="unknown bench backend"):
        bench.run(cfg, backend=backend)


def test_failing_candidate_raises_and_nothing_falls_back(monkeypatch):
    """A calibration candidate that fails fails the bench: no skip, no retry,
    no xla_bf16 headline."""
    made = []

    def make(cfg, backend, batch):
        made.append(backend)
        if backend == "pallas_int8_v10":
            raise RuntimeError("kernel failed to launch")
        return backend, (None,)

    monkeypatch.setattr(bench, "make_classifier", make)
    monkeypatch.setattr(bench, "_measure", _fake_measure({"pallas_int8_v7": 1e6}, []))
    with pytest.raises(RuntimeError, match="failed to launch"):
        bench.main(TINY)
    assert "xla_bf16" not in made and made.count("pallas_int8_v10") == 1


def test_stream_extra_failure_is_reported(monkeypatch, capsys):
    def boom(cfg, quiet=False, backend=None):
        raise RuntimeError("stream chain failed")

    monkeypatch.setattr(bench, "run_stream_bench", boom)
    res = bench.run_with_stream_extra(_cfg("bench.backend=xla_bf16"))
    assert res["fallback"] is False
    err = capsys.readouterr().err.strip().splitlines()
    assert "stream chain failed" in json.loads(err[-1])["stream_extra_error"]


def test_bad_override_exits():
    with pytest.raises(SystemExit, match="bad override"):
        bench.main(["bench.nosuchfield=3"])


def test_backend_list_matches_jax():
    """The JAX bench's whole BACKENDS list, in its order; v5 is accepted by
    name but, as there, not listed."""
    import bench as jbench

    assert list(bench.BACKENDS) == list(jbench.BACKENDS)
    assert "pallas_int8_v5" not in bench.BACKENDS and "pallas_int8_v5" not in jbench.BACKENDS
    classify, (x,) = bench.make_classifier(_cfg(), "pallas_int8_v5", 8)
    assert classify(x).shape == (8,)


@pytest.mark.parametrize("backend,version", [("pallas_int8_v3", "v3"), ("pallas_int8", "v2")])
def test_v3_and_v2_backends_classify_as_the_plain_chain(backend, version):
    """``pallas_int8_v3`` is the v3 classifier and ``pallas_int8`` the
    argmax of the v2 logits, as in the JAX bench (bench.py:89-98): both
    give the bench's own int8 weights' plain-chain labels."""
    from modulationdetectioncnn_torch.ops import infer

    cfg = _cfg()
    classify, (x,) = bench.make_classifier(cfg, backend, 32)
    qw, x2 = bench.make_int8_weights(cfg, 32)
    assert torch.equal(x, x2)
    want = infer.dense_argmax_int8_plain(infer.conv_stage_int8_v7_plain(x, qw), qw)
    got = classify(x)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert bench.INT8_BACKENDS[backend] == version


@pytest.mark.parametrize("extra", [["stream.normalize_timing=true"],
                                   ["stream.resample_up=1", "stream.resample_down=2"],
                                   ["stream.resample_up=2", "stream.resample_down=3",
                                    "stream.normalize_timing=true"]])
def test_stream_bench_with_timing_and_resampling(capsys, extra):
    """Stream mode with the timing correction and/or the resampler on: the
    block is aligned to subbands * hop * resample_down, as in the JAX bench
    (bench.py:249), and the contract line is printed."""
    cfg = _cfg("bench.mode=stream", "stream.num_subbands=4",
               "stream.taps_per_branch=4", "bench.batch_size=48", *extra)
    res = bench.run(cfg)
    assert set(res) == KEYS and res["value"] > 0 and res["fallback"] is False
    err = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    sc = cfg.stream
    align = sc.num_subbands * sc.frame_hop * sc.resample_down
    assert err["block_samples"] == (48 * 128 // align) * align
    from modulationdetectioncnn_torch.dsp import pipeline

    assert err["frames_per_iter"] == pipeline.total_frames(sc, err["block_samples"]) * 4


def test_pallas_bf16_classifies_as_the_plain_v2_forward():
    """``pallas_bf16`` is the argmax of the bf16 v2 forward's logits (JAX
    bench.py:63-66, 100-102), on the seeded float model unquantized: on 8
    frames it gives the labels of the plain tap rows -> v2 conv stage ->
    dense logits chain."""
    from modulationdetectioncnn_torch.ops import infer_bf16 as ib

    cfg = _cfg()
    classify, (x,) = bench.make_classifier(cfg, "pallas_bf16", 8)
    x2, _, model = bench._frames_and_model(cfg, 8)
    assert torch.equal(x, x2)
    bw = ib.make_bf16_weights(model.state_dict(), "cpu")
    logits = ib.dense_logits_bf16_plain(
        ib.conv_stage_bf16_v2_plain(ib.expand_taps_bf16(x), bw), bw)
    got = classify(x)
    assert got.dtype == torch.int32 and got.shape == (8,)
    assert torch.equal(got, ib.argmax_lowest(logits[:, :bw.nc]))
