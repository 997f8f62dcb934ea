"""``scripts/bench_stream_variants.py`` of the port on the CPU (``device=cpu``,
a tiny bench): the JAX script's six variants with their overrides in its
order, its keys and ``pct_of_cnn_only``'s formula, a failing variant
recorded while the others still run, and the file where ``out`` says."""
import ast
import json
import os

import pytest

from modulationdetectioncnn_torch import bench
from modulationdetectioncnn_torch.scripts import bench_stream_variants as bsv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["device=cpu", "bench.batch_size=16", "bench.warmup_iters=1", "bench.timed_iters=1",
        "stream.num_subbands=4", "stream.taps_per_branch=4", "model.conv1_filters=32",
        "model.conv2_filters=16", "model.dense_units=32"]
VARIANT_KEYS = {"samples_per_sec", "vs_baseline", "pct_of_cnn_only"}


def _jax_variants():
    """The ``variants`` dict literal of the JAX script, read from its source."""
    with open(os.path.join(REPO, "scripts", "bench_stream_variants.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "variants" for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError("no variants dict in the JAX script")


def test_variants_are_the_jax_scripts_in_its_order():
    want = _jax_variants()
    assert [name for name, _ in bsv.VARIANTS] == list(want)
    assert {name: list(ov) for name, ov in bsv.VARIANTS} == want


def test_main_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "sub" / "variants.json"
    res = bsv.main([*TINY, f"out={out}"])
    with open(out) as f:
        assert json.load(f) == res
    assert set(res) == {"backend", "cnn_only_samples_per_sec", "variants"}
    assert res["backend"] == "pallas_int8_v7" and res["cnn_only_samples_per_sec"] > 0
    assert list(res["variants"]) == [name for name, _ in bsv.VARIANTS]
    cnn = res["cnn_only_samples_per_sec"]
    for name, v in res["variants"].items():
        assert set(v) == VARIANT_KEYS, (name, v)
        assert v["samples_per_sec"] > 0
        assert v["pct_of_cnn_only"] == round(100 * v["samples_per_sec"] / cnn, 1)
        assert v["vs_baseline"] == round(v["samples_per_sec"] / 1e9, 4)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cnn-only: ")
    assert [ln.split()[0] for ln in lines[1:7]] == list(res["variants"])
    assert lines[-1] == f"wrote {out}"


def test_a_failing_variant_is_recorded_and_the_rest_run(tmp_path, monkeypatch):
    """``run_stream_bench`` raising for ``resample_2_3``: that variant
    records the error, every other one its rate; the CNN-only rate comes
    from ``bench.run`` with the backend named and stream_extra off."""
    seen, runs = [], []

    def fake_run(cfg, quiet=False, backend=None):
        runs.append((cfg.bench.stream_extra, quiet, backend))
        return {"value": 1000, "vs_baseline": 1e-6}

    def fake_stream(cfg, quiet=False, backend=None):
        sc = cfg.stream
        seen.append((sc.normalize_timing, sc.resample_up, sc.resample_down, sc.block_len,
                     sc.normalize_cfo, sc.cfo_pad_factor, backend))
        if sc.resample_up == 2:
            raise ValueError("resampler refused" + "x" * 300)
        return {"value": 400, "vs_baseline": 4e-7}

    monkeypatch.setattr(bench, "run", fake_run)
    monkeypatch.setattr(bench, "run_stream_bench", fake_stream)
    res = bsv.main(["device=cpu", "pallas_int8_v10", f"out={tmp_path / 'v.json'}"])
    assert runs == [(False, True, "pallas_int8_v10")]
    block = 1 << 15
    assert seen == [(False, 1, 1, block, True, 4, "pallas_int8_v10"),
                    (True, 1, 1, block, True, 4, "pallas_int8_v10"),
                    (False, 2, 3, 49152, True, 4, "pallas_int8_v10"),
                    (False, 1, 1, block, False, 4, "pallas_int8_v10"),
                    (False, 1, 1, block, True, 2, "pallas_int8_v10"),
                    (False, 1, 1, block, True, 4, "pallas_int8_v10")]
    err = res["variants"]["resample_2_3"]
    assert set(err) == {"error"} and err["error"].startswith("ValueError('resampler refused")
    assert len(err["error"]) == 200
    for name, v in res["variants"].items():
        if name != "resample_2_3":
            assert v == {"samples_per_sec": 400, "vs_baseline": 4e-7, "pct_of_cnn_only": 40.0}


def test_refuses_artifacts():
    with pytest.raises(SystemExit, match="artifacts"):
        bsv.main(["device=cpu", f"out={os.path.join(REPO, 'artifacts', 'v.json')}"])
