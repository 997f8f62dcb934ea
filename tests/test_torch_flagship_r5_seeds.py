"""The port's r5 flagship at other train seeds, and in true float32.

The committed record at train seed 42 (``assets/flagship_r5_h100/``) missed
the JAX r5 float headline at 0 dB by 1.546 points. The same command was run
on an H100 at train seeds 43 to 46 in bf16, and at seed 42 in float32 with
TF32 off for cuDNN and cuBLAS (``scripts/r5_gap.py full tf32=off``); each
run's files are in ``assets/flagship_r5_h100_seeds/<run>/``, and
``spread.json`` there holds the seeds' spread and the verdict of the rule
stated before the runs: the miss closes as seed spread only if the JAX
value lies within the five seeds' 0 dB range and their mean lies within
1.5 points of it. Here, from the committed JSON alone:

- each run covers the r5 length and its sweeps the held-out split, with
  int8 within 0.01 of float and agreement 1.0;
- each run's command is the seed-42 record's plus its seed, or its dtype
  and TF32 setting;
- ``spread.json`` says what the records give under the rule;
- ``r5_gap full`` sets the two TF32 flags for the run and restores them.
"""
import json
import os
import shlex

import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch.scripts import r5_gap
from modulationdetectioncnn_torch.scripts import train_eval_full as tef

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "modulationdetectioncnn_torch", "assets")
RECORD_42 = os.path.join(ASSETS, "flagship_r5_h100")
SEEDS_DIR = os.path.join(ASSETS, "flagship_r5_h100_seeds")
JAX_SUMMARY = os.path.join(REPO, "artifacts", "summary_rml11.json")
# The closing rule, as PERF.md stated it before the runs.
SEEDS = (42, 43, 44, 45, 46)
BAND = 0.015
RUNS = {"seed43": 43, "seed44": 44, "seed45": 45, "seed46": 46, "f32_seed42": 42}
HEADLINES = ("acc_at_0dB", "acc_at_10dB", "acc_at_18dB")
INT8_MINUS_FLOAT = 0.01
TINY = ["device=cpu", "data.classes=BPSK,QPSK", "model.num_classes=2",
        "model.conv1_filters=32", "model.conv2_filters=16", "model.dense_units=32",
        "model.dtype=float32", "quant.calib_frames=66", "eval.batch_size=48",
        "data.frames_per_class_per_snr=10", "data.snr_db_min=0", "data.snr_db_max=18",
        "data.snr_db_step=18", "train.batch_size=16", "train.warmup_steps=2",
        "train.num_steps=20", "train.eval_every=5", "train.checkpoint_every=5"]


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run_dir(seed):
    return RECORD_42 if seed == 42 else os.path.join(SEEDS_DIR, f"seed{seed}")


@pytest.mark.parametrize("run", list(RUNS))
def test_seed_run_covers_r5_length(run):
    path = os.path.join(SEEDS_DIR, run)
    jax_summary = _load_json(JAX_SUMMARY)
    summary = _load_json(os.path.join(path, "summary_rml11.json"))
    assert list(summary) == list(jax_summary)
    assert summary["int8_on_chip"] is True and summary["int8_kernel"] == "v7"
    assert summary["generator_version"] == jax_summary["generator_version"]
    assert summary["pallas_v7_vs_golden_int8_agreement"] == 1.0
    records = _records(os.path.join(path, "train_rml11.jsonl"))
    assert [r["step"] for r in records] == list(range(1000, 96001, 1000))
    assert summary["train_history_tail"] == records[-3:]
    for k in HEADLINES:
        assert abs(summary["int8_headline"][k] - summary["float_headline"][k]) \
            <= INT8_MINUS_FLOAT, k


@pytest.mark.parametrize("name,key", [("results.json", "float_headline"),
                                      ("results_int8.json", "int8_headline")])
@pytest.mark.parametrize("run", list(RUNS))
def test_seed_run_sweeps_cover_held_out_split(run, name, key):
    path = os.path.join(SEEDS_DIR, run)
    result = _load_json(os.path.join(path, name))
    assert result["headline"] == _load_json(os.path.join(path, "summary_rml11.json"))[key]
    assert sorted(map(int, result["snr_accuracy"])) == list(range(-20, 19, 2))
    assert sum(int(np.sum(c)) for c in result["confusion"].values()) == 176_000
    assert set(result) == set(_load_json(os.path.join(REPO, "artifacts", name)))


@pytest.mark.parametrize("run", list(RUNS))
def test_seed_run_command_is_the_record_s_plus_its_change(run):
    """bf16: the seed-42 record's command with ``train.seed=s`` before its
    own ``out=``; float32: ``r5_gap full tf32=off`` with the same overrides
    and ``model.dtype=float32``, TF32 off for both libraries as the run
    itself recorded it."""
    base = shlex.split(_load_json(os.path.join(RECORD_42, "source.json"))["command"])
    assert base[-1] == "out=_checkout/r5"
    source = _load_json(os.path.join(SEEDS_DIR, run, "source.json"))
    assert set(source) >= set(_load_json(os.path.join(RECORD_42, "source.json")))
    assert "H100" in source["device"] and source["power_limit_w"] > 0
    assert source["nvidia_smi"].startswith(source["device"])
    got = shlex.split(source["command"])
    seed = RUNS[run]
    if run.startswith("seed"):
        assert got == [*base[:-1], f"train.seed={seed}", f"out=_checkout/r5_{seed}"]
        return
    head = ["python", "-m", "modulationdetectioncnn_torch.scripts.r5_gap", "full", "tf32=off"]
    assert got == [*head, *base[3:-1], "model.dtype=float32", "out=_checkout/r5_f32"]
    assert base[3:-1] == list(r5_gap.R5)
    off = {"cudnn.allow_tf32": False, "cuda.matmul.allow_tf32": False}
    assert source["tf32"] == off
    full = _load_json(os.path.join(SEEDS_DIR, run, "full.json"))
    assert full["tf32"] == off and full["dtype"] == "float32" and full["seed"] == 42
    assert full["summary"] == _load_json(os.path.join(SEEDS_DIR, run, "summary_rml11.json"))
    # TF32 rounds the inputs to 10 bits of mantissa (~1e-4 relative).
    for op, err in full["float32_rel_error_vs_float64"].items():
        assert err < 1e-5, (op, err)


def test_spread_json_is_the_rule_applied_to_the_records():
    ref = _load_json(JAX_SUMMARY)["float_headline"]["acc_at_0dB"]
    assert round(ref, 5) == 0.72257
    a = {s: _load_json(os.path.join(_run_dir(s), "summary_rml11.json"))
         ["float_headline"]["acc_at_0dB"] for s in SEEDS}
    assert a[42] == 0.7071063104036385
    got = _load_json(os.path.join(SEEDS_DIR, "spread.json"))
    assert got["seeds"] == list(SEEDS)
    stats = got["stats"]["float_acc_at_0dB"]
    assert stats["reference"] == ref
    assert stats["min"] == min(a.values()) and stats["max"] == max(a.values())
    assert stats["mean"] == pytest.approx(np.mean(list(a.values())), abs=1e-12)
    in_range = min(a.values()) <= ref <= max(a.values())
    in_band = bool(abs(np.mean(list(a.values())) - ref) <= BAND)
    assert got["rule"]["a_min_le_reference_le_max"] is in_range
    assert got["rule"]["b_abs_mean_minus_reference_le_band"] is in_band
    assert got["rule"]["band"] == BAND
    assert got["verdict"] == ("closed: seed spread, not a fault" if in_range and in_band
                              else "open")
    for s in SEEDS:
        run = got["runs"][str(s)]
        assert run["float_acc_at_0dB"] == a[s]
        records = _records(os.path.join(_run_dir(s), "train_rml11.jsonl"))
        assert run["last_step"] == 96000 and run["eval_acc"] == records[-1]["eval_acc"]
    for k in ("acc_at_10dB", "acc_at_18dB"):
        values = [got["runs"][str(s)][f"float_{k}"] for s in SEEDS]
        assert got["stats"][f"float_{k}"]["min"] == min(values)
        assert got["stats"][f"float_{k}"]["max"] == max(values)
    f32 = _load_json(os.path.join(SEEDS_DIR, "f32_seed42", "summary_rml11.json"))
    assert got["float32_tf32_off_seed42"]["float_acc_at_0dB"] == \
        f32["float_headline"]["acc_at_0dB"]


def test_spread_mode_writes_the_committed_spread(tmp_path):
    out = tmp_path / "spread.json"
    got = r5_gap.main(["spread", f"out={out}"])
    assert _load_json(out) == got == _load_json(os.path.join(SEEDS_DIR, "spread.json"))


@pytest.mark.parametrize("tf32", [["tf32=off"], []])
def test_r5_gap_full_sets_and_restores_tf32(tf32, tmp_path, monkeypatch):
    """``r5_gap full`` runs ``train_eval_full.main`` on the r5 overrides,
    the given keys and ``out=``; with ``tf32=off`` both flags are off for
    the run and restored after, without it they stay as they are."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    main = tef.main

    def spy(argv):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                     list(argv)))
        return main(argv)

    monkeypatch.setattr(tef, "main", spy)
    out = tmp_path / "full"
    got = r5_gap.main(["full", *tf32, *TINY, f"out={out}"])
    want = not tf32
    assert seen == [(want, want, [*r5_gap.R5, *TINY, f"out={out}"])]
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert got["tf32"] == {"cudnn.allow_tf32": want, "cuda.matmul.allow_tf32": want}
    assert got["summary"] == _load_json(out / "summary_rml11.json")
    assert _load_json(out / "full.json") == json.loads(json.dumps(got))
    assert got["float32_rel_error_vs_float64"]["conv2"] < 1e-5
