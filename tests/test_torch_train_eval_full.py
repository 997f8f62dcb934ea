"""``scripts/train_eval_full.py`` of the port on the CPU (``device=cpu``) at
a tiny size.

The JAX script writes into ``artifacts/`` and the repository's root, so it
cannot run in a test; its stages can. With float weights carried from a
JAX model, ``evaluate_and_quantize`` is held to them: the float sweep to
``harness.snr_sweep`` over ``loop.make_eval_step`` (labels equal but for
near-ties of the logits), the activation scales to ``calibrate_activations``
(1e-5 relative), the int8 artifact, given the JAX scales, to ``quantize``
bit for bit, and the int8 sweep on it to ``make_int8_predict(qm, "v7",
interpret=True)`` exactly. ``main`` on its own writes its files with the
keys of the JAX run's summary, caches the dataset under the JAX script's
name, and writes nothing into ``artifacts/`` or the root's ``results.json``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
from modulationdetectioncnn_torch.data import radioml
from modulationdetectioncnn_torch.data import synthetic
from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2 as TVTCNN2
from modulationdetectioncnn_torch.models.vtcnn2 import params_from_flax
from modulationdetectioncnn_torch.quant import QuantizedModel
from modulationdetectioncnn_torch.scripts import train_eval_full as tef
from modulationdetectioncnn_torch.train import loop as tloop
from modulationdetectioncnn_torch.train import quant as tquant
from modulationdetectioncnn_tpu.config import AmcConfig as JAmcConfig
from modulationdetectioncnn_tpu.config import apply_overrides as japply
from modulationdetectioncnn_tpu.data import synthetic as jsynthetic
from modulationdetectioncnn_tpu.eval import harness as jharness
from modulationdetectioncnn_tpu.models import VTCNN2
from modulationdetectioncnn_tpu.ops.infer import make_int8_predict as jmake_int8_predict
from modulationdetectioncnn_tpu.train import loop as jloop
from modulationdetectioncnn_tpu.train import quant as jquant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["data.classes=BPSK,QPSK", "model.num_classes=2", "model.conv1_filters=32",
        "model.conv2_filters=16", "model.dense_units=32", "model.dtype=float32",
        "model.dropout_rate=0.1", "quant.calib_frames=66", "eval.batch_size=48"]
HEADLINE_SNRS = [0, 10, 18]
NEAR_TIE = 1e-5


def _jax_summary_keys():
    """The keys of the JAX run's summary (its script's ``summary`` dict)."""
    with open(os.path.join(REPO, "artifacts", "summary_rml11.json")) as f:
        return list(json.load(f))


def _load_json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def carried():
    """The JAX VT-CNN2 at TINY widths (float32, ``jax.random.key(0)``), its
    weights carried into the port's model, and 48 held-out frames at the
    headline SNRs."""
    jcfg = japply(JAmcConfig(), TINY)
    cfg = apply_overrides(AmcConfig(), ["device=cpu", *TINY])
    jmodel = VTCNN2.from_config(jcfg.model)
    params = jax.tree.map(np.asarray,
                          jmodel.init(jax.random.key(0), jnp.zeros((1, 2, 128))))
    model = TVTCNN2.from_config(cfg.model, cfg.data.frame_len)
    model.load_state_dict(params_from_flax(params))
    x, y, s = synthetic.make_dataset(cfg.data, snrs=HEADLINE_SNRS, frames_per_class_per_snr=8)
    return cfg, jcfg, jmodel, params, model.eval(), (x, y, s)


@pytest.fixture(scope="module")
def stages(carried, tmp_path_factory):
    """``evaluate_and_quantize`` of the carried model, its calibration
    handed the JAX package's scales (its own recorded), beside the JAX
    stages on the same frames."""
    cfg, jcfg, jmodel, params, model, (x, y, s) = carried
    out = tmp_path_factory.mktemp("full")
    calib_j, _, _ = jsynthetic.make_dataset(
        jcfg.data, frames_per_class_per_snr=max(
            1, jcfg.quant.calib_frames // (len(jcfg.data.classes) * 3)),
        snrs=[0, 10, 18], seed=jcfg.data.seed + 99)
    pct = cfg.quant.act_percentile
    jax_scales = jquant.calibrate_activations(jmodel, params, calib_j, percentile=pct)
    seen = {}
    calibrate = tquant.calibrate_activations

    def with_jax_scales(m, calib_x, percentile):
        seen["calib_x"], seen["percentile"] = calib_x, percentile
        seen["scales"] = calibrate(m, calib_x, percentile)
        return dict(jax_scales)

    mp = pytest.MonkeyPatch()
    mp.setattr(tquant, "calibrate_activations", with_jax_scales)
    try:
        summary = tef.evaluate_and_quantize(model, (x, y, s), cfg.data.classes, cfg, str(out),
                                            history=[{"step": k} for k in range(5)])
    finally:
        mp.undo()
    jqm = jquant.quantize(jmodel, params, calib_j, percentile=pct)
    return {"out": out, "summary": summary, "seen": seen, "calib_j": calib_j,
            "jax_scales": jax_scales, "jqm": jqm}


def test_float_sweep_equals_jax_but_near_ties(carried, stages):
    cfg, _, jmodel, params, model, (x, y, s) = carried
    classes = cfg.data.classes
    bs = cfg.eval.batch_size
    jstep = jloop.make_eval_step(jmodel)
    want = jharness.snr_sweep(lambda xb: jstep(params, jnp.asarray(xb)), x, y, s, classes,
                              batch_size=bs)
    got = _load_json(stages["out"] / "results.json")
    assert got["headline"] == stages["summary"]["float_headline"]
    labels_t = tloop.make_eval_step(model)(x).numpy()
    labels_j = np.asarray(jstep(params, jnp.asarray(x)))
    assert len(np.unique(labels_j)) == 2, "the carried model labels one class only"
    logits = np.sort(np.asarray(jmodel.apply(params, jnp.asarray(x))), axis=-1)
    for snr in HEADLINE_SNRS:
        m = s == snr
        differ = np.flatnonzero(m & (labels_t != labels_j))
        assert len(differ) <= 1, (snr, differ)
        for i in differ:
            assert logits[i, -1] - logits[i, -2] <= NEAR_TIE, (snr, i, logits[i])
        if not len(differ):
            assert got["snr_accuracy"][str(snr)] == want["snr_accuracy"][str(snr)]
            assert got["confusion"][str(snr)] == want["confusion"][str(snr)]
        else:
            assert abs(got["snr_accuracy"][str(snr)] - want["snr_accuracy"][str(snr)]) \
                <= 1 / m.sum() + 1e-12


def test_calibration_set_and_scales_match_jax(stages):
    seen = stages["seen"]
    np.testing.assert_array_equal(seen["calib_x"], stages["calib_j"])
    assert seen["percentile"] == AmcConfig().quant.act_percentile
    want = stages["jax_scales"]
    assert set(seen["scales"]) == set(want) == {"s_x", "a1", "a2", "a3"}
    for k in want:
        np.testing.assert_allclose(seen["scales"][k], want[k], rtol=1e-5, err_msg=k)


def test_int8_artifact_equals_jax_given_its_scales(stages):
    got = QuantizedModel.from_npz(str(stages["out"] / "ckpt_rml11_int8" / "int8.npz")).tree()
    want = stages["jqm"].tree()
    assert set(got) == set(want) and len(got) == 13
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_int8_sweep_equals_jax_v7_interpret(carried, stages):
    cfg, _, _, _, _, (x, y, s) = carried
    classify = jmake_int8_predict(stages["jqm"], "v7", interpret=True)
    want = jharness.snr_sweep(lambda xb: np.asarray(classify(jnp.asarray(xb))), x, y, s,
                              cfg.data.classes, batch_size=cfg.eval.batch_size)
    got = _load_json(stages["out"] / "results_int8.json")
    per_label = np.sum([np.sum(c, axis=0) for c in got["confusion"].values()], axis=0)
    assert (per_label > 0).all(), f"the int8 chain labels one class only: {per_label}"
    for key in ("snr_accuracy", "confusion", "overall_accuracy", "headline"):
        assert got[key] == json.loads(json.dumps(want[key])), key
    summary = stages["summary"]
    assert summary["int8_headline"] == got["headline"]
    assert summary["pallas_v7_vs_golden_int8_agreement"] == 1.0
    assert summary["int8_on_chip"] is False and summary["int8_kernel"] == "v7"
    assert summary["int8_minus_float"] == {
        k: round(got["headline"][k] - summary["float_headline"][k], 5)
        for k in got["headline"]}
    assert summary["train_history_tail"] == [{"step": 2}, {"step": 3}, {"step": 4}]
    assert list(summary) == _jax_summary_keys()


def _repo_records():
    """What a run must not touch: the root's results.json and artifacts/."""
    root = os.path.join(REPO, "results.json")
    art = os.path.join(REPO, "artifacts")
    return (os.stat(root).st_mtime_ns if os.path.exists(root) else None,
            sorted((d, sorted(f)) for d, _, f in os.walk(art)),
            max((os.stat(os.path.join(d, n)).st_mtime_ns
                 for d, _, f in os.walk(art) for n in f), default=None))


def test_main_writes_its_files_and_caches_the_dataset(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    before = _repo_records()
    out = tmp_path / "run"
    data = ["data.frames_per_class_per_snr=10", "data.snr_db_min=0", "data.snr_db_max=18",
            "data.snr_db_step=18", "train.batch_size=16", "train.num_steps=12",
            "train.eval_every=4", "train.warmup_steps=2", "train.checkpoint_every=6"]
    summary = tef.main(["device=cpu", *TINY, *data, "ignored_word", f"out={out}"])
    assert _repo_records() == before
    assert sorted(os.listdir(tmp_path)) == ["run"]
    name = (f"dataset_v{jsynthetic.GENERATOR_VERSION}_2c_10f_seed0.npz")
    assert sorted(os.listdir(out)) == sorted([
        name, "ckpt_rml11", "ckpt_rml11_int8", "results.json", "results_int8.json",
        "summary_rml11.json", "train_rml11.jsonl"])
    assert sorted(os.listdir(out / "ckpt_rml11")) == ["12", "6"]
    assert os.listdir(out / "ckpt_rml11_int8") == ["int8.npz"]
    records = [json.loads(ln) for ln in open(out / "train_rml11.jsonl")]
    assert [r["step"] for r in records] == [4, 8, 12]
    assert summary == _load_json(out / "summary_rml11.json")
    assert list(summary) == _jax_summary_keys()
    assert summary["train_history_tail"] == records
    assert summary["generator_version"] == jsynthetic.GENERATOR_VERSION
    for f in ("results.json", "results_int8.json"):
        r = _load_json(out / f)
        assert sorted(r["snr_accuracy"]) == ["0", "18"]
        assert sum(map(np.sum, r["confusion"].values())) == 8      # 0.2 of 40 frames
    assert summary["float_headline"]["acc_at_10dB"] is None
    assert summary["int8_minus_float"]["acc_at_10dB"] is None

    # The cache is read back, to the arrays the generator gives.
    cfg = apply_overrides(AmcConfig(), ["device=cpu", *TINY, *data])
    assert tef.dataset_cache(cfg, str(out)) == str(out / name)

    def no_build(_):
        raise AssertionError("the dataset was built again, not read from the cache")

    monkeypatch.setattr(radioml, "load_dataset", no_build)
    x, y, s, classes = tef.load_or_build_dataset(cfg, str(out))
    for got, want in zip((x, y, s), synthetic.make_dataset(cfg.data)):
        np.testing.assert_array_equal(got, want)
    assert classes == cfg.data.classes


def test_main_refuses_artifacts(tmp_path):
    with pytest.raises(SystemExit, match="artifacts"):
        tef.main(["device=cpu", f"out={os.path.join(REPO, 'artifacts', 'full')}"])
    assert not os.path.exists(os.path.join(REPO, "artifacts", "full"))
