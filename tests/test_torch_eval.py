"""The port's ``eval`` and ``quantize`` paths against the JAX package, on the CPU.

Data, harness, golden forward, float model, float checkpoint export,
quantize, the eval command and the stream predictor's choice. Inputs come
from numpy seeds (or the committed checkpoint) and go through both
packages; each comparison states its tolerance.
"""
import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulationdetectioncnn_torch import cli
from modulationdetectioncnn_torch.config import AmcConfig, DataConfig, ModelConfig, apply_overrides
from modulationdetectioncnn_torch.data import radioml as tradioml
from modulationdetectioncnn_torch.data import synthetic as tsyn
from modulationdetectioncnn_torch.dsp import pipeline as tpipe
from modulationdetectioncnn_torch.eval import harness as tharness
from modulationdetectioncnn_torch.golden import cnn as tgolden
from modulationdetectioncnn_torch.models import VTCNN2 as TVTCNN2
from modulationdetectioncnn_torch.models import flax_params
from modulationdetectioncnn_torch.ops import infer as tinfer
from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, QuantizedModel, load_int8
from modulationdetectioncnn_torch.train import quant as tquant
from modulationdetectioncnn_torch.utils import checkpoint as tckpt
from modulationdetectioncnn_tpu import cli as jcli
from modulationdetectioncnn_tpu.config import AmcConfig as JAmcConfig
from modulationdetectioncnn_tpu.config import DataConfig as JDataConfig
from modulationdetectioncnn_tpu.config import apply_overrides as japply
from modulationdetectioncnn_tpu.data import radioml as jradioml
from modulationdetectioncnn_tpu.data import synthetic as jsyn
from modulationdetectioncnn_tpu.eval import harness as jharness
from modulationdetectioncnn_tpu.golden import cnn as jgolden
from modulationdetectioncnn_tpu.golden import quant as gq
from modulationdetectioncnn_tpu.models import VTCNN2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CKPT = os.path.join(REPO, "modulationdetectioncnn_torch", "assets", "ckpt_rml11_r5")
JAX_CKPT = os.path.join(REPO, "artifacts", "ckpt_rml11_r5")
# A tiny sweep: 2 frames per class at 0, 6, 12 and 18 dB (88 frames).
TINY = ["data.frames_per_class_per_snr=2", "data.snr_db_min=0", "data.snr_db_max=18",
        "data.snr_db_step=6", "eval.batch_size=32"]


@pytest.fixture(scope="module")
def jax_params():
    from modulationdetectioncnn_tpu.utils import checkpoint as jck

    mgr = jck.make_manager(JAX_CKPT)
    try:
        params, _, step = jck.restore(mgr)
    finally:
        mgr.close()
    assert step == 96000
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def port_model():
    model, step = tckpt.restore_model(PORT_CKPT, ModelConfig(), 128, "cpu")
    assert step == 96000
    return model


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("kw", [dict(frames_per_class_per_snr=2, snr_db_min=-4,
                                     snr_db_max=10, snr_db_step=14),
                                dict(classes=("BPSK", "WBFM", "AM-SSB"), seed=3,
                                     frames_per_class_per_snr=3)])
def test_make_dataset_and_split_equal_jax(kw):
    got = tsyn.make_dataset(DataConfig(**kw))
    want = jsyn.make_dataset(JDataConfig(**kw))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g_part, w_part in zip(tsyn.train_test_split(*got, test_frac=0.2),
                              jsyn.train_test_split(*want, test_frac=0.2)):
        for g, w in zip(g_part, w_part):
            np.testing.assert_array_equal(g, w)


def test_make_dataset_overrides_equal_jax():
    """quantize's calibration call: snrs, frames and seed given explicitly."""
    kw = dict(frames_per_class_per_snr=1, snrs=[0, 10, 18], seed=99)
    for g, w in zip(tsyn.make_dataset(DataConfig(), **kw),
                    jsyn.make_dataset(JDataConfig(), **kw)):
        np.testing.assert_array_equal(g, w)


def test_complex_to_iq_equals_jax():
    r = np.random.default_rng(0)
    x = (r.standard_normal((3, 16)) + 1j * r.standard_normal((3, 16))).astype(np.complex64)
    got = tsyn.complex_to_iq(x)
    assert got.dtype == np.float32 and got.shape == (3, 2, 16)
    np.testing.assert_array_equal(got, jsyn.complex_to_iq(x))


@pytest.fixture(scope="module")
def tiny_pickle(tmp_path_factory):
    """A tiny pickle in the RML2016.10a on-disk format."""
    rng = np.random.default_rng(7)
    data = {(mod, snr): tsyn.complex_to_iq(tsyn.generate_frames(rng, mod, 4, float(snr)))
            for mod in ("QPSK", "BPSK", "QAM16") for snr in (-2, 10)}
    path = tmp_path_factory.mktemp("rml") / "rml_tiny.pkl"
    path.write_bytes(pickle.dumps(data, protocol=2))
    return str(path), data


def test_pickle_loader_round_trips_and_equals_jax(tiny_pickle):
    path, data = tiny_pickle
    x, y, s, classes = tradioml.load_radioml_pickle(path)
    assert classes == ("BPSK", "QAM16", "QPSK") and x.shape == (24, 2, 128)
    for (mod, snr), frames in data.items():
        mask = (y == classes.index(mod)) & (s == snr)
        np.testing.assert_array_equal(x[mask], frames)
    jx, jy, js, jclasses = jradioml.load_radioml_pickle(path)
    assert jclasses == classes
    for g, w in ((x, jx), (y, jy), (s, js)):
        np.testing.assert_array_equal(g, w)


def test_load_dataset_prefers_the_pickle(tiny_pickle, tmp_path):
    path, _ = tiny_pickle
    x, _, _, classes = tradioml.load_dataset(DataConfig(radioml_pickle=path))
    assert classes == ("BPSK", "QAM16", "QPSK") and len(x) == 24
    cfg = DataConfig(radioml_pickle=str(tmp_path / "missing.pkl"),
                     frames_per_class_per_snr=1, snr_db_min=0, snr_db_max=0)
    x, _, _, classes = tradioml.load_dataset(cfg)
    assert classes == cfg.classes and len(x) == 11


# -------------------------------------------------------------- harness


def test_snr_sweep_equals_jax_dict():
    """The same predictions (a fixed draw, a ragged tail batch) give the
    JAX harness's dict, curve text and file, exactly."""
    r = np.random.default_rng(3)
    x = r.standard_normal((37, 2, 8)).astype(np.float32)
    y = r.integers(0, 4, 37).astype(np.int32)
    s = r.choice([-2, 0, 10, 18], 37).astype(np.int32)
    preds = r.integers(0, 4, 37)
    calls = []

    def predict(xb):
        calls.append(len(xb))
        i = sum(calls[:-1])
        return np.concatenate([preds, np.zeros(len(xb), np.int64)])[i:i + len(xb)]

    classes = ("a", "b", "c", "d")
    got = tharness.snr_sweep(predict, x, y, s, classes, batch_size=16)
    assert calls == [16, 16, 16]
    calls.clear()
    want = jharness.snr_sweep(predict, x, y, s, classes, batch_size=16)
    assert got == want
    assert tharness.format_curve(got) == jharness.format_curve(want)
    assert got["headline"]["acc_at_10dB"] is not None


# ----------------------------------------------------- golden and float


def test_golden_forward_equals_jax_golden(jax_params):
    x = np.random.default_rng(2).standard_normal((6, 2, 128)).astype(np.float32)
    np.testing.assert_array_equal(tgolden.vtcnn2_forward(jax_params, x),
                                  jgolden.vtcnn2_forward(jax_params, x))


@pytest.fixture(scope="module")
def init_model():
    """The JAX golden test's model: Flax init, key 0, carried to torch."""
    from modulationdetectioncnn_torch.models import params_from_flax

    tree = jax.tree.map(np.asarray, VTCNN2(dtype=jnp.float32).init(
        jax.random.key(0), jnp.zeros((4, 2, 128))))
    return tree, params_from_flax(tree)


def test_float_model_fp32_matches_port_golden(init_model):
    """tests/test_golden_cnn.py's bar: rtol = atol = 1e-4."""
    tree, state = init_model
    m = TVTCNN2(dtype="float32")
    m.load_state_dict(state)
    x = np.random.default_rng(0).standard_normal((8, 2, 128)).astype(np.float32)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, tgolden.vtcnn2_forward(flax_params(m), x),
                               rtol=1e-4, atol=1e-4)


def test_float_model_bf16_close_to_port_golden(init_model):
    """tests/test_golden_cnn.py's bf16 bar: max |delta| < 2e-2, argmax
    agreement >= 0.8."""
    tree, state = init_model
    m = TVTCNN2(dtype="bfloat16")
    m.load_state_dict(state)
    x = np.random.default_rng(1).standard_normal((8, 2, 128)).astype(np.float32)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x)).numpy()
    want = tgolden.vtcnn2_forward(tree, x)
    assert np.max(np.abs(got - want)) < 2e-2
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.8


def test_restored_checkpoint_fp32_matches_golden(port_model, jax_params):
    """The exported checkpoint, fp32, against the JAX golden on the Orbax
    parameters: within 1e-4 relative to the logits' scale (|logit| ~ 50)."""
    m = TVTCNN2(dtype="float32")
    m.load_state_dict(port_model.state_dict())
    x, _, _ = tsyn.make_dataset(DataConfig(), frames_per_class_per_snr=1, snrs=[10], seed=4)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x)).numpy()
    want = jgolden.vtcnn2_forward(jax_params, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_float_export_equals_the_orbax_checkpoint(jax_params):
    """params.npz holds the Orbax step's parameters, array by array."""
    tree = tckpt.load_flax_tree(os.path.join(PORT_CKPT, "96000", "params.npz"))
    want = jax_params.get("params", jax_params)
    assert set(tree) == set(want) == {"Conv1", "Conv2", "Dense1", "Dense2"}
    for layer, leaves in want.items():
        assert set(tree[layer]) == set(leaves)
        for name, v in leaves.items():
            assert tree[layer][name].dtype == v.dtype, (layer, name)
            np.testing.assert_array_equal(tree[layer][name], v, err_msg=f"{layer}/{name}")


def test_checkpoint_restore_picks_the_newest_step(tmp_path):
    assert tckpt.restore(str(tmp_path)) is None
    assert tckpt.latest_step(str(tmp_path / "missing")) is None
    src = os.path.join(PORT_CKPT, "96000", "params.npz")
    for step in (5, 40, 12):
        os.makedirs(tmp_path / str(step))
        os.symlink(src, tmp_path / str(step) / "params.npz")
    os.makedirs(tmp_path / "77")                     # no params.npz: skipped
    state, step = tckpt.restore(str(tmp_path))
    assert step == 40 and set(state) >= {"conv1.weight", "dense2.bias"}


# ------------------------------------------------------------- quantize


@pytest.fixture(scope="module")
def calib():
    cfg = apply_overrides(AmcConfig(device="cpu"), ["quant.calib_frames=66"])
    x = cli.calibration_frames(cfg)
    want, _, _ = jsyn.make_dataset(JDataConfig(), frames_per_class_per_snr=2,
                                   snrs=[0, 10, 18], seed=99)
    np.testing.assert_array_equal(x, want)         # cmd_quantize's recipe
    return x


def test_quantize_scales_match_jax(port_model, jax_params, calib):
    """bf16 calibration on both sides: s_x equal; a1..a3 within 1e-2
    relative. The percentiles are of bf16 activations, and torch and XLA
    round bf16 products at different places, so a percentile can land a
    bf16 step or two apart (one step is 2**-8 ~ 0.4 %)."""
    from modulationdetectioncnn_tpu.train import quant as jquant

    want = jquant.calibrate_activations(VTCNN2(), jax_params, calib)
    got = tquant.calibrate_activations(port_model, calib)
    assert got["s_x"] == want["s_x"]
    for k in ("a1", "a2", "a3"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, err_msg=k)


def test_quantize_equals_jax_given_jax_scales(port_model, jax_params, calib, monkeypatch):
    from modulationdetectioncnn_tpu.train import quant as jquant

    want = jquant.quantize(VTCNN2(), jax_params, calib).tree()
    scales = jquant.calibrate_activations(VTCNN2(), jax_params, calib)
    monkeypatch.setattr(tquant, "calibrate_activations", lambda *a, **k: dict(scales))
    got = tquant.quantize(port_model, calib).tree()
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_quantize_command_writes_what_eval_reads(tmp_path, capsys):
    """``quantize`` on the CPU writes <out>/int8.npz and prints the JSON
    line; ``eval eval.backend=int8 eval.int8_artifact=<out>`` reads it."""
    cfg = apply_overrides(AmcConfig(), ["device=cpu", f"train.checkpoint_dir={PORT_CKPT}",
                                        "quant.calib_frames=66"])
    out_dir, agree = cli.cmd_quantize(cfg, out_dir=str(tmp_path / "q_int8"))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"int8_artifact": out_dir, "agreement_vs_float": agree}
    assert agree >= 0.9
    qm = QuantizedModel.from_npz(os.path.join(out_dir, "int8.npz"))
    assert qm.widths() == (128, 256, 80, 256, 11)
    res, _ = cli.cmd_eval(apply_overrides(cfg, [*TINY, "eval.backend=int8",
                                             f"eval.int8_artifact={out_dir}",
                                             f"eval.results_path={tmp_path / 'r.json'}"]))
    x, y, s = tsyn.make_dataset(apply_overrides(cfg, TINY).data)
    assert res == jharness.snr_sweep(lambda xb: gq.int8_predict(qm, xb), x, y, s,
                                     cfg.data.classes, batch_size=32)


def test_quantize_without_checkpoint_dir_exits():
    with pytest.raises(SystemExit, match="train.checkpoint_dir"):
        cli.main(["quantize", "device=cpu"])


# ----------------------------------------------------------------- eval


def _eval_both(backend, tmp_path, extra=()):
    """The port's eval results and labels for a tiny dataset, and the
    overrides, for the JAX package to run the same."""
    over = [*TINY, f"eval.backend={backend}", f"train.checkpoint_dir={PORT_CKPT}", *extra]
    got, pred = cli.cmd_eval(apply_overrides(AmcConfig(), [
        "device=cpu", *over, f"eval.results_path={tmp_path / 'port.json'}"]))
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == got
    return got, pred, over


def test_eval_golden_equals_jax_eval_golden(tmp_path, capsys):
    """The same sweep through the JAX CLI's golden backend on the Orbax
    checkpoint: the same dict, exactly (both are the float64 NumPy
    forward)."""
    got, _, _ = _eval_both("golden", tmp_path)
    out = capsys.readouterr().out
    assert "SNR(dB)  accuracy" in out and json.loads(out.strip().splitlines()[-1]) == got["headline"]
    jcfg = japply(JAmcConfig(), [*TINY, "eval.backend=golden",
                                 f"train.checkpoint_dir={JAX_CKPT}",
                                 f"eval.results_path={tmp_path / 'jax.json'}"])
    assert got == jcli.cmd_eval(jcfg)


@pytest.mark.parametrize("version", ["v5", "v6", "v4", "v7", "v10"])
def test_eval_int8_equals_jax_golden_int8_sweep(tmp_path, version):
    """eval.backend=int8 on the committed artifact: the JAX harness's dict
    over the golden int8 labels, for every conv-stage version."""
    got, pred, over = _eval_both("int8", tmp_path, [f"eval.int8_kernel={version}"])
    cfg = japply(JAmcConfig(), over)
    x, y, s = jsyn.make_dataset(cfg.data)
    qm = QuantizedModel.from_npz(DEFAULT_ARTIFACT)
    np.testing.assert_array_equal(pred, gq.int8_predict(qm, x))
    assert got == jharness.snr_sweep(lambda xb: gq.int8_predict(qm, xb), x, y, s,
                                     cfg.data.classes, batch_size=32)


def test_eval_flax_agrees_with_jax_golden(tmp_path, jax_params):
    """The torch bf16 float model's labels against the float64 golden on
    the Orbax parameters: >= 0.95 agreement (bf16 rounding can flip a
    near tie), and the sweep's accuracies within 0.1 of golden's."""
    got, labels, over = _eval_both("flax", tmp_path)
    cfg = apply_overrides(AmcConfig(device="cpu"), over)
    x, y, s = tsyn.make_dataset(cfg.data)
    want = jgolden.vtcnn2_predict(jax_params, x)
    assert (labels == want).mean() >= 0.95
    gold = jharness.snr_sweep(lambda xb: jgolden.vtcnn2_predict(jax_params, xb),
                              x, y, s, cfg.data.classes, batch_size=32)
    for k, v in gold["snr_accuracy"].items():
        assert abs(got["snr_accuracy"][k] - v) <= 0.1, k


def test_eval_rejects_an_unknown_backend_and_a_missing_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="unknown eval.backend"):
        cli.main(["eval", "device=cpu", "eval.backend=bf16"])
    with pytest.raises(SystemExit, match="requires train.checkpoint_dir"):
        cli.main(["eval", "device=cpu", "eval.backend=flax"])
    with pytest.raises(SystemExit, match="no checkpoint found"):
        cli.main(["eval", "device=cpu", f"train.checkpoint_dir={tmp_path}"])


def test_split_sweep_compare(tmp_path):
    """The harness's ``compare``: equal when frames and accuracies per SNR
    are; a result that differs at one SNR is reported there, and its
    command exits 1."""
    ref = {"snr_accuracy": {"0": 0.5, "10": 1.0}, "headline": {},
           "confusion": {"0": [[1, 1], [0, 0]], "10": [[1, 0], [0, 1]]}}
    same = tharness.compare(ref, ref)
    assert same["frames_equal"] and same["accuracy_equal"]
    other = json.loads(json.dumps(ref))
    other["snr_accuracy"]["10"] = 0.5
    rep = tharness.compare(other, ref)
    assert not rep["accuracy_equal"] and rep["snrs_differing"] == ["10"]
    for name, obj in (("a.json", other), ("b.json", ref)):
        (tmp_path / name).write_text(json.dumps(obj))
    assert tharness.main([str(tmp_path / "a.json"), str(tmp_path / "b.json")]) == 1
    assert tharness.main([str(tmp_path / "b.json"), str(tmp_path / "b.json")]) == 0


def test_eval_test_split_sweeps_the_held_out_part(tmp_path):
    """``eval.test_split=0.2`` sweeps the JAX package's
    ``train_test_split(..., 0.2)`` test part (the accuracy artifacts'
    split): the JAX harness's dict over the golden int8 labels of exactly
    those frames."""
    got, pred, over = _eval_both("int8", tmp_path, ["eval.int8_kernel=v5", "eval.test_split=0.2"])
    cfg = japply(JAmcConfig(), [o for o in over if not o.startswith("eval.test_split")])
    _, (xte, yte, ste) = jsyn.train_test_split(*jsyn.make_dataset(cfg.data), test_frac=0.2)
    qm = QuantizedModel.from_npz(DEFAULT_ARTIFACT)
    assert len(pred) == len(xte) == sum(int(np.sum(c)) for c in got["confusion"].values())
    np.testing.assert_array_equal(pred, gq.int8_predict(qm, xte))
    assert got == jharness.snr_sweep(lambda xb: gq.int8_predict(qm, xb), xte, yte, ste,
                                     cfg.data.classes, batch_size=32)


# ----------------------------------------------------- stream predictor


def _stream_cfg(**eval_train):
    cfg = AmcConfig(device="cpu")
    ev = {k: v for k, v in eval_train.items() if k != "checkpoint_dir"}
    return dataclasses.replace(
        cfg, eval=dataclasses.replace(cfg.eval, **ev),
        train=dataclasses.replace(cfg.train, checkpoint_dir=eval_train.get("checkpoint_dir")))


def test_stream_predictor_finds_checkpoint_dir_int8(tmp_path, capsys):
    """``<checkpoint_dir>_int8`` (what quantize writes) is deployed through
    the int8 kernels, with no warning."""
    QuantizedModel.from_npz(DEFAULT_ARTIFACT).save(str(tmp_path / "ck_int8"))
    cfg = _stream_cfg(checkpoint_dir=str(tmp_path / "ck") + "/")
    assert tpipe.int8_artifact_for(cfg) == str(tmp_path / "ck_int8")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 2, 128)).astype(np.float32))
    want = tinfer.make_int8_predict(load_int8(device="cpu"))(x)
    assert torch.equal(tpipe._make_predictor(cfg)(x), want)
    assert "WARNING" not in capsys.readouterr().out
    named = _stream_cfg(int8_artifact=DEFAULT_ARTIFACT, checkpoint_dir=str(tmp_path / "ck"))
    assert tpipe.int8_artifact_for(named) == DEFAULT_ARTIFACT


def test_stream_predictor_float_fallback_warns(tmp_path, capsys, port_model):
    """A checkpoint without an int8 artifact streams through the float
    model, with the JAX package's warning; an empty directory raises."""
    os.makedirs(tmp_path / "ck" / "96000")
    os.symlink(os.path.join(PORT_CKPT, "96000", "params.npz"),
               tmp_path / "ck" / "96000" / "params.npz")
    predict = tpipe._make_predictor(_stream_cfg(checkpoint_dir=str(tmp_path / "ck")))
    assert "WARNING: no int8 artifact" in capsys.readouterr().out
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 2, 128)).astype(np.float32))
    with torch.no_grad():
        want = port_model(x).argmax(-1).to(torch.int32)
    assert torch.equal(predict(x), want)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tpipe._make_predictor(_stream_cfg(checkpoint_dir=str(tmp_path / "empty")))


def test_stream_predictor_defaults_to_the_committed_artifact(capsys):
    assert tpipe.int8_artifact_for(_stream_cfg()) is None
    x = torch.zeros((2, 2, 128))
    assert torch.equal(tpipe._make_predictor(_stream_cfg())(x),
                       tinfer.make_int8_predict(load_int8(device="cpu"))(x))
    assert "WARNING" not in capsys.readouterr().out
