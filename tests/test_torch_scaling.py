"""The port's scaling report (``eval/scaling.py``), ``halo_wideband`` and the
``scaling`` command, held to the JAX package's on the CPU, and the JAX
report's own checks (``tests/test_scaling.py``) on the port's H100 link
constants."""
import dataclasses
import json

import jax
import numpy as np
import pytest

from modulationdetectioncnn_torch import cli
from modulationdetectioncnn_torch.config import AmcConfig, StreamConfig
from modulationdetectioncnn_torch.dsp import pipeline as tpipe
from modulationdetectioncnn_torch.eval import scaling as tscaling
from modulationdetectioncnn_tpu.config import AmcConfig as JAmcConfig
from modulationdetectioncnn_tpu.config import StreamConfig as JStreamConfig
from modulationdetectioncnn_tpu.dsp import pipeline as jpipe
from modulationdetectioncnn_tpu.eval import scaling as jscaling

CPU = AmcConfig(device="cpu")
STREAMS = {
    "default": {},
    "resample_1_2": {"resample_up": 1, "resample_down": 2},
    "resample_2_3": {"resample_up": 2, "resample_down": 3},
    "subbands_8": {"num_subbands": 8},
    "hop_64": {"frame_hop": 64},
}


@pytest.mark.parametrize("name", STREAMS)
def test_halo_wideband_equals_jax(name):
    kw = STREAMS[name]
    assert tpipe.halo_wideband(StreamConfig(**kw)) == jpipe.halo_wideband(JStreamConfig(**kw))


CASES = [(1e9, 1 << 15, 112), (3.5e8, 1 << 20, 256), (7.0e8, 1 << 22, 1136), (1e3, 128, 0)]


@pytest.mark.parametrize("rate,block,halo", CASES)
def test_stream_efficiency_equals_jax(rate, block, halo):
    for bw, lat in ((tscaling.ICI_BW, tscaling.ICI_LAT), (tscaling.DCN_BW, tscaling.DCN_LAT)):
        got = tscaling.stream_efficiency(rate, block, halo, tscaling.LinkModel(bw, lat, "l"))
        want = jscaling.stream_efficiency(rate, block, halo, jscaling.LinkModel(bw, lat, "l"))
        assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_train_dp_efficiency_equals_jax(n_devices):
    for step, nbytes in ((4.77e-3, 10_666_348), (2e-3, 1.08e7)):
        for bw, lat in ((tscaling.ICI_BW, tscaling.ICI_LAT),
                        (tscaling.DCN_BW, tscaling.DCN_LAT)):
            got = tscaling.train_dp_efficiency(step, nbytes, n_devices,
                                               tscaling.LinkModel(bw, lat, "l"))
            want = jscaling.train_dp_efficiency(step, nbytes, n_devices,
                                                jscaling.LinkModel(bw, lat, "l"))
            assert got == pytest.approx(want, rel=1e-12)


def test_param_count_equals_jax_init():
    from modulationdetectioncnn_tpu.models import VTCNN2 as JVTCNN2

    jcfg = JAmcConfig()
    model = JVTCNN2.from_config(jcfg.model)
    p = model.init(jax.random.key(0), np.zeros((1, 2, jcfg.data.frame_len), np.float32))
    want = sum(x.size for x in jax.tree.leaves(p))
    got = tscaling.scaling_report(CPU, measured_chip_rate=3.5e8)["measured_inputs"]["param_count"]
    assert got == want == 2_666_587


def test_report_keys_are_jax_keys_plus_links_and_devices():
    got = tscaling.scaling_report(CPU, measured_chip_rate=3.5e8)
    want = jscaling.scaling_report(JAmcConfig(), measured_chip_rate=3.5e8)
    assert set(got) == set(want)
    assert set(got["measured_inputs"]) == set(want["measured_inputs"]) | {
        "device", "train_rate_device"}
    assert set(got["assumptions"]) == set(want["assumptions"]) | {"links"}
    assert set(got["projected"]) == set(want["projected"])
    assert set(got["assumptions"]["links"]) == {"ici", "dcn"}
    assert "NVLink" in got["assumptions"]["links"]["ici"]
    assert "InfiniBand NDR" in got["assumptions"]["links"]["dcn"]
    # A rate measured on the CPU is named as the CPU's, never the card's.
    assert got["measured_inputs"]["device"] == "cpu"
    assert "H100" in got["measured_inputs"]["train_rate_device"]
    # Without a rate the projection assumes 1e9 samples/s and names no device.
    assert tscaling.scaling_report(AmcConfig())["measured_inputs"]["device"] is None


def test_report_projections_follow_the_formulas():
    r = tscaling.scaling_report(CPU, measured_chip_rate=4.3e8)
    a, mi, proj = r["assumptions"], r["measured_inputs"], r["projected"]
    dcn = tscaling.LinkModel(a["dcn_bw_Bps"], a["dcn_lat_s"], "dcn")
    ici = tscaling.LinkModel(a["ici_bw_Bps"], a["ici_lat_s"], "ici")
    assert proj["stream_eff_2host_dcn_at_default_policy"] == jscaling.stream_efficiency(
        4.3e8, 1 << 20, 112, jscaling.LinkModel(dcn.bw, dcn.lat, "dcn"))
    assert proj["train_dp_eff_8chip_ici"] == jscaling.train_dp_efficiency(
        mi["train_step_time_s"], a["grad_bytes"], 8, jscaling.LinkModel(ici.bw, ici.lat, "ici"))
    assert mi["train_step_time_s"] == 1024 / mi["train_samples_per_sec"]
    assert a["grad_bytes"] == 4 * 2_666_587


# tests/test_scaling.py's four checks, on the port's constants.

def test_stream_efficiency_monotone_in_block():
    link = tscaling.LinkModel(tscaling.DCN_BW, tscaling.DCN_LAT, "dcn")
    effs = [tscaling.stream_efficiency(1e9, b, 120, link) for b in (1 << 15, 1 << 20, 1 << 22)]
    assert effs == sorted(effs)
    assert 0 < effs[0] < 1
    assert effs[-1] > 0.85


def test_scaling_report_fields():
    r = tscaling.scaling_report(CPU, measured_chip_rate=3.5e8)
    assert r["measured_1chip_samples_per_sec"] == 3.5e8
    assert r["assumptions"]["halo_samples"] == 112
    proj = r["projected"]
    big = [v for k, v in proj.items() if k.startswith("stream_eff_2chip_ici_block_41943")]
    assert big and big[0] > 0.99
    assert proj["train_dp_eff_2host_dcn"] > 0.5


def test_default_policy_meets_2host_dcn_target():
    assert tpipe.effective_block_len(CPU.stream, 1) == CPU.stream.block_len
    r = tscaling.scaling_report(CPU, measured_chip_rate=4.3e8)
    assert r["projected"]["stream_eff_2host_dcn_at_default_policy"] >= 0.85


def test_train_dp_efficiency_model():
    link = tscaling.LinkModel(tscaling.ICI_BW, tscaling.ICI_LAT, "ici")
    e2 = tscaling.train_dp_efficiency(2e-3, 1.08e7, 2, link)
    e8 = tscaling.train_dp_efficiency(2e-3, 1.08e7, 8, link)
    assert 0.8 < e8 < e2 < 1.0


def test_measured_train_rate_reads_the_record_and_falls_back(tmp_path):
    with open(tscaling.TRAIN_RATE_PATH) as f:
        rec = json.load(f)
    assert set(rec) == {"samples_per_sec", "device", "power_limit_w", "source"}
    assert tscaling._measured_train_rate() == rec["samples_per_sec"] > 0
    assert "H100" in rec["device"]
    other = tmp_path / "rate.json"
    other.write_text(json.dumps({"samples_per_sec": 1234.5, "device": "NVIDIA H100 80GB HBM3",
                                 "power_limit_w": 500}))
    assert tscaling._measured_train_rate(str(other)) == 1234.5
    assert tscaling._train_rate_record(str(other))[1] == "NVIDIA H100 80GB HBM3, 500.00 W"
    missing = str(tmp_path / "missing.json")
    assert tscaling._measured_train_rate(missing) == tscaling.MEASURED_TRAIN_SAMPLES_PER_SEC
    (tmp_path / "bad.json").write_text("{}")
    assert (tscaling._measured_train_rate(str(tmp_path / "bad.json"))
            == tscaling.MEASURED_TRAIN_SAMPLES_PER_SEC)


def test_scaling_command_on_cpu_prints_the_report(capsys):
    rc = cli.main(["scaling", "device=cpu", "bench.batch_size=64",
                  "bench.warmup_iters=1", "bench.timed_iters=2"])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed["measured_1chip_samples_per_sec"] > 0
    assert printed["measured_inputs"]["device"] == "cpu"
    assert printed["assumptions"]["halo_samples"] == 112
    assert set(printed["projected"]) == set(jscaling.scaling_report(
        JAmcConfig(), measured_chip_rate=1e9)["projected"])


def test_scaling_report_of_an_overridden_stream():
    """The report follows the config: the 1/2 resampler's composed halo."""
    cfg = dataclasses.replace(CPU, stream=dataclasses.replace(
        CPU.stream, resample_up=1, resample_down=2))
    r = tscaling.scaling_report(cfg, measured_chip_rate=1e9)
    assert r["assumptions"]["halo_samples"] == 256
