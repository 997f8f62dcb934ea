"""A configuration of another architecture enters by new files alone.

A stand-in architecture, a two-layer float MLP over the flattened 2 x T
frame, is registered as ``amc_bench.arch.mlp_standin`` (in ``sys.modules``,
where a new ``arch/<architecture>.py`` would be imported from) with its
reference, its operations, its published widths and no controls. A frames
cell of it runs through ``run.run`` on the CPU with the stand-in's bf16
forward as the classifier: correct, its ``mfu.frames`` at the bf16 peak,
and the planted ``half`` and ``alter`` faults not correct. No file of the harness names it.
"""
import json
import math
import sys
import time
import types

import numpy as np
import pytest
import torch

from amc_bench import controls, run, spec
from amc_bench.reference.common import tf32
from amc_bench.system import System

T, HIDDEN, CLASSES = 256, 64, 5
BATCH, POOL = 128, 384
# logit_gap_max on the CPU, 12 seeds, a call a batch: sound 0-0.043, half
# 37.0-62.5, one label altered a call 1.26-63.1.
LIMIT = 0.25


class MlpReference:
    """The stand-in's float32 forward, TF32 off: relu(x w1 + b1) w2 + b2."""

    def __init__(self, path: str, device):
        with np.load(path) as z:
            self.w = {k: torch.tensor(z[k], dtype=torch.float32, device=device) for k in z.files}

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        with tf32(False):
            h = torch.relu(x.reshape(x.shape[0], -1).float() @ w["w1"] + w["b1"])
            return h @ w["w2"] + w["b2"]


def _architecture() -> types.ModuleType:
    arch = types.ModuleType(f"{spec.ARCH}.mlp_standin")
    arch.PUBLISHED = {"frame_len": T, "hidden_units": HIDDEN, "num_classes": CLASSES}
    arch.reference = lambda config, path, device: MlpReference(path, device)
    arch.ops_per_frame = lambda cfg: 2 * (2 * cfg["frame_len"] * cfg["hidden_units"]
                                          + cfg["hidden_units"] * cfg["num_classes"])
    arch.KERNELS = {}
    arch.CONTROLS = {}
    return arch


def _bf16_forward(path: str):
    """The system under test: the same MLP with weights and activations in
    bf16, labels out."""
    with np.load(path) as z:
        w = {k: torch.tensor(z[k]).to(torch.bfloat16) for k in z.files}

    def predict(x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x.reshape(x.shape[0], -1).to(torch.bfloat16) @ w["w1"] + w["b1"])
        return (h @ w["w2"] + w["b2"]).float().argmax(-1).to(torch.int32)

    return predict


@pytest.fixture
def cell(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, f"{spec.ARCH}.mlp_standin", _architecture())
    g = np.random.default_rng(7)
    path = tmp_path / "mlp_standin.npz"
    np.savez(path, w1=g.normal(0, 1 / math.sqrt(2 * T), (2 * T, HIDDEN)).astype(np.float32),
             b1=g.normal(0, 0.1, HIDDEN).astype(np.float32),
             w2=g.normal(0, 3 / math.sqrt(HIDDEN), (HIDDEN, CLASSES)).astype(np.float32),
             b2=g.normal(0, 0.1, CLASSES).astype(np.float32))
    config = {"name": "mlp_standin_bf16", "architecture": "mlp_standin", "frame_len": T,
              "hidden_units": HIDDEN, "num_classes": CLASSES, "precision": "bfloat16",
              "weights": str(path), "program": []}
    cfg_path = tmp_path / "mlp_standin_bf16.json"
    cfg_path.write_text(json.dumps(config))
    bench = spec.benchmark()
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    traffic = {"kind": "frames", "pool_frames": POOL, "batch": BATCH, "frame_len": T, "sps": 8,
               "snr_db": [-20, 18, 2], "cfo_sigma": 2e-5, "max_cfo": 2.5e-3}
    return spec.Cell(name="mlp_standin_frames", chips=1, config=spec.load_config(str(cfg_path)),
                     traffic=traffic, settings={"program": [], "limits": {"logit_gap_max": LIMIT}},
                     end_to_end=[metrics["setup_s"], metrics["classify_msps"]],
                     per_layer=[metrics["mfu.frames"]])


def _run(cell, mode: str) -> dict:
    restore = []

    def factory(c, device):
        system = System(c, device)
        system.predict = _bf16_forward(c.path(c.config["weights"]))
        controls.apply(system, c, mode, restore)
        return system

    try:
        return run.run(cell, 2**32 + 29, math.inf, True, "cpu", time.perf_counter(),
                       system_factory=factory, calls=POOL // BATCH)
    finally:
        for undo in reversed(restore):
            undo()


def test_standin_architecture_is_found_by_name(cell):
    arch = spec.architecture(cell.config)
    assert arch.PUBLISHED["frame_len"] == cell.config["frame_len"] == T
    assert "mlp_standin" not in spec.architectures()        # no file of the harness names it
    assert not controls.applies(cell, "int4") and not controls.applies(cell, "int8_path")
    assert controls.applies(cell, "half") and controls.applies(cell, "alter")


def test_standin_cell_runs_correct_with_mfu_at_the_bf16_peak(cell):
    line = _run(cell, "sound")
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == POOL // BATCH and line["failed"] == 0
    ops = 2 * (2 * T * HIDDEN + HIDDEN * CLASSES)
    frames = line["attempted"] * BATCH
    want = ops * frames / (line["device"]["window_s"] * 989e12) * 100
    assert line["metrics"]["mfu.frames"]["value"] == pytest.approx(want, rel=1e-12)
    assert line["metrics"]["mfu.frames"]["unit"] == "%"


@pytest.mark.parametrize("mode", ["half", "alter"])
def test_standin_fault_is_not_correct(cell, mode):
    line = _run(cell, mode)
    assert line["correct"] is False, line["checks"]
