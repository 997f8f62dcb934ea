"""The stream predictor's float branch (``dsp/pipeline.py::_make_predictor``
with a checkpoint and no int8 artifact), on the CPU.

- The r5 checkpoint computing in bf16 takes the fused bf16 classifier
  (``route == "bf16_v4"``): its labels are ``make_bf16_classifier_v4``'s bit
  for bit, and agree with the bf16 module's on 2,048 frames across the SNR
  grid (2,037 of 2,048 measured, 99.46 %); against the float32 module it
  agrees at least as well as the bf16 module does (99.51 % against 99.07 %
  measured), since it rounds no more than the module.
- The same checkpoint computing in float32, and a model wider than the
  kernels, take the module's forward (``route == "module"``) with the
  module's labels bit for bit; a narrower model is zero-padded onto the
  kernels' widths and takes the bf16 route.
- Under a profiler each call on either route is one
  ``amc.classifier.predict`` span and counts nothing; without one nothing
  is recorded.
"""
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from modulationdetectioncnn_torch.config import AmcConfig, DataConfig, apply_overrides
from modulationdetectioncnn_torch.data.synthetic import make_dataset
from modulationdetectioncnn_torch.dsp import pipeline as tpipe
from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2
from modulationdetectioncnn_torch.ops import infer_bf16 as ib
from modulationdetectioncnn_torch.utils import checkpoint as tckpt
from modulationdetectioncnn_torch.utils import profiler
from modulationdetectioncnn_torch.utils.checkpoint import restore_model

R5 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "modulationdetectioncnn_torch", "assets", "ckpt_rml11_r5")


def _cfg(checkpoint_dir: str, *overrides: str) -> AmcConfig:
    return apply_overrides(AmcConfig(), ["device=cpu", f"train.checkpoint_dir={checkpoint_dir}",
                                         *overrides])


def _module_labels(cfg: AmcConfig, x: torch.Tensor) -> torch.Tensor:
    model = restore_model(cfg.train.checkpoint_dir, cfg.model, cfg.data.frame_len, "cpu")[0]
    with torch.no_grad():
        return model(x).argmax(-1).to(torch.int32)


@pytest.fixture(scope="module")
def frames() -> torch.Tensor:
    """2,048 shuffled frames of the port's dataset, all 20 SNRs of the grid."""
    x, _, snr = make_dataset(DataConfig(), frames_per_class_per_snr=10)
    assert len(np.unique(snr[:2048])) == 20
    return torch.from_numpy(x[:2048])


def test_bf16_checkpoint_takes_the_fused_classifier(frames):
    cfg = _cfg(R5, "model.dtype=bfloat16")          # the benchmark's bf16 overrides
    predict = tpipe._make_predictor(cfg)
    assert predict.route == "bf16_v4"
    got = predict(frames)
    assert got.dtype == torch.int32 and got.shape == (len(frames),)
    state = restore_model(R5, cfg.model, 128, "cpu")[0].state_dict()
    assert torch.equal(got, ib.make_bf16_classifier_v4(state, "cpu")(frames))
    module_bf16 = _module_labels(cfg, frames)
    assert int((got == module_bf16).sum()) >= 2037       # 99.46 %, as measured
    f32 = _module_labels(_cfg(R5, "model.dtype=float32"), frames)
    assert (got == f32).sum() >= (module_bf16 == f32).sum()


def test_float32_checkpoint_keeps_the_module(frames):
    cfg = _cfg(R5, "model.dtype=float32")
    predict = tpipe._make_predictor(cfg)
    assert predict.route == "module"
    assert torch.equal(predict(frames[:256]), _module_labels(cfg, frames[:256]))


@pytest.mark.parametrize("widths,route", [
    (["model.conv1_filters=512"], "module"),
    (["model.dense_units=512"], "module"),
    (["model.conv2_filters=96"], "module"),
    (["model.num_classes=2", "model.conv1_filters=32", "model.conv2_filters=16",
      "model.dense_units=32"], "bf16_v4"),
], ids=["conv1_512", "dense_512", "conv2_96", "narrow"])
def test_route_follows_the_kernels_widths(tmp_path, frames, widths, route):
    cfg = _cfg(str(tmp_path / "ck"), "model.dtype=bfloat16", *widths)
    model = VTCNN2.from_config(cfg.model, generator=torch.Generator().manual_seed(3))
    tckpt.save(cfg.train.checkpoint_dir, 1, model.state_dict())
    assert ib.fits_kernels(model.state_dict()) == (route == "bf16_v4")
    predict = tpipe._make_predictor(cfg)
    assert predict.route == route
    x = frames[:64]
    want = (_module_labels(cfg, x) if route == "module"
            else ib.make_bf16_classifier_v4(model.state_dict(), "cpu")(x))
    assert torch.equal(predict(x), want)


def test_bf16_route_counts_each_call_under_a_profiler_only(frames):
    predict = tpipe._make_predictor(_cfg(R5, "model.dtype=bfloat16"))
    x = frames[:8]
    profiler.reset()
    predict(x)
    assert profiler.counters() == {} and profiler.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            predict(x)
    assert profiler.counters() == {}
    assert [r.name for r in profiler.spans()] == ["amc.classifier.predict"] * 3


def test_module_route_counts_nothing(frames):
    predict = tpipe._make_predictor(_cfg(R5, "model.dtype=float32"))
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        predict(frames[:8])
    assert profiler.counters() == {}
    assert [r.name for r in profiler.spans()] == ["amc.classifier.predict"]
