"""The plain reference agrees with the program on the CPU at a small size:
the integer chain exactly, the float forward and the front end to their
precision. (It imports nothing of the program; the tests do, to compare.)"""
import numpy as np
import torch

from amc_bench import check
from amc_bench.reference import frontend as ref_frontend
from amc_bench.reference.vtcnn2 import FloatModel, Int8Model
from amc_bench.tests.conftest import small_cell


def _frames(n=96, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 2, 128, generator=g) * 1.3


def test_int8_chain_equals_program_plain_path():
    from modulationdetectioncnn_torch.ops.infer import make_int8_predict
    from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, load_int8

    x = _frames()
    prog = make_int8_predict(load_int8(DEFAULT_ARTIFACT, "cpu"), "v7")(x)
    ref = Int8Model(DEFAULT_ARTIFACT, "cpu").labels(x)
    assert torch.equal(prog.long(), ref)


def test_int4_control_differs():
    from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT

    x = _frames(256)
    a = Int8Model(DEFAULT_ARTIFACT, "cpu").labels(x)
    b = Int8Model(DEFAULT_ARTIFACT, "cpu", weight_bits=4).labels(x)
    assert int((a != b).sum()) > 0


def test_float_forward_matches_program_float32():
    from modulationdetectioncnn_torch.config import ModelConfig
    from modulationdetectioncnn_torch.utils.checkpoint import restore_model

    cell = small_cell("bf16_frames")
    x = _frames()
    model = restore_model(cell.path("modulationdetectioncnn_torch/assets/ckpt_rml11_r5"),
                          ModelConfig(dtype="float32"), 128, "cpu")[0]
    prog = model(x)
    ref = FloatModel(cell.path(cell.config["weights"]), "cpu").logits(x)
    assert torch.allclose(prog, ref, rtol=1e-4, atol=1e-3 * float(ref.abs().max()))


def test_front_end_matches_program_stream_path():
    from modulationdetectioncnn_torch.dsp import pipeline
    from modulationdetectioncnn_torch.config import StreamConfig

    for timing in (False, True):
        sc = StreamConfig(normalize_timing=timing)
        x = torch.randn(2, 1 << 16, generator=torch.Generator().manual_seed(5))
        got = {}

        def keep(fr):
            got["x"] = fr
            return torch.zeros(fr.shape[0], dtype=torch.int32)

        pipeline.classify_stream_blocked(x, keep, sc)
        prog = check.subband_order(got["x"], sc, x.shape[-1])
        ref = ref_frontend.stream_frames(x, check.front_end_settings(sc))
        err = check.frames_error(prog, ref)
        assert float(np.quantile(err.numpy(), 0.99)) < 1e-4
