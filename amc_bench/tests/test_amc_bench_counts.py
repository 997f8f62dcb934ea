"""The op and byte counts against hand-worked shapes."""
import json
import os
import types

import pytest

from amc_bench import counts, spec
from amc_bench.arch import vtcnn2

CFG = json.load(open(os.path.join(spec.HERE, "configs", "vtcnn2_rml11_int8.json")))
BF16 = json.load(open(os.path.join(spec.HERE, "configs", "vtcnn2_rml11_bf16.json")))


def test_macs_per_frame():
    m = vtcnn2.macs_per_frame(CFG)
    assert m == {"conv1": 2 * 126 * 256 * 3, "conv2": 124 * 80 * 512 * 3,
                 "dense1": 9920 * 256, "dense2": 256 * 11}
    assert sum(m.values()) == 17_972_992
    assert vtcnn2.ops_per_frame(CFG) == 35_945_984
    assert counts.ops_per_frame(CFG) == counts.ops_per_frame(BF16) == 35_945_984


def test_conv_stage_at_4096():
    ops, nbytes = vtcnn2.conv_stage_int8(CFG, 4096)
    assert ops == 2 * 4096 * (126 * 512 * 3 + 124 * 80 * 1536)     # ~126.4 G
    weights = 768 + 2 * 512 * 4 + 3 * 512 * 80 + 2 * 80 * 4
    assert nbytes == 4096 * 1024 + 4096 * 9920 + weights
    assert counts.kernel(CFG, "conv_stage_int8_v7", 4096) == (ops, nbytes)
    assert counts.roofline_ms(ops, nbytes, "int8") == pytest.approx(ops / 1979e12 * 1e3)
    assert counts.roofline_ms(ops, nbytes, "int8") == pytest.approx(0.0639, rel=2e-3)


def test_dense_at_4096():
    ops, nbytes = vtcnn2.dense_argmax_int8(CFG, 4096)
    assert ops == 2 * 4096 * (9920 * 256 + 256 * 11)
    assert nbytes == 4096 * 9920 + 4096 * 4 + 9920 * 256 + 2 * 256 * 4 + 256 * 11 + 2 * 11 * 4
    assert counts.kernel(CFG, "dense_argmax_int8", 4096) == (ops, nbytes)
    assert counts.roofline_ms(ops, nbytes, "int8") == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert counts.roofline_ms(ops, nbytes, "int8") == pytest.approx(0.0129, rel=1e-2)


def test_bf16_conv_stage_at_4096():
    """Row 15's bound in PERF.md's kernel table: 0.128 ms, by its
    operations at the bf16 peak."""
    ops, nbytes = counts.kernel(BF16, "conv_stage_bf16_v4", 4096)
    assert ops == 2 * 4096 * (126 * 512 * 3 + 124 * 80 * 1536)
    weights = 4 * 256 * 2 + 3 * 512 * 80 * 2 + 80 * 4
    assert nbytes == 4096 * 2 * 128 * 4 + 4096 * 9920 * 2 + weights
    assert counts.roofline_ms(ops, nbytes, "bfloat16") == pytest.approx(ops / 989e12 * 1e3)
    assert counts.roofline_ms(ops, nbytes, "bfloat16") == pytest.approx(0.128, rel=2e-3)


def test_bf16_dense_at_4096():
    """Row 16's bound in PERF.md's kernel table: 0.0258 ms, by its bytes."""
    ops, nbytes = counts.kernel(BF16, "dense_argmax_bf16", 4096)
    assert ops == 2 * 4096 * (9920 * 256 + 256 * 11)
    assert nbytes == (4096 * 9920 * 2 + 4096 * 4 + 9920 * 256 * 2 + 256 * 4
                      + 256 * 11 * 2 + 11 * 4)
    assert counts.roofline_ms(ops, nbytes, "bfloat16") == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert counts.roofline_ms(ops, nbytes, "bfloat16") == pytest.approx(0.0258, rel=1e-3)


@pytest.mark.parametrize("metric,cfg,traced,want_ms", [
    ("conv_stage_int8_v7_roofline", CFG,
     "void (anonymous namespace)::conv_stage_int8_v7_kernel<float const>(float const*, long)",
     2 * 16384 * (126 * 512 * 3 + 124 * 80 * 1536) / 1979e12 * 1e3),
    ("conv_stage_bf16_v4_roofline", BF16,
     "void (anonymous namespace)::conv_stage_bf16_kernel<0>(void const*, long long)",
     2 * 16384 * (126 * 512 * 3 + 124 * 80 * 1536) / 989e12 * 1e3),
    ("dense_argmax_bf16_roofline", BF16,
     "void (anonymous namespace)::dense_argmax_bf16_kernel<true>(CUtensorMap_st, long long)",
     (16384 * 9920 * 2 + 16384 * 4 + 9920 * 256 * 2 + 256 * 4 + 256 * 11 * 2 + 11 * 4)
     / 3.35e12 * 1e3),
])
def test_roofline_reader_at_the_configurations_peak(metric, cfg, traced, want_ms):
    """A reader finds its kernel's calls by name in the trace and holds them
    to the peak of the configuration's precision; the other entries of a
    kernel's body, and a window with none of its calls, read nothing."""
    from amc_bench import trace

    other = traced.replace("<0>", "<2>").replace("<true>", "<false>").replace("v7", "v10")
    ops = [trace.DeviceOp(traced, 0.0, 250.0, ""), trace.DeviceOp(traced, 300.0, 250.0, ""),
           trace.DeviceOp(other, 600.0, 5000.0, "")]
    ctx = types.SimpleNamespace(cell=types.SimpleNamespace(config=cfg), counts=counts,
                                frames_classified=2 * 16384,
                                summary=trace.Summary(window_s=1.0, busy_s=0.0055, ops=ops))
    assert spec.reader(metric)(ctx) == pytest.approx(100 * want_ms / 0.25)
    ctx.summary = trace.Summary(window_s=1.0, busy_s=0.005, ops=ops[2:])
    assert spec.reader(metric)(ctx) is None
