"""The op and byte counts against hand-worked shapes."""
import json
import os

import pytest

from amc_bench import counts, spec

CFG = json.load(open(os.path.join(spec.HERE, "configs", "vtcnn2_rml11_int8.json")))


def test_macs_per_frame():
    m = counts.macs_per_frame(CFG)
    assert m == {"conv1": 2 * 126 * 256 * 3, "conv2": 124 * 80 * 512 * 3,
                 "dense1": 9920 * 256, "dense2": 256 * 11}
    assert sum(m.values()) == 17_972_992
    assert counts.model_ops_per_frame(CFG) == 35_945_984


def test_conv_stage_at_4096():
    ops, nbytes = counts.conv_stage_int8(CFG, 4096)
    assert ops == 2 * 4096 * (126 * 512 * 3 + 124 * 80 * 1536)     # ~126.4 G
    weights = 768 + 2 * 512 * 4 + 3 * 512 * 80 + 2 * 80 * 4
    assert nbytes == 4096 * 1024 + 4096 * 9920 + weights
    assert counts.roofline_ms(ops, nbytes) == pytest.approx(ops / 1979e12 * 1e3)
    assert counts.roofline_ms(ops, nbytes) == pytest.approx(0.0639, rel=2e-3)


def test_dense_at_4096():
    ops, nbytes = counts.dense_argmax_int8(CFG, 4096)
    assert ops == 2 * 4096 * (9920 * 256 + 256 * 11)
    assert nbytes == 4096 * 9920 + 4096 * 4 + 9920 * 256 + 2 * 256 * 4 + 256 * 11 + 2 * 11 * 4
    assert counts.roofline_ms(ops, nbytes) == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert counts.roofline_ms(ops, nbytes) == pytest.approx(0.0129, rel=1e-2)
