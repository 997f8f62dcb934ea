"""Roofline accounting for the port.

Counterpart of ``modulationdetectioncnn_tpu/utils/profiler.py`` with the
NVIDIA H100 SXM's data-sheet peaks (dense, no sparsity, at the 700 W power
limit): 989 TFLOP/s bf16 and 1,979 TOP/s int8. A card set below 700 W
(``nvidia-smi --query-gpu=power.limit``) runs below them.
"""
from __future__ import annotations

from dataclasses import dataclass

H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_INT8_OPS = 1979e12

# VT-CNN2 per-frame multiply-accumulates: conv1 0.39M (2 rows), conv2
# 15.2M, dense1 2.54M, dense2 2.8K.
MACS_PER_FRAME = 18_127_696
SAMPLES_PER_FRAME = 128


@dataclass
class Roofline:
    samples_per_sec: float
    ops_per_sec: float
    pct_of_bf16_peak: float
    pct_of_int8_peak: float

    def as_dict(self):
        return {
            "samples_per_sec": round(self.samples_per_sec),
            "tops_per_sec": round(self.ops_per_sec / 1e12, 2),
            "pct_of_bf16_peak": round(self.pct_of_bf16_peak, 1),
            "pct_of_int8_peak": round(self.pct_of_int8_peak, 1),
            "peaks": "H100 SXM data sheet: 989 TFLOP/s bf16, 1979 TOP/s int8",
        }


def roofline(samples_per_sec: float) -> Roofline:
    ops = samples_per_sec / SAMPLES_PER_FRAME * MACS_PER_FRAME * 2
    return Roofline(
        samples_per_sec=samples_per_sec,
        ops_per_sec=ops,
        pct_of_bf16_peak=100 * ops / H100_PEAK_BF16_FLOPS,
        pct_of_int8_peak=100 * ops / H100_PEAK_INT8_OPS,
    )
