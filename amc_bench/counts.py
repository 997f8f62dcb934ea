"""The yardstick's arithmetic: peaks, and the least time of a call.

Operations and bytes come from the configuration's architecture
(``arch/<architecture>.py``: ``ops_per_frame`` and ``KERNELS``), worked out
from the widths its file states, never read from the program. Peaks are
NVIDIA's data-sheet numbers for one H100 SXM (dense, no sparsity, at its
700 W power limit).
"""
from __future__ import annotations

from amc_bench import spec

# Data-sheet peaks of one H100 SXM, by the precision a configuration states.
PEAK_OPS_PER_S = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}
PEAK_HBM_BYTES_PER_S = 3.35e12


def ops_per_frame(cfg: dict) -> int:
    """Operations of one frame's forward pass through the configuration's
    architecture."""
    return spec.architecture(cfg).ops_per_frame(cfg)


def kernel(cfg: dict, name: str, batch: int) -> tuple[int, int]:
    """(operations, bytes) of one call of the architecture's kernel ``name``
    on ``batch`` frames."""
    return spec.architecture(cfg).KERNELS[name](cfg, batch)


def roofline_ms(ops: int, nbytes: int, precision: str) -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate of ``precision`` and the bytes at the HBM bandwidth, in
    milliseconds."""
    return 1e3 * max(ops / PEAK_OPS_PER_S[precision], nbytes / PEAK_HBM_BYTES_PER_S)
