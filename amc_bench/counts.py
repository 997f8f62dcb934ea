"""The yardstick's arithmetic: operations and bytes from shapes, and peaks.

Everything here is worked out from the VT-CNN2 widths a configuration file
states, never read from the program, so a later change to the program cannot
move it. Peaks are NVIDIA's data-sheet numbers for one H100 SXM (dense, no
sparsity, at its 700 W power limit).
"""
from __future__ import annotations

# Data-sheet peaks of one H100 SXM, by the precision a configuration states.
PEAK_OPS_PER_S = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}
PEAK_HBM_BYTES_PER_S = 3.35e12


def widths(cfg: dict) -> tuple[int, int, int, int, int]:
    """(frame length, conv1 filters, conv2 filters, dense units, classes)."""
    return (cfg["frame_len"], cfg["conv1_filters"], cfg["conv2_filters"],
            cfg["dense_units"], cfg["num_classes"])


def macs_per_frame(cfg: dict) -> dict[str, int]:
    """Multiply-accumulates of one 2 x T frame through VT-CNN2, by layer:
    conv1 (1x3, both I/Q rows), conv2 (2x3 over the two rows), dense1 over
    the flattened (T-4) x C2 map, dense2."""
    t, c1, c2, d, nc = widths(cfg)
    t1, t2 = t - 2, t - 4
    return {"conv1": 2 * t1 * c1 * 3, "conv2": t2 * c2 * 2 * c1 * 3,
            "dense1": t2 * c2 * d, "dense2": d * nc}


def model_ops_per_frame(cfg: dict) -> int:
    """Operations (2 per multiply-accumulate) of one frame's forward pass."""
    return 2 * sum(macs_per_frame(cfg).values())


def conv_stage_int8(cfg: dict, batch: int) -> tuple[int, int]:
    """(operations, bytes) of the fused int8 conv stage on ``batch`` frames:
    conv1 and conv2; frames in as float32, the (T-4, C2) int8 map out, and
    the int8 weights with their int32 shifts and offsets read once."""
    t, c1, c2, _, _ = widths(cfg)
    m = macs_per_frame(cfg)
    ops = 2 * batch * (m["conv1"] + m["conv2"])
    weights = 3 * c1 + 2 * (2 * c1) * 4 + 3 * 2 * c1 * c2 + 2 * c2 * 4
    return ops, batch * 2 * t * 4 + batch * (t - 4) * c2 + weights


def dense_argmax_int8(cfg: dict, batch: int) -> tuple[int, int]:
    """(operations, bytes) of the fused int8 dense + argmax stage on
    ``batch`` frames: the int8 map in, the int32 labels out, dense1's and
    dense2's int8 weights, their int32 shifts and offsets and the float32
    dequantize scale and bias read once."""
    t, _, c2, d, nc = widths(cfg)
    m = macs_per_frame(cfg)
    ops = 2 * batch * (m["dense1"] + m["dense2"])
    weights = (t - 4) * c2 * d + 2 * d * 4 + d * nc + 2 * nc * 4
    return ops, batch * (t - 4) * c2 + batch * 4 + weights


KERNEL_COUNTS = {"conv_stage_int8_v7": conv_stage_int8,
                 "dense_argmax_int8": dense_argmax_int8}


def roofline_ms(ops: int, nbytes: int, precision: str = "int8") -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate and the bytes at the HBM bandwidth, in milliseconds."""
    return 1e3 * max(ops / PEAK_OPS_PER_S[precision], nbytes / PEAK_HBM_BYTES_PER_S)
