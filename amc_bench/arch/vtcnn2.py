"""VT-CNN2 (O'Shea, Corgan and Clancy 2016, arXiv:1602.04105): its published
widths, its plain reference (``reference/vtcnn2.py``), its operations and
bytes, and its lower-precision controls (the interface in ``arch/__init__.py``).

The counts are worked out from the widths a configuration file states,
never read from the program, so a later change to the program cannot move
them.
"""
from __future__ import annotations

import torch

from amc_bench.reference.vtcnn2 import FloatModel, Int8Model

PUBLISHED = {"frame_len": 128, "conv1_filters": 256, "conv1_kernel": [1, 3],
             "conv2_filters": 80, "conv2_kernel": [2, 3], "dense_units": 256,
             "num_classes": 11}


def reference(config: dict, path: str, device):
    """The integer chain of an int8 artifact, or the float checkpoint's
    forward in float32 with TF32 off."""
    if config["precision"] == "int8":
        return Int8Model(path, device)
    return FloatModel(path, device)


def widths(cfg: dict) -> tuple[int, int, int, int, int]:
    """(frame length, conv1 filters, conv2 filters, dense units, classes)."""
    return (cfg["frame_len"], cfg["conv1_filters"], cfg["conv2_filters"],
            cfg["dense_units"], cfg["num_classes"])


def macs_per_frame(cfg: dict) -> dict[str, int]:
    """Multiply-accumulates of one 2 x T frame, by layer: conv1 (1x3, both
    I/Q rows), conv2 (2x3 over the two rows), dense1 over the flattened
    (T-4) x C2 map, dense2."""
    t, c1, c2, d, nc = widths(cfg)
    t1, t2 = t - 2, t - 4
    return {"conv1": 2 * t1 * c1 * 3, "conv2": t2 * c2 * 2 * c1 * 3,
            "dense1": t2 * c2 * d, "dense2": d * nc}


def ops_per_frame(cfg: dict) -> int:
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


def conv_stage_bf16_v4(cfg: dict, batch: int) -> tuple[int, int]:
    """(operations, bytes) of the fused bf16 conv stage (v4) on ``batch``
    frames: conv1 and conv2; frames in as float32, the (T-4, C2) bf16 map
    out, and conv1's taps and bias and conv2's weight in bf16 with conv2's
    float32 bias read once."""
    t, c1, c2, _, _ = widths(cfg)
    m = macs_per_frame(cfg)
    ops = 2 * batch * (m["conv1"] + m["conv2"])
    weights = (3 + 1) * c1 * 2 + 3 * 2 * c1 * c2 * 2 + c2 * 4
    return ops, batch * 2 * t * 4 + batch * (t - 4) * c2 * 2 + weights


def dense_argmax_bf16(cfg: dict, batch: int) -> tuple[int, int]:
    """(operations, bytes) of the fused bf16 dense + argmax stage on
    ``batch`` frames: the bf16 map in, the int32 labels out, dense1's and
    dense2's bf16 weights and their float32 biases read once."""
    t, _, c2, d, nc = widths(cfg)
    m = macs_per_frame(cfg)
    ops = 2 * batch * (m["dense1"] + m["dense2"])
    weights = (t - 4) * c2 * d * 2 + d * 4 + d * nc * 2 + nc * 4
    return ops, batch * (t - 4) * c2 * 2 + batch * 4 + weights


KERNELS = {"conv_stage_int8_v7": conv_stage_int8,
           "dense_argmax_int8": dense_argmax_int8,
           "conv_stage_bf16_v4": conv_stage_bf16_v4,
           "dense_argmax_bf16": dense_argmax_bf16}


def int4_control(system, cell):
    """The integer chain with every weight rounded to 4 bits, as the
    classifier."""
    model = Int8Model(cell.path(cell.config["weights"]), system.cfg.device, weight_bits=4)
    return lambda x: model.labels(x).to(torch.int32)


def int8_path_control(system, cell):
    """The program's own int8 path: the committed artifact on the v7
    kernels, as the classifier."""
    from modulationdetectioncnn_torch.ops.infer import make_int8_predict
    from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, load_int8

    return make_int8_predict(load_int8(DEFAULT_ARTIFACT, system.cfg.device), "v7")


CONTROLS = {"int8": {"int4": int4_control},
            "bfloat16": {"int8_path": int8_path_control}}
