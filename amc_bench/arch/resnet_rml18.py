"""The deep residual classifier of O'Shea, Roy and Clancy (IEEE JSTSP 2018,
arXiv:1712.04578, Table III): its published widths, its plain reference
(``reference/resnet_rml18.py``), its operations and bytes, and its
lower-precision control (the interface in ``arch/__init__.py``).

The counts are worked out from the widths a configuration file states,
never read from the program, so a later change to the program cannot move
them.
"""
from __future__ import annotations

import torch

from amc_bench.reference.common import first_argmax
from amc_bench.reference.resnet_rml18 import ResNetModel

PUBLISHED = {"frame_len": 1024, "stacks": 6, "filters": 32, "kernel": 3, "pool": 2,
             "dense_units": 128, "num_classes": 24}


def reference(config: dict, path: str, device):
    """The float checkpoint's forward in float32 with TF32 off."""
    return ResNetModel(path, device)


def macs_per_frame(cfg: dict) -> dict[str, int]:
    """Multiply-accumulates of one 2 x T frame, by part: the stacks (each a
    1x1 conv to ``filters``, then four width-``kernel`` convs, at the
    stack's length, which each pool divides) and the dense head."""
    t, cin, f, k = cfg["frame_len"], 2, cfg["filters"], cfg["kernel"]
    stacks = 0
    for _ in range(cfg["stacks"]):
        stacks += t * cin * f + 4 * t * f * f * k
        t, cin = t // cfg["pool"], f
    d = cfg["dense_units"]
    return {"stacks": stacks, "head": t * f * d + d * d + d * cfg["num_classes"]}


def ops_per_frame(cfg: dict) -> int:
    """Operations (2 per multiply-accumulate) of one frame's forward pass."""
    return 2 * sum(macs_per_frame(cfg).values())


def residual_chain_bf16(cfg: dict, batch: int) -> tuple[int, int]:
    """(operations, bytes) of the fused residual chain on ``batch`` frames:
    every stack's convs; frames in as float32, the last stack's pooled
    (T / pool**stacks, filters) map out in bf16, and the stacks' weights in
    bf16 with their float32 biases read once."""
    s, f, k = cfg["stacks"], cfg["filters"], cfg["kernel"]
    t_out = cfg["frame_len"] // cfg["pool"] ** s
    weights = (2 * f + (s - 1) * f * f + 4 * s * f * f * k) * 2 + 5 * s * f * 4
    ops = 2 * batch * macs_per_frame(cfg)["stacks"]
    return ops, batch * 2 * cfg["frame_len"] * 4 + batch * t_out * f * 2 + weights


KERNELS = {"residual_chain_bf16": residual_chain_bf16}


def fp8_e4m3_control(system, cell):
    """The reference with every weight and every layer's input rounded to
    float8 e4m3, as the classifier."""
    model = ResNetModel(cell.path(cell.config["weights"]), system.cfg.device, fp8=True)
    return lambda x: first_argmax(model.logits(x)).to(torch.int32)


CONTROLS = {"bfloat16": {"fp8_e4m3": fp8_e4m3_control}}
