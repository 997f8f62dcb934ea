"""The deep residual classifier of O'Shea, Roy and Clancy, "Over-the-Air Deep
Learning Based Radio Signal Classification" (IEEE JSTSP 2018,
arXiv:1712.04578, Table III, Figs. 5-6), as a torch ``nn.Module``.

Input (B, 2, T) float I/Q frames (I channel 0, Q channel 1); at the
published widths T = 1024, 24 classes. Each of ``stacks`` residual stacks:

    h = conv_1x1(h)                        # linear, to ``filters`` channels
    h = h + conv_b(relu(conv_a(h)))        # residual unit, twice
    h = max_pool(h, pool)                  # window = stride = pool, along time

with width-``kernel`` convs, "same" zero padding and no activation after the
skip add. Then the (T / pool**stacks, filters) map is flattened time-major
(``t * filters + c``) into Dense(dense_units) SELU, Dense(dense_units) SELU,
Dense(num_classes). SELU uses lambda = 1.0507009873554805 and alpha =
1.6732632423543772 (``F.selu``); there is no dropout at inference.

The dtype policy is ``VTCNN2``'s: float32 parameters, compute in
``dtype``, float32 logits; and its initialisation, ``lecun_normal``
kernels (fan-in = width x input channels) from a seeded generator and zero
biases. At the published widths the model has 165,144 parameters and one
frame takes 25,938,944 multiply-accumulates (``macs_per_frame``).

The parameters are plain torch names and layouts (``stacks.<s>.proj``,
``stacks.<s>.units.<u>.conv_a`` / ``conv_b``: Conv1d weights (out, in, k);
``dense1..3``: Linear weights (out, in)); the checkpoint keeps them so
(``utils/checkpoint.py``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from modulationdetectioncnn_torch.config import ModelConfig
from modulationdetectioncnn_torch.models.vtcnn2 import _DTYPES, _lecun_normal_

ARCH = "resnet_rml18"


class _Unit(nn.Module):
    def __init__(self, filters: int, kernel: int):
        super().__init__()
        self.conv_a = nn.Conv1d(filters, filters, kernel, padding=kernel // 2)
        self.conv_b = nn.Conv1d(filters, filters, kernel, padding=kernel // 2)


class _Stack(nn.Module):
    def __init__(self, in_channels: int, filters: int, kernel: int):
        super().__init__()
        self.proj = nn.Conv1d(in_channels, filters, 1)
        self.units = nn.ModuleList([_Unit(filters, kernel) for _ in range(2)])


class ResNetRML18(nn.Module):
    """Residual stacks -> Dense SELU -> Dense SELU -> Dense; (B, 2, T) ->
    (B, num_classes) float32 logits."""

    def __init__(self, num_classes: int = 24, stacks: int = 6, filters: int = 32,
                 kernel: int = 3, pool: int = 2, dense_units: int = 128,
                 dtype: str | torch.dtype = "bfloat16", frame_len: int = 1024,
                 generator: torch.Generator | None = None):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError(f"kernel {kernel}: 'same' padding needs an odd width")
        if frame_len % pool ** stacks:
            raise ValueError(f"frame_len {frame_len} is not a multiple of "
                             f"pool**stacks = {pool ** stacks}")
        self.dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.pool = pool
        self.stacks = nn.ModuleList([_Stack(2 if s == 0 else filters, filters, kernel)
                                     for s in range(stacks)])
        flat = (frame_len // pool ** stacks) * filters
        self.dense1 = nn.Linear(flat, dense_units)
        self.dense2 = nn.Linear(dense_units, dense_units)
        self.dense3 = nn.Linear(dense_units, num_classes)
        self.reset_parameters(generator)

    @classmethod
    def from_config(cls, cfg: ModelConfig, frame_len: int = 1024,
                    generator: torch.Generator | None = None) -> "ResNetRML18":
        if cfg.arch != ARCH:
            raise ValueError(f"model.arch={cfg.arch!r} is not {ARCH!r}")
        return cls(num_classes=cfg.num_classes, dtype=cfg.dtype, frame_len=frame_len,
                   generator=generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """``lecun_normal`` kernels (fan-in = width x input channels), zero
        biases, drawn in the order of ``named_parameters``."""
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear)):
                w = m.weight
                _lecun_normal_(w, w.shape[1] * (w.shape[2] if w.dim() == 3 else 1), generator)
                nn.init.zeros_(m.bias)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 2, T) -> the last stack's (B, T / pool**stacks, filters) map in
        the compute dtype."""
        dt = self.dtype

        def conv(h, layer):
            return F.conv1d(h, layer.weight.to(dt), layer.bias.to(dt),
                            padding=layer.padding)

        h = x.to(dt)
        for stack in self.stacks:
            h = conv(h, stack.proj)
            for unit in stack.units:
                h = h + conv(F.relu(conv(h, unit.conv_a)), unit.conv_b)
            h = F.max_pool1d(h, self.pool)
        return h.transpose(1, 2)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The (B, T', filters) map -> (B, C) float32 logits: flattened
        time-major, Dense SELU, Dense SELU, Dense, in the compute dtype."""
        dt = self.dtype
        h = h.to(dt).flatten(1)
        h = F.selu(F.linear(h, self.dense1.weight.to(dt), self.dense1.bias.to(dt)))
        h = F.selu(F.linear(h, self.dense2.weight.to(dt), self.dense2.bias.to(dt)))
        return F.linear(h, self.dense3.weight.to(dt), self.dense3.bias.to(dt)).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))


def macs_per_frame(frame_len: int = 1024, stacks: int = 6, filters: int = 32,
                   kernel: int = 3, pool: int = 2, dense_units: int = 128,
                   num_classes: int = 24) -> dict[str, int]:
    """Multiply-accumulates of one frame, by part: the stacks' convs, the
    dense head."""
    conv, t, cin = 0, frame_len, 2
    for _ in range(stacks):
        conv += t * cin * filters + 4 * t * filters * filters * kernel
        t, cin = t // pool, filters
    dense = t * filters * dense_units + dense_units * dense_units + dense_units * num_classes
    return {"stacks": conv, "head": dense}
