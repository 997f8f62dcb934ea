"""VT-CNN2-family conv-conv-dense model as a torch ``nn.Module``.

Counterpart of ``modulationdetectioncnn_tpu/models/vtcnn2.py`` (Flax): the
same topology, parameter names and dtype policy (parameters fp32, compute
in ``cfg.model.dtype``, logits fp32), and the same initialisation as Flax
(``lecun_normal`` kernels, zero biases), so that the int8 quantizer sees a
random model at the scale its fixed-point contract was written for.

Dropout (train mode only) draws its keep masks with ``torch.rand`` from
the generator passed to ``forward``, or from torch's global generator when
none is given; the training loop passes its own seeded generator, so a run
is reproducible from its seed (Flax draws them from the ``dropout`` key).

Layouts: the module keeps torch's own (conv weights OIHW, activations NCHW,
``nn.Linear`` weights (out, in)). ``params_from_flax`` and ``flax_params``
carry a Flax parameter tree across in both directions. Flax flattens the
conv2 map (B, 1, 124, 80) NHWC in the order t*80 + c; this module permutes
its NCHW activation to (B, 1, 124, 80) before the flatten, so Dense1's
weight keeps the Flax row order and the carry is a plain transpose.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from modulationdetectioncnn_torch.config import ModelConfig

# The std of a unit normal truncated to [-2, 2] (Flax's variance_scaling
# divides by it so the truncated draw keeps variance scale / fan_in).
_TRUNC_STD = 0.87962566103423978

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator | None):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class VTCNN2(nn.Module):
    """Conv(f1,(1,3))+ReLU -> Conv(f2,(2,3))+ReLU -> Dense(d)+ReLU -> Dense(C).

    Input: (B, 2, T) float I/Q frames (I row 0, Q row 1). Valid padding:
    T=128 -> conv1 width 126 -> conv2 width 124 -> flatten 124*f2.
    Dropout after each hidden layer in train mode.
    """

    def __init__(self, num_classes: int = 11, conv1_filters: int = 256,
                 conv2_filters: int = 80, dense_units: int = 256,
                 dropout_rate: float = 0.5, dtype: str | torch.dtype = "bfloat16",
                 frame_len: int = 128, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.dropout_rate = dropout_rate
        t2 = frame_len - 4
        self.conv1 = nn.Conv2d(1, conv1_filters, (1, 3))
        self.conv2 = nn.Conv2d(conv1_filters, conv2_filters, (2, 3))
        self.dense1 = nn.Linear(t2 * conv2_filters, dense_units)
        self.dense2 = nn.Linear(dense_units, num_classes)
        self.reset_parameters(generator)

    @classmethod
    def from_config(cls, cfg: ModelConfig, frame_len: int = 128,
                    generator: torch.Generator | None = None) -> "VTCNN2":
        """The VT-CNN2 of ``cfg``; ValueError for a configuration of another
        architecture (``cfg.arch``), which is not trained, quantized or
        measured as a VT-CNN2 in its place."""
        if cfg.arch != "vtcnn2":
            raise ValueError(f"model.arch={cfg.arch!r}: this path builds a VT-CNN2 "
                             "(model.arch=vtcnn2) only")
        return cls(num_classes=cfg.num_classes, conv1_filters=cfg.conv1_filters,
                   conv2_filters=cfg.conv2_filters, dense_units=cfg.dense_units,
                   dropout_rate=cfg.dropout_rate, dtype=cfg.dtype,
                   frame_len=frame_len, generator=generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax's defaults: lecun_normal kernels (fan_in = receptive field x
        input channels), zero biases."""
        for layer in (self.conv1, self.conv2, self.dense1, self.dense2):
            w = layer.weight
            fan_in = w.shape[1] * (w.shape[2] * w.shape[3] if w.dim() == 4 else 1)
            _lecun_normal_(w, fan_in, generator)
            nn.init.zeros_(layer.bias)

    def _layer(self, fn, h, layer, **kw):
        dt = self.dtype
        return fn(h, layer.weight.to(dt), layer.bias.to(dt), **kw)

    def forward(self, x: torch.Tensor,
                intermediates: dict[str, torch.Tensor] | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, 2, T) -> (B, C) fp32 logits. When ``intermediates`` is a dict,
        the pre-ReLU outputs of Conv1, Conv2 and Dense1 are stored in it (as
        Flax's ``capture_intermediates`` returns them). ``generator`` draws
        the dropout masks in train mode."""
        keep = intermediates if intermediates is not None else {}
        rate = self.dropout_rate if self.training else 0.0
        h = x.to(self.dtype)[:, None]                         # (B, 1, 2, T)
        h = self._layer(F.conv2d, h, self.conv1)              # (B, f1, 2, T-2)
        keep["Conv1"] = h
        h = dropout(F.relu(h), rate, generator)
        # conv2's kernel spans both rows: a 1-D conv over the 2*f1 stacked
        # channels (c*2 + row), the same sums, faster than conv2d on the CPU.
        h = F.conv1d(h.flatten(1, 2), self.conv2.weight.to(self.dtype).flatten(1, 2),
                     self.conv2.bias.to(self.dtype))[:, :, None]  # (B, f2, 1, T-4)
        keep["Conv2"] = h
        h = dropout(F.relu(h), rate, generator)
        h = h.permute(0, 2, 3, 1).flatten(1)                  # t*f2 + c order
        h = self._layer(F.linear, h, self.dense1)
        keep["Dense1"] = h
        h = dropout(F.relu(h), rate, generator)
        h = self._layer(F.linear, h, self.dense2)
        return h.to(torch.float32)


def dropout(h: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout as Flax's ``nn.Dropout``: keep each element with
    probability ``1 - rate`` (a uniform draw from ``generator`` below it)
    and scale it by ``1 / (1 - rate)``, in ``h``'s dtype. Identity at rate 0."""
    if rate == 0.0:
        return h
    keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - rate
    return torch.where(keep, h / (1.0 - rate), torch.zeros((), dtype=h.dtype, device=h.device))


def params_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax param tree (``{"params": {...}}`` or its inner dict, arrays as
    NumPy) -> a ``VTCNN2`` state dict. Conv kernels HWIO -> OIHW; Dense
    kernels (in, out) -> (out, in), rows kept in the Flax t*80+c order."""
    p = tree.get("params", tree)

    def t(a, *perm):  # a writable, contiguous fp32 copy
        return torch.from_numpy(np.array(np.asarray(a).transpose(*perm), np.float32))

    return {
        "conv1.weight": t(p["Conv1"]["kernel"], 3, 2, 0, 1),
        "conv1.bias": t(p["Conv1"]["bias"], 0),
        "conv2.weight": t(p["Conv2"]["kernel"], 3, 2, 0, 1),
        "conv2.bias": t(p["Conv2"]["bias"], 0),
        "dense1.weight": t(p["Dense1"]["kernel"], 1, 0),
        "dense1.bias": t(p["Dense1"]["bias"], 0),
        "dense2.weight": t(p["Dense2"]["kernel"], 1, 0),
        "dense2.bias": t(p["Dense2"]["bias"], 0),
    }


def flax_params(model: VTCNN2 | Mapping[str, torch.Tensor]
                ) -> dict[str, dict[str, np.ndarray]]:
    """The inverse of ``params_from_flax``: the fp32 parameters of a model
    or of its state dict as a Flax-layout NumPy tree (what the JAX
    package's quantizer reads)."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    sd = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in state.items()}
    return {
        "Conv1": {"kernel": sd["conv1.weight"].transpose(2, 3, 1, 0),
                  "bias": sd["conv1.bias"]},
        "Conv2": {"kernel": sd["conv2.weight"].transpose(2, 3, 1, 0),
                  "bias": sd["conv2.bias"]},
        "Dense1": {"kernel": sd["dense1.weight"].T, "bias": sd["dense1.bias"]},
        "Dense2": {"kernel": sd["dense2.weight"].T, "bias": sd["dense2.bias"]},
    }
