"""Plain PyTorch integer spec shared by the int8 kernels' plain versions.

Counterparts of ``modulationdetectioncnn_tpu/ops/cnn_kernels.py::requantize``
(``relu=True``, the only form on the int8 hot path) and
``golden/quant.py::quantize_input``. The CUDA kernels implement the same
arithmetic and are held against these bit for bit.
"""
from __future__ import annotations

import torch


def requantize(acc: torch.Tensor, shift: torch.Tensor,
               offset: torch.Tensor) -> torch.Tensor:
    """Per-channel fixed-point int32 -> int8:
    ``clip((acc + offset) >> shift, 0, 127)`` with an arithmetic shift (it
    floors negatives, which the 0 clip then sends to 0, as a ReLU would).
    ``offset`` already folds the bias and the +0.5 rounding term."""
    v = torch.bitwise_right_shift(acc.to(torch.int32) + offset, shift)
    return v.clamp(0, 127).to(torch.int8)


def quantize_input(x: torch.Tensor, inv_sx: float) -> torch.Tensor:
    """f32 -> int8: ``clip(round_half_even(x * inv_sx), -127, 127)``.

    A multiply by the f32 reciprocal, never a divide: the JAX kernels do the
    same, and dividing differs by 1 LSB at rounding boundaries."""
    return torch.round(x.to(torch.float32) * inv_sx).clamp(-127, 127).to(torch.int8)
