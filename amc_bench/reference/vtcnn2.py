"""Plain reference of the VT-CNN2 classifier (O'Shea, Corgan and Clancy 2016):
Conv 1x3 -> ReLU -> Conv 2x3 -> ReLU -> Dense -> ReLU -> Dense, valid padding,
on (B, 2, T) I/Q frames.

Two forms, each from the committed ``.npz`` files alone:

- ``Int8Model``: the integer chain of the deployed artifact. Frames are
  quantized as ``clip(round_half_even(x * f32(1 / s_x)), -127, 127)`` (one
  float32 product), every layer's int32 sum is requantized as
  ``clip((acc + offset) >> shift, 0, 127)`` per channel, and the logits are
  ``float32(acc4) * s4 + b4`` (two float32 roundings); the label is the first
  largest logit. Integer products run as float64 matrix products, exact while
  every partial sum stays below 2**53 (here below 2**25).
- ``FloatModel``: the float checkpoint's forward in float32 with TF32 off.

Plain torch and NumPy only.
"""
from __future__ import annotations

import numpy as np
import torch

from amc_bench.reference.common import first_argmax, tf32

BLOCK = 2048            # frames a block: bounds the reference's own memory


def _requant(acc: torch.Tensor, shift: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_right_shift(acc + offset, shift).clamp(0, 127)


class Int8Model:
    """The integer chain of an int8 artifact (``.npz`` with s_x, w1p, m1,
    o1, w2p, m2, o2, w3, m3, o3, w4, s4, b4). ``weight_bits`` below 8 rounds
    every weight to that many bits (the same scale, a coarser grid): the
    lower-precision control."""

    def __init__(self, path: str, device, weight_bits: int = 8):
        with np.load(path) as z:
            a = {k: z[k] for k in z.files}
        self.device = torch.device(device)
        self.inv_sx = torch.tensor(np.float32(1.0 / np.float64(np.float32(a["s_x"]))),
                                   device=self.device)
        step = 2 ** (8 - weight_bits)
        lim = 2 ** (weight_bits - 1)

        def w(name):
            q = np.clip(np.round(a[name].astype(np.float64) / step), -lim, lim - 1) * step
            return torch.tensor(q, dtype=torch.float64, device=self.device)

        def i32(name):
            return torch.tensor(a[name].astype(np.int64), device=self.device)

        self.w1, self.w2, self.w3, self.w4 = w("w1p"), w("w2p"), w("w3"), w("w4")
        self.m1, self.o1, self.m2, self.o2 = i32("m1"), i32("o1"), i32("m2"), i32("o2")
        self.m3, self.o3 = i32("m3"), i32("o3")
        self.s4 = torch.tensor(a["s4"], dtype=torch.float32, device=self.device)
        self.b4 = torch.tensor(a["b4"], dtype=torch.float32, device=self.device)
        self.c2 = a["m2"].shape[0]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.device, torch.float32)
        xq = torch.round(x * self.inv_sx).clamp(-127, 127).to(torch.float64)
        t1 = x.shape[-1] - 2
        # conv1 per I/Q row, stacked as channel h * C1 + c
        acc1 = torch.cat([sum(xq[:, h, k:k + t1, None] * self.w1[k] for k in range(3))
                          for h in range(2)], dim=-1)
        a1 = _requant(acc1.to(torch.int64), self.m1, self.o1).to(torch.float64)
        z = a1 @ self.w2                                     # (B, t1, 3 * C2)
        c2, t2 = self.c2, t1 - 2
        acc2 = z[:, 0:t2, :c2] + z[:, 1:t2 + 1, c2:2 * c2] + z[:, 2:t2 + 2, 2 * c2:]
        a2 = _requant(acc2.to(torch.int64), self.m2, self.o2).to(torch.float64)
        a3 = _requant((a2.reshape(x.shape[0], -1) @ self.w3).to(torch.int64),
                      self.m3, self.o3).to(torch.float64)
        acc4 = (a3 @ self.w4).to(torch.float32)
        return acc4 * self.s4 + self.b4

    def labels(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 2, T) float32 frames -> (B,) int64 labels, in blocks."""
        return torch.cat([first_argmax(self._logits(x[i:i + BLOCK]))
                          for i in range(0, x.shape[0], BLOCK)])


class FloatModel:
    """The float checkpoint's forward (``params.npz`` with the Flax names
    Conv1, Conv2, Dense1, Dense2 / kernel, bias) in float32, TF32 off."""

    def __init__(self, path: str, device):
        with np.load(path) as z:
            a = {k: z[k] for k in z.files}
        self.device = torch.device(device)

        def t(name):
            return torch.tensor(a[name], dtype=torch.float32, device=self.device)

        self.k1 = t("Conv1/kernel")[0, :, 0, :]          # (3, C1): tap, filter
        self.b1 = t("Conv1/bias")
        k2 = t("Conv2/kernel")                           # (2, 3, C1, C2)
        self.k2 = k2.permute(1, 0, 2, 3).reshape(3, -1, k2.shape[-1])  # tap, h*C1+c, co
        self.b2 = t("Conv2/bias")
        self.k3, self.b3 = t("Dense1/kernel"), t("Dense1/bias")
        self.k4, self.b4 = t("Dense2/kernel"), t("Dense2/bias")

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.device, torch.float32)
        t1 = x.shape[-1] - 2
        a1 = torch.cat([torch.relu(sum(x[:, h, k:k + t1, None] * self.k1[k]
                                       for k in range(3)) + self.b1) for h in range(2)],
                       dim=-1)                           # (B, t1, 2 * C1)
        t2 = t1 - 2
        a2 = torch.relu(sum(a1[:, k:k + t2] @ self.k2[k] for k in range(3)) + self.b2)
        a3 = torch.relu(a2.reshape(x.shape[0], -1) @ self.k3 + self.b3)
        return a3 @ self.k4 + self.b4

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 2, T) frames -> (B, classes) float32 logits, in blocks."""
        with tf32(False):
            return torch.cat([self._logits(x[i:i + BLOCK])
                              for i in range(0, x.shape[0], BLOCK)])
