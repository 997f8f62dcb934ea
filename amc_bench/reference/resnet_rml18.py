"""Plain reference of the residual classifier of O'Shea, Roy and Clancy
(IEEE JSTSP 2018, arXiv:1712.04578, Table III) on (B, 2, T) I/Q frames, from
the committed ``params.npz`` alone (Conv1d weights (out, in, k) and Linear
weights (out, in) under ``stacks.<s>.proj``, ``stacks.<s>.units.<u>.conv_a``
/ ``conv_b`` and ``dense1..3``), float32 with TF32 off:

    per stack:  h = h W_proj^T + b                       (1x1, linear)
                h = h + conv_b(relu(conv_a(h)))          (twice; width 3, zero "same" padding)
                h = max(h[2t], h[2t+1])                  (max-pool 2)
    then        flatten t * C + c, SELU(Dense), SELU(Dense), Dense

with SELU lambda = 1.0507009873554805, alpha = 1.6732632423543772, no
dropout. A conv of width 3 is the sum of its taps' matrix products on the
shifted map. ``fp8=True`` rounds every weight and every layer's input to
float8 e4m3 (saturating at +-448), the lower-precision control. Plain torch
and NumPy only.
"""
from __future__ import annotations

import numpy as np
import torch

from amc_bench.reference.common import tf32

BLOCK = 1024            # frames a block: bounds the reference's own memory
SELU_LAMBDA = 1.0507009873554805
SELU_ALPHA = 1.6732632423543772
E4M3_MAX = 448.0


def _e4m3(t: torch.Tensor) -> torch.Tensor:
    return t.clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).to(torch.float32)


def _selu(x: torch.Tensor) -> torch.Tensor:
    return SELU_LAMBDA * torch.where(x > 0, x, SELU_ALPHA * torch.expm1(x))


class ResNetModel:
    """The float checkpoint's forward; ``logits(x)`` in blocks."""

    def __init__(self, path: str, device, fp8: bool = False):
        with np.load(path) as z:
            a = {k: z[k] for k in z.files}
        self.device = torch.device(device)
        self.round = _e4m3 if fp8 else (lambda t: t)

        def t(name):
            return self.round(torch.tensor(a[name], dtype=torch.float32, device=self.device))

        n_stacks = len({k.split(".")[1] for k in a if k.startswith("stacks.")})
        self.stacks = []
        for s in range(n_stacks):
            p = f"stacks.{s}."
            convs = [(t(f"{p}units.{u}.{c}.weight").permute(2, 1, 0),   # (k, in, out)
                      t(f"{p}units.{u}.{c}.bias")) for u in range(2) for c in ("conv_a", "conv_b")]
            self.stacks.append((t(p + "proj.weight")[:, :, 0].T, t(p + "proj.bias"), convs))
        self.dense = [(t(f"dense{i}.weight").T, t(f"dense{i}.bias")) for i in (1, 2, 3)]

    def _conv(self, h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        k, t = w.shape[0], h.shape[1]
        hp = torch.nn.functional.pad(self.round(h), (0, 0, k // 2, k // 2))
        return sum(hp[:, j:j + t] @ w[j] for j in range(k)) + b

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.device, torch.float32).transpose(1, 2)          # (B, T, 2)
        for wp, bp, convs in self.stacks:
            h = self.round(h) @ wp + bp
            for u in range(2):
                (wa, ba), (wb, bb) = convs[2 * u], convs[2 * u + 1]
                h = h + self._conv(torch.relu(self._conv(h, wa, ba)), wb, bb)
            h = torch.maximum(h[:, 0::2], h[:, 1::2])
        h = h.reshape(h.shape[0], -1)                                   # t * C + c
        (w1, b1), (w2, b2), (w3, b3) = self.dense
        h = _selu(self.round(h) @ w1 + b1)
        h = _selu(self.round(h) @ w2 + b2)
        return self.round(h) @ w3 + b3

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 2, T) frames -> (B, classes) float32 logits, in blocks."""
        with tf32(False):
            return torch.cat([self._logits(x[i:i + BLOCK]) for i in range(0, x.shape[0], BLOCK)])
