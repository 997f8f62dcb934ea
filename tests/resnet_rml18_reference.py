"""Plain reference of the residual classifier of O'Shea, Roy and Clancy
(IEEE JSTSP 2018, arXiv:1712.04578, Table III) for the CPU tests: float32,
TF32 off, plain torch only, importing nothing of the port and no kernel.

From a state dict under the port's names (``stacks.<s>.proj``,
``stacks.<s>.units.<u>.conv_a`` / ``conv_b``, ``dense1..3``; Conv1d weights
(out, in, k), Linear (out, in)) on (B, 2, T) frames, channels first:

    per stack:  h = proj(h)                                (1x1, linear)
                h = h + conv_b(relu(conv_a(h)))            (twice; odd width, zero "same" padding)
                h[c, t] = max(h[c, 2t], h[c, 2t+1])        (max-pool 2)
    then        flatten time-major (t * C + c), SELU(Dense), SELU(Dense), Dense

SELU with lambda = 1.0507009873554805 and alpha = 1.6732632423543772; no
dropout. Each conv is written out as an einsum over the taps of the padded,
unfolded map.
"""
from __future__ import annotations

import contextlib

import torch

LAMBDA = 1.0507009873554805
ALPHA = 1.6732632423543772


@contextlib.contextmanager
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _conv(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, Cin, T), (Cout, Cin, K) -> (B, Cout, T), zero "same" padding."""
    k = w.shape[-1]
    cols = torch.nn.functional.pad(h, (k // 2, k // 2)).unfold(-1, k, 1)   # (B, Cin, T, K)
    return torch.einsum("bitk,oik->bot", cols, w) + b[:, None]


def logits(state: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, 2, T) float32 frames -> (B, classes) float32 logits."""
    p = {k: v.detach().to(torch.float32) for k, v in state.items()}
    n_stacks = len({k.split(".")[1] for k in p if k.startswith("stacks.")})
    with _no_tf32():
        h = x.to(torch.float32)
        for s in range(n_stacks):
            pre = f"stacks.{s}."
            h = _conv(h, p[pre + "proj.weight"], p[pre + "proj.bias"])
            for u in range(2):
                a, b = f"{pre}units.{u}.conv_a.", f"{pre}units.{u}.conv_b."
                inner = torch.clamp(_conv(h, p[a + "weight"], p[a + "bias"]), min=0.0)
                h = h + _conv(inner, p[b + "weight"], p[b + "bias"])
            h = h.reshape(h.shape[0], h.shape[1], -1, 2).amax(-1)
        h = h.transpose(1, 2).reshape(h.shape[0], -1)
        for i in (1, 2, 3):
            h = h @ p[f"dense{i}.weight"].T + p[f"dense{i}.bias"]
            if i < 3:
                h = LAMBDA * torch.where(h > 0, h, ALPHA * (torch.exp(h) - 1.0))
        return h
