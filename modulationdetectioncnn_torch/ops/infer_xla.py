"""The ``xla_int8`` chain: the int8 VT-CNN2 from library ops only.

Counterpart of ``modulationdetectioncnn_tpu/ops/infer_xla.py``, which wrote
the integer chain as XLA ops so that the compiler owned fusion and
scheduling, as a software yardstick for the hand-written kernels. Here the
products are ``torch._int_mm`` (cuBLASLt int8 on the card) wherever its
shape rules allow, and an exact float64 product elsewhere; quantize,
requantize and the shift-add are elementwise torch ops. No kernel of the
port runs, and the chain is bit-exact with the plain chain
(``ops/infer.py``): integer products are exact in any library.
"""
from __future__ import annotations

from typing import Callable

import torch

from modulationdetectioncnn_torch.ops.infer import carry_weights, tap_planes
from modulationdetectioncnn_torch.ops.requant import requantize


def _int_mm_takes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``torch._int_mm``'s shape rules on the card (more than 16 rows, K and
    N multiples of 8); on the CPU it takes any shape."""
    if a.device.type != "cuda":
        return True
    return a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0


def _int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (m, k) x int8 (k, n) -> exact int32 (m, n)."""
    if _int_mm_takes(a, b):
        return torch._int_mm(a, b)
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def _col_major(w: torch.Tensor) -> torch.Tensor:
    """The same matrix stored column-major, the B layout cuBLASLt's int8
    product takes."""
    return w.t().contiguous().t()


def make_int8_forward_xla(qm, *, device: str | torch.device | None = None,
                          interpret: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """(B, 2, T) f32 -> (B, NC) f32 logits on the weights' device (the
    carried width: padded classes read -inf). ``qm``, ``device`` and
    ``interpret`` as ``ops/infer.py::carry_weights`` takes them."""
    qw = carry_weights(qm, device, interpret)
    nc = qw.w4.shape[1]
    n4 = -(-nc // 8) * 8                        # dense2's N, padded for _int_mm
    w4 = torch.zeros((qw.w4.shape[0], n4), dtype=torch.int8, device=qw.device)
    w4[:, :nc] = qw.w4
    w1e, w2l = _col_major(qw.w1e), _col_major(qw.w2l)
    w3, w4 = _col_major(qw.w3t.T), _col_major(w4)
    c2 = qw.m2.shape[0]

    def forward(x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=qw.device, dtype=torch.float32)
        b, _, t = x.shape
        t1, t2 = t - 2, t - 4
        xe = tap_planes(x, qw.inv_sx).transpose(1, 2)[:, :t1].reshape(b * t1, 8)
        a1 = requantize(_int_product(xe.contiguous(), w1e), qw.m1, qw.o1)
        z = _int_product(a1, w2l).reshape(b, t1, 3 * c2)
        s = sum(z[:, k:k + t2, k * c2:(k + 1) * c2] for k in range(3))
        h = requantize(s, qw.m2, qw.o2).reshape(b, t2 * c2)
        a3 = requantize(_int_product(h, w3), qw.m3, qw.o3)
        acc4 = _int_product(a3, w4)[:, :nc]
        return acc4.to(torch.float32) * qw.s4 + qw.b4

    return forward


def make_int8_predict_xla(qm, *, device: str | torch.device | None = None,
                          interpret: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """(B, 2, T) f32 -> (B,) int32 labels: argmax of the logits, ties to
    the lowest index."""
    forward = make_int8_forward_xla(qm, device=device, interpret=interpret)

    def classify(x: torch.Tensor) -> torch.Tensor:
        return forward(x).argmax(-1).to(torch.int32)

    return classify
