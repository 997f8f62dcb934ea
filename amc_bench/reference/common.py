"""What every architecture's plain reference shares: TF32 switched off or on
for a block, and the first largest logit. Plain torch only."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 in cuBLAS and cuDNN on or off inside the block, as it was after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def first_argmax(logits: torch.Tensor) -> torch.Tensor:
    """The index of the largest value, ties to the lowest index."""
    mx = logits.max(dim=-1, keepdim=True).values
    lane = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(logits >= mx, lane, logits.shape[-1]).min(dim=-1).values
