"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    the CPU. Never falls back to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(CLI: device=cpu) to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
