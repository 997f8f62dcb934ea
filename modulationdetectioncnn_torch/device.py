"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from modulationdetectioncnn_torch.utils import profiler


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


def describe(dev: torch.device) -> str:
    """The device a measurement ran on, to print beside it: ``"cpu"``, or
    the card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit`` reads them (a card set below its maximum runs slower)."""
    if dev.type != "cuda":
        return "cpu"
    index = torch.device(dev).index or 0
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def host_constant(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A front-end constant made on the host, on ``device``, in its own
    dtype: ``a`` itself on the CPU; on a card, a blocking copy from pageable
    memory (the host waits for the card's queue to drain), counted under the
    profiler in ``amc.frontend.syncs``. The span ``amc.frontend.sync`` is the
    host's time in it."""
    with profiler.span("amc.frontend.sync"):
        t = torch.as_tensor(a, device=device)
        if t.device.type == "cuda":
            profiler.count("amc.frontend.syncs")
    return t
