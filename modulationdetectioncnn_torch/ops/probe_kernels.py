"""The two probe kernels of the JAX package's ``scripts/probe.py`` that no
product kernel computes: an identity copy (the achieved-bandwidth probe of
``probe_r3``) and the int8 prologue alone (quantize and the tap planes,
``probe_r3f``'s and ``probe_r3i``'s stand-alone prologue kernels).

Each has the three pieces of ``ops/infer.py``'s stages:

- the wrapper (``copy_bytes``, ``quantize_tap_planes``): on a CUDA tensor
  it checks the argument and launches its hand-written kernel in
  ``csrc/probe_kernels.cu``, counting the launch in its ``launches``
  attribute, or raises; on a CPU tensor it runs the plain version. There is
  no fallback from one to the other;
- the plain version: ``Tensor.clone`` and ``ops/infer.py::tap_planes``
  (the v4/v6 prologue, which stays plain torch on their path);
- the kernel's note at the top of ``csrc/probe_kernels.cu``.

No product path calls them; ``scripts/probe.py`` times them (``ceil``,
``stage``) and ``chip_smoke.py`` holds them to their plain versions.
"""
from __future__ import annotations

import torch

from modulationdetectioncnn_torch.ops.cnn_kernels import _call
from modulationdetectioncnn_torch.ops.infer import tap_planes


def _check_cuda(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the input must be contiguous")


def copy_bytes(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` (any dtype and shape). Launches
    ``csrc/probe_kernels.cu``'s copy on a CUDA tensor; ``x.clone()`` on the
    CPU."""
    if x.device.type == "cpu":
        return x.clone()
    _check_cuda("copy_bytes", x)
    if x.data_ptr() % 16:
        raise ValueError("copy_bytes: the input is not 16-byte aligned")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    n_bytes = x.numel() * x.element_size()
    if n_bytes:
        _call(copy_bytes, "amc_copy_bytes", x.device, x.data_ptr(), n_bytes, out.data_ptr())
    return out


def quantize_tap_planes(x: torch.Tensor, inv_sx: float) -> torch.Tensor:
    """(B, 2, T) f32 frames -> (B, 8, T) int8 tap planes (``tap_planes``'s
    function). Launches ``csrc/probe_kernels.cu``'s prologue on a CUDA
    tensor; ``tap_planes`` on the CPU."""
    if x.device.type == "cpu":
        return tap_planes(x, inv_sx)
    if x.dim() != 3 or x.shape[1] != 2 or x.shape[2] < 3 or x.dtype != torch.float32:
        raise ValueError("quantize_tap_planes: expected (B, 2, T >= 3) float32, "
                         f"got {tuple(x.shape)} {x.dtype}")
    _check_cuda("quantize_tap_planes", x)
    b, _, t = x.shape
    out = torch.empty((b, 8, t), dtype=torch.int8, device=x.device)
    if b:
        _call(quantize_tap_planes, "amc_tap_planes", x.device, x.data_ptr(), b, t,
              float(inv_sx), out.data_ptr())
    return out


KERNEL_WRAPPERS = (copy_bytes, quantize_tap_planes)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launch_counts()


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
