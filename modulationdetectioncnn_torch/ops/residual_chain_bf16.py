"""The bf16 classifier of the residual model (``models/resnet_rml18.py``):
the fused residual chain, then the dense head.

- ``residual_chain_bf16``: (B, 2, 1024) f32 frames -> (B, 16, 32) bf16 map,
  all six stacks in one launch of ``csrc/residual_chain_bf16.cu`` on a CUDA
  tensor, the plain version ``residual_chain_bf16_plain`` on a CPU tensor
  (no fallback). It rounds where the kernel rounds: the frame to bf16, each
  layer's output to bf16 (the second conv of a unit after its skip add),
  every sum in f32 with f32 biases.
- ``head_labels``: the map flattened time-major, Dense SELU, Dense SELU,
  Dense, argmax (ties to the lowest index), in plain torch bf16 operations,
  on either device.
- ``make_resnet_classifier``: the two, labels out, with the spans
  ``amc.classifier.chain`` and ``amc.classifier.head`` under a profiler.

The counter ``amc.classifier.launches`` counts the hand-written kernels the
classifier launches, at the launch site (``_launch``): one a call. The
head's PyTorch operations are not counted; the device trace shows them.

The kernel is compiled for the published widths (``fits_kernel``): frames
of 1024, six stacks of 32 filters, width 3, pool 2; the head takes any
dense width and class count. A model at other widths runs on the module's
forward (``dsp/pipeline.py::resnet_route``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.nn import functional as F

from modulationdetectioncnn_torch.device import resolve_device
from modulationdetectioncnn_torch.ops import _build
from modulationdetectioncnn_torch.utils.profiler import count, span

FRAME_LEN, STACKS, FILTERS, KERNEL, POOL = 1024, 6, 32, 3, 2
MAP_LEN = FRAME_LEN // POOL ** STACKS                  # 16
# One stack's weights in the kernel's layout (csrc/residual_chain_bf16.cu):
# the projection (8 B fragments; stack 0: w (2, 32) f32), its bias (32 f32),
# the four convs (24 fragments each) and their biases (4 x 32 f32).
FRAG_BYTES = 32 * 8
STACK_BYTES = 8 * FRAG_BYTES + FILTERS * 4 + 4 * 24 * FRAG_BYTES + 4 * FILTERS * 4   # 27,264
# The kernel sums in the tensor cores' order, the plain version in
# PyTorch's: a map element may round to a neighbouring bf16 value, and the
# difference carries through the layers that follow. A kernel's map element
# lies within MAP_TOL of the plain map's largest magnitude.
MAP_TOL = 2.0 ** -6


@dataclasses.dataclass(frozen=True)
class ChainStack:
    """One stack's weights for the plain version: bf16 values held in f32
    (``proj_w`` (32, Cin), ``conv_w`` (4, 32, 32, 3) as Conv1d (out, in,
    k), the units' conv_a, conv_b in order), biases in f32."""
    proj_w: torch.Tensor
    proj_b: torch.Tensor
    conv_w: torch.Tensor
    conv_b: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ChainWeights:
    """The six stacks, and ``blob``: the same weights as the kernel reads
    them, (6 * STACK_BYTES,) uint8 on the device."""
    stacks: tuple
    blob: torch.Tensor


@dataclasses.dataclass(frozen=True)
class HeadWeights:
    """The dense head's weights and biases in bf16, Linear layouts."""
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor


def fits_kernel(state: dict) -> bool:
    """Whether a ``ResNetRML18`` state dict has the widths the kernel is
    compiled for: six stacks of 32 filters, width 3, on 1024-sample frames
    pooled by 2 (a 16-position map into dense1)."""
    n_stacks = len({k.split(".")[1] for k in state if k.startswith("stacks.")})
    if n_stacks != STACKS or "stacks.0.proj.weight" not in state:
        return False
    if tuple(state["stacks.0.proj.weight"].shape) != (FILTERS, 2, 1):
        return False
    for s in range(STACKS):
        for u in range(2):
            for c in ("conv_a", "conv_b"):
                if tuple(state[f"stacks.{s}.units.{u}.{c}.weight"].shape) != (FILTERS, FILTERS, KERNEL):
                    return False
    return state["dense1.weight"].shape[1] == MAP_LEN * FILTERS


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).to(torch.bfloat16).to(torch.float32)


def _fragments(b: np.ndarray) -> np.ndarray:
    """A (K, 32) B matrix -> its m16n8k16 B fragments, [k-step][n-tile][lane]
    x 4 values: lane (g, q) = (lane >> 2, lane & 3) holds B[k0, n],
    B[k0+1, n] (register b0) and B[k0+8, n], B[k0+9, n] (b1), k0 = 16 ks +
    2q, n = 8 nt + g."""
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    out = np.empty((b.shape[0] // 16, 4, 32, 4), np.float32)
    for ks in range(b.shape[0] // 16):
        k0 = 16 * ks + 2 * q
        for nt in range(4):
            n = 8 * nt + g
            for i, dk in enumerate((0, 1, 8, 9)):
                out[ks, nt, :, i] = b[k0 + dk, n]
    return out.reshape(-1)


def _bytes(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32).reshape(-1)).to(dtype).view(
        torch.uint8)


def make_chain_weights(state: dict, device: str | torch.device = "cuda") -> ChainWeights:
    """Pack a ``ResNetRML18`` state dict at the kernel's widths: weights
    rounded to bf16 (nearest even), biases f32; the kernel's blob beside
    the plain version's tensors, both on ``device``."""
    dev = resolve_device(device)
    stacks, parts = [], []
    for s in range(STACKS):
        p = f"stacks.{s}."
        proj_w = _bf16_values(state[p + "proj.weight"])[:, :, 0]          # (32, Cin)
        proj_b = state[p + "proj.bias"].detach().to("cpu", torch.float32)
        conv_w = torch.stack([_bf16_values(state[f"{p}units.{u}.{c}.weight"])
                              for u in range(2) for c in ("conv_a", "conv_b")])
        conv_b = torch.stack([state[f"{p}units.{u}.{c}.bias"].detach().to("cpu", torch.float32)
                              for u in range(2) for c in ("conv_a", "conv_b")])
        if s == 0:   # w (2, 32) f32 for the FMA pipes, in an 8-fragment region
            proj = np.zeros(8 * FRAG_BYTES // 4, np.float32)
            proj[:2 * FILTERS] = proj_w.T.numpy().reshape(-1)
            parts.append(_bytes(proj, torch.float32))
        else:
            parts.append(_bytes(_fragments(proj_w.T.numpy()), torch.bfloat16))
        parts.append(_bytes(proj_b.numpy(), torch.float32))
        for w in conv_w:   # B[k * 32 + j, c] = w[c, j, k]
            parts.append(_bytes(_fragments(w.permute(2, 1, 0).reshape(-1, FILTERS).numpy()),
                                torch.bfloat16))
        parts.append(_bytes(conv_b.numpy(), torch.float32))
        stacks.append(ChainStack(*(t.to(dev) for t in (proj_w, proj_b, conv_w, conv_b))))
    blob = torch.cat(parts)
    assert blob.numel() == STACKS * STACK_BYTES
    return ChainWeights(tuple(stacks), blob.to(dev))


def make_head_weights(state: dict, device: str | torch.device = "cuda") -> HeadWeights:
    dev = resolve_device(device)

    def t(name):
        return state[name].detach().to(dev, torch.bfloat16)

    return HeadWeights(*(t(f"dense{i}.{k}") for i in (1, 2, 3) for k in ("weight", "bias")))


# ------------------------------------------------------- plain versions


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _conv3(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, T, 32) f32, (32, 32, 3) -> (B, T, 32) f32 sums of the width-3
    conv with zero "same" padding, no bias."""
    t = h.shape[1]
    hp = F.pad(h, (0, 0, 1, 1))
    return torch.cat([hp[:, k:k + t] for k in range(3)], dim=-1) @ w.permute(2, 1, 0).reshape(
        -1, w.shape[0])


def residual_chain_bf16_plain(x: torch.Tensor, cw: ChainWeights) -> torch.Tensor:
    """The plain version of the fused chain, (B, 2, 1024) f32 -> (B, 16,
    32) bf16, rounding where the kernel rounds."""
    xb = _bf16(x.to(torch.float32))
    st = cw.stacks[0]
    y = _bf16((xb[:, 0, :, None] * st.proj_w[:, 0] + xb[:, 1, :, None] * st.proj_w[:, 1])
              + st.proj_b)                                         # (B, T, 32)
    for s, st in enumerate(cw.stacks):
        if s:
            y = _bf16(y @ st.proj_w.T + st.proj_b)
        for u in range(2):
            h = _bf16(torch.relu(_conv3(y, st.conv_w[2 * u]) + st.conv_b[2 * u]))
            y = _bf16((_conv3(h, st.conv_w[2 * u + 1]) + st.conv_b[2 * u + 1]) + y)
        y = torch.maximum(y[:, 0::2], y[:, 1::2])
    return y.to(torch.bfloat16)


def head_logits(h: torch.Tensor, hw: HeadWeights) -> torch.Tensor:
    """The (B, 16, 32) bf16 map -> (B, classes) bf16 logits: flattened
    t * 32 + c, Dense SELU, Dense SELU, Dense, in bf16."""
    h = F.selu(F.linear(h.flatten(1), hw.w1, hw.b1))
    h = F.selu(F.linear(h, hw.w2, hw.b2))
    return F.linear(h, hw.w3, hw.b3)


def head_labels(h: torch.Tensor, hw: HeadWeights) -> torch.Tensor:
    """(B,) int32 labels: the first largest of ``head_logits``."""
    return head_logits(h, hw).argmax(-1).to(torch.int32)


# ------------------------------------------------------ kernel launch


def _launch(x: torch.Tensor, cw: ChainWeights) -> torch.Tensor:
    name = "residual_chain_bf16"
    if x.dtype != torch.float32 or tuple(x.shape[1:]) != (2, FRAME_LEN):
        raise ValueError(f"{name}: expected (B, 2, {FRAME_LEN}) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    blob = cw.blob
    if blob.dtype != torch.uint8 or tuple(blob.shape) != (STACKS * STACK_BYTES,):
        raise ValueError(f"{name}: the kernel is built for a ({STACKS * STACK_BYTES},) uint8 "
                         f"weight blob, got {tuple(blob.shape)} {blob.dtype}")
    b = x.shape[0]
    out = torch.empty((b, MAP_LEN, FILTERS), dtype=torch.bfloat16, device=x.device)
    if b == 0:
        return out
    for key, t in (("input", x), ("weights", blob)):
        if t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, input on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is misaligned")
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        code = lib.amc_residual_chain_bf16(x.data_ptr(), b, blob.data_ptr(), out.data_ptr(),
                                           torch.cuda.current_stream().cuda_stream)
    _build.check(lib, name, code)
    residual_chain_bf16.launches += 1
    count("amc.classifier.launches")
    return out


def residual_chain_bf16(x: torch.Tensor, cw: ChainWeights) -> torch.Tensor:
    """The fused residual chain, (B, 2, 1024) f32 -> (B, 16, 32) bf16.
    Launches ``csrc/residual_chain_bf16.cu`` on a CUDA tensor; plain version
    on the CPU."""
    if x.device.type == "cpu":
        return residual_chain_bf16_plain(x, cw)
    return _launch(x, cw)


residual_chain_bf16.launches = 0


def make_resnet_classifier(state: dict, device: str | torch.device = "cuda"
                           ) -> Callable[[torch.Tensor], torch.Tensor]:
    """(B, 2, 1024) f32 -> (B,) int32 labels on ``device`` from a
    ``ResNetRML18`` state dict at the kernel's widths: the fused chain, then
    the head. Under a profiler the chain's checks and launch are the span
    ``amc.classifier.chain`` and the head ``amc.classifier.head``."""
    cw = make_chain_weights(state, device)
    hw = make_head_weights(state, device)
    dev = cw.blob.device

    def classify(x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=dev, dtype=torch.float32).contiguous()
        with span("amc.classifier.chain"):
            h = residual_chain_bf16(x, cw)
        with span("amc.classifier.head"):
            return head_labels(h, hw)

    return classify
