"""The int8 deployment artifact and the weight layouts the kernels read.

``QuantizedModel`` holds the same 13 arrays as the JAX package's
``train/quant.py::QuantizedModel`` (NumPy, the JAX package's layouts). The
committed artifact is ``assets/rml11_int8.npz``, exported from the Orbax tree
``artifacts/ckpt_rml11_int8`` by ``scripts/export_int8_npz.py``.

``int8_weights_from_numpy`` carries a model across: it turns those arrays
into device tensors in the layouts the CUDA kernels and their plain versions
read (``Int8Weights``). Integer requantize constants are unchanged: the
fixed-point spec is ``clip((acc + offset) >> shift, 0, 127)``. The v9/v10
conv stage also reads conv1 with its requantize folded into bf16 weights
(``fold_conv1_weights``). That fold is built, and its exactness contract
checked, only when a v9/v10 path first asks for it (``Int8Weights.w1f``):
a model that v7 runs exactly but the fold cannot carry still runs on v7.

The kernels are compiled for the full-width VT-CNN2 (``FRAME_LEN``, ``C1``,
``C2``, ``DENSE``, ``N_CLASSES``). A narrower model is zero-padded to those widths at carry time
(``pad_to_kernel_widths``), as the TPU kernels padded to 128 lanes: every
padded channel, unit or class computes an exact zero or can never win the
argmax, so the padded model gives the unpadded one's map and labels. The
conv-stage wrappers return the model's own ``[:, :, :c2]`` map, and v2's
logits the model's own ``[:, :nc]`` classes.
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass, fields
from typing import Any, Mapping

import numpy as np
import torch

from modulationdetectioncnn_torch.device import resolve_device

DEFAULT_ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "assets", "rml11_int8.npz")
# The file an artifact directory (what ``quantize`` writes) holds.
ARTIFACT_FILE = "int8.npz"

# The widths the CUDA kernels are compiled for (the full-width VT-CNN2):
# frame length T, conv1 filters, conv2 filters, dense units, classes.
FRAME_LEN, C1, C2, DENSE, N_CLASSES = 128, 256, 80, 256, 11
T2 = FRAME_LEN - 4


@dataclass
class QuantizedModel:
    """All arrays are NumPy, in the JAX package's layouts."""

    s_x: np.ndarray          # () f32 input scale
    w1p: np.ndarray          # (3, C1) int8 conv1 taps
    m1: np.ndarray           # (2*C1,) int32 requantize shift
    o1: np.ndarray           # (2*C1,) int32 offset (bias + rounding term)
    w2p: np.ndarray          # (2*C1, 3*C2) int8, [h*C1+cin, k*C2+co]
    m2: np.ndarray           # (C2,) int32
    o2: np.ndarray           # (C2,) int32
    w3: np.ndarray           # (T2*C2, D) int8, rows in t*C2+c order
    m3: np.ndarray           # (D,) int32
    o3: np.ndarray           # (D,) int32
    w4: np.ndarray           # (D, NC) int8
    s4: np.ndarray           # (NC,) f32 dequant scale
    b4: np.ndarray           # (NC,) f32

    def tree(self) -> dict[str, np.ndarray]:
        return {f.name: np.asarray(getattr(self, f.name)) for f in fields(self)}

    @classmethod
    def from_tree(cls, t: Mapping[str, Any]) -> "QuantizedModel":
        return cls(**{f.name: np.asarray(t[f.name]) for f in fields(cls)})

    @classmethod
    def from_npz(cls, path: str) -> "QuantizedModel":
        with np.load(path) as z:
            return cls.from_tree({k: z[k] for k in z.files})

    def save(self, directory: str) -> str:
        """Write the artifact as ``<directory>/int8.npz`` (what
        ``load_int8(directory)`` reads); returns the file's path."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, ARTIFACT_FILE)
        np.savez(path, **self.tree())
        return path

    def widths(self) -> tuple[int, int, int, int, int]:
        """(frame length, conv1 filters, conv2 filters, dense units,
        classes) of the model."""
        c2 = self.m2.shape[0]
        return (self.w3.shape[0] // c2 + 4, self.w1p.shape[1], c2,
                self.m3.shape[0], self.b4.shape[0])


@dataclass(frozen=True)
class Int8Weights:
    """Device tensors in kernel layouts (see ``int8_weights_from_numpy``)."""

    inv_sx: float            # float32(1 / float64(float32(s_x))), exact f32
    c2: int                  # the model's own conv2 filters (<= m2's length)
    nc: int                  # the model's own classes (<= b4's length)
    w1: torch.Tensor         # (3, C1) int8
    w1e: torch.Tensor        # (8, 2*C1) int8 tap-plane conv1, [3h+k, h*C1+c]
    m1: torch.Tensor         # (2*C1,) int32
    o1: torch.Tensor         # (2*C1,) int32
    w2t: torch.Tensor        # (C2, 3*2*C1) int8, [co, k*2*C1 + j]
    w2l: torch.Tensor        # (2*C1, 3*C2) int8 taps on N, [j, k*C2 + co]
    m2: torch.Tensor         # (C2,) int32
    o2: torch.Tensor         # (C2,) int32
    w3t: torch.Tensor        # (D, T2*C2) int8, dense1 transposed
    m3: torch.Tensor         # (D,) int32
    o3: torch.Tensor         # (D,) int32
    w4: torch.Tensor         # (D, NC) int8
    s4: torch.Tensor         # (NC,) f32
    b4: torch.Tensor         # (NC,) f32

    @property
    def device(self) -> torch.device:
        return self.w1.device

    @functools.cached_property
    def w1f(self) -> torch.Tensor:
        """(16, 2*C1) bf16 folded conv1 (``fold_conv1_weights``), padded
        with zero rows to K=16 for the bf16 ``mma.sync.m16n8k16``. Built on
        first use; raises ``ValueError`` if the model breaks the fold's
        contract."""
        w = np.zeros((16, self.m1.shape[0]), np.float32)
        w[:8] = fold_conv1_weights(*(t.cpu().numpy() for t in (self.w1, self.m1, self.o1)))
        return torch.from_numpy(w).to(self.device, torch.bfloat16)


def fold_conv1_weights(w1p: np.ndarray, m1: np.ndarray, o1: np.ndarray) -> np.ndarray:
    """conv1 with its requantize folded in: (8, 2C) float32, bf16-exact.

    Row 2k+h holds ``w1p[k, c] * 2**-shift1[h*C+c]`` in columns h*C..h*C+C-1,
    row 6 holds ``o1 * 2**-shift1`` (the bias lane, fed 1.0), row 7 is zero
    (the port of ``expand_conv1_weights_v9f``). Under the quantizer's
    fixed-point contract every product and partial sum of a row of
    ``[xq_I(t), xq_Q(t), xq_I(t+1), xq_Q(t+1), xq_I(t+2), xq_Q(t+2), 1, 0]``
    with this matrix is an integer multiple of ``2**-shift1``, less than
    2**24 such units in magnitude, so a float32 sum in any order is exact and
    ``clip(sum, 0, 127)`` truncated to int8 equals
    ``clip((acc + o1) >> shift1, 0, 127)``. Raises ``ValueError`` when a
    model breaks that contract."""
    w1p = np.asarray(w1p, np.float64)
    sh1 = np.asarray(m1)
    o1 = np.asarray(o1, np.float64)
    if not np.issubdtype(sh1.dtype, np.integer):
        raise ValueError("the folded conv1 needs integer requantize shifts "
                         "(the fixed-point quantize() contract)")
    m1 = 2.0 ** (-sh1.astype(np.float64))
    c = w1p.shape[1]
    w = np.zeros((8, 2 * c), np.float32)
    for k in range(3):
        for h in range(2):
            w[2 * k + h, h * c:(h + 1) * c] = w1p[k] * m1[h * c:(h + 1) * c]
    w[6, :] = (o1 * m1).astype(np.float32)
    wb = torch.from_numpy(w).to(torch.bfloat16).to(torch.float32).numpy()
    if not np.array_equal(wb, w):
        raise ValueError("folded conv1 weights are not bf16-exact: the model "
                         "breaks the quantize() contract (8-bit-significand "
                         "offsets)")
    if not np.all(3 * 127 * 127 + np.abs(o1) < 2 ** 24):
        raise ValueError("conv1 |acc| + |offset| can reach 2**24: the folded "
                         "bf16 conv1 is not exact for this model")
    return w


def pad_to_kernel_widths(qm: QuantizedModel) -> QuantizedModel:
    """Zero-pad a model no wider than the kernels' widths up to them.

    conv1 and conv2 output channels get zero weights, offset 0 and shift 0,
    so they requantize to exactly 0, and conv2 reads the padded conv1
    channels through zero weights; dense1 gets zero rows for the padded
    conv2 channels (rows stay in the t*C2+c order) and zero columns for the
    padded units; padded classes get ``s4 = 0`` and ``b4 = -inf``, a logit
    of -inf that the argmax never picks. The padded conv1 still meets the
    v9/v10 fold's contract. A model wider than the kernels, or with another
    frame length, is returned unchanged: the CUDA wrappers refuse it and
    the plain versions run it on the CPU."""
    t, c1, c2, d, nc = qm.widths()
    if (t != FRAME_LEN or c1 > C1 or c2 > C2 or d > DENSE or nc > N_CLASSES
            or (c1, c2, d, nc) == (C1, C2, DENSE, N_CLASSES)):
        return qm

    def pad(a, shape, value=0):
        out = np.full(shape, value, dtype=np.asarray(a).dtype)
        out[tuple(slice(0, n) for n in np.shape(a))] = a
        return out

    return QuantizedModel(
        s_x=qm.s_x, w1p=pad(qm.w1p, (3, C1)),
        m1=pad(np.reshape(qm.m1, (2, c1)), (2, C1)).reshape(-1),
        o1=pad(np.reshape(qm.o1, (2, c1)), (2, C1)).reshape(-1),
        w2p=pad(np.reshape(qm.w2p, (2, c1, 3, c2)), (2, C1, 3, C2)).reshape(2 * C1, 3 * C2),
        m2=pad(qm.m2, (C2,)), o2=pad(qm.o2, (C2,)),
        w3=pad(np.reshape(qm.w3, (T2, c2, d)), (T2, C2, DENSE)).reshape(T2 * C2, DENSE),
        m3=pad(qm.m3, (DENSE,)), o3=pad(qm.o3, (DENSE,)),
        w4=pad(qm.w4, (DENSE, N_CLASSES)), s4=pad(qm.s4, (N_CLASSES,)),
        b4=pad(qm.b4, (N_CLASSES,), -np.inf))


def expand_conv1_weights(w1p: np.ndarray) -> np.ndarray:
    """(3, C) tap weights -> (8, 2C) tap-plane conv1, ``w[3h+k, h*C+c] =
    w1p[k, c]``, rows 6 and 7 zero (the JAX package's
    ``expand_conv1_weights``): row j multiplies tap plane j."""
    w1p = np.asarray(w1p)
    c = w1p.shape[1]
    w = np.zeros((8, 2 * c), dtype=w1p.dtype)
    for h in range(2):
        for k in range(3):
            w[h * 3 + k, h * c:(h + 1) * c] = w1p[k]
    return w


def int8_weights_from_numpy(tree: QuantizedModel | Mapping[str, Any],
                            device: str | torch.device = "cuda") -> Int8Weights:
    """Carry a model's arrays (NumPy, JAX-package layouts) to the port.

    The only re-layouts are transposes that make each kernel's reduction
    axis contiguous: conv2's tap-packed (2*C1, 3*C2) becomes (C2, 3*2*C1),
    so output channel co reads the 3 consecutive stacked conv1 rows t..t+2
    as one contiguous K = 3*2*C1 vector; dense1 (T2*C2, D) becomes
    (D, T2*C2). The v9/v10 conv stage reads the folded conv1
    (``Int8Weights.w1f``, built on first use) and conv2 in the taps-on-N
    layout of the JAX package's ``pack_conv2_weights_lane256`` without its
    lane padding, which is ``w2p`` itself. The v2 to v6 conv stages read
    conv1 in the tap-plane layout (``expand_conv1_weights``), which is also
    that of v2/v3's tap rows. Every kernel
    reads the shifts as integers, so a model with float requantize
    multipliers (the golden spec's legacy form) raises ``ValueError``. A
    model narrower than the kernels is padded to their widths first
    (``pad_to_kernel_widths``).
    """
    dev = resolve_device(device)
    qm = tree if isinstance(tree, QuantizedModel) else QuantizedModel.from_tree(tree)
    for k in ("m1", "m2", "m3"):
        if not np.issubdtype(np.asarray(getattr(qm, k)).dtype, np.integer):
            raise ValueError(f"{k}: the port's kernels need integer requantize "
                             "shifts (the fixed-point quantize() contract)")
    valid_c2, valid_nc = qm.m2.shape[0], qm.b4.shape[0]
    qm = pad_to_kernel_widths(qm)
    c2 = qm.m2.shape[0]
    k1 = qm.w2p.shape[0]                       # 2*C1
    w2t = (np.asarray(qm.w2p, np.int8).reshape(k1, 3, c2)
           .transpose(2, 1, 0).reshape(c2, 3 * k1))
    inv_sx = float(np.float32(1.0 / np.float64(np.float32(qm.s_x))))

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype))).to(dev)

    return Int8Weights(
        inv_sx=inv_sx, c2=valid_c2, nc=valid_nc,
        w1=t(qm.w1p, np.int8), w1e=t(expand_conv1_weights(qm.w1p), np.int8),
        m1=t(qm.m1, np.int32), o1=t(qm.o1, np.int32),
        w2t=t(w2t, np.int8), m2=t(qm.m2, np.int32), o2=t(qm.o2, np.int32),
        w2l=t(qm.w2p, np.int8),
        w3t=t(np.asarray(qm.w3).T, np.int8),
        m3=t(qm.m3, np.int32), o3=t(qm.o3, np.int32),
        w4=t(qm.w4, np.int8), s4=t(qm.s4, np.float32), b4=t(qm.b4, np.float32),
    )


def load_int8(path: str | None = None,
              device: str | torch.device = "cuda") -> Int8Weights:
    """Read an int8 artifact: an ``.npz`` file, or a directory holding
    ``int8.npz`` (what ``quantize`` writes); default: the committed one."""
    path = path or DEFAULT_ARTIFACT
    if os.path.isdir(path):
        path = os.path.join(path, ARTIFACT_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"int8 artifact {path!r} not found (an .npz written by "
            "scripts/export_int8_npz.py, or a directory written by quantize)")
    return int8_weights_from_numpy(QuantizedModel.from_npz(path), device)
