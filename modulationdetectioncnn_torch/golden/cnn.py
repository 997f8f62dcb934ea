"""NumPy float64 forward of the VT-CNN2, the port's own copy of
``modulationdetectioncnn_tpu/golden/cnn.py``: the oracle the torch float
model is held against, and the ``eval.backend=golden`` backend.

It reads the Flax-layout parameter tree (``{'Conv1': {'kernel', 'bias'},
...}``, optionally under ``'params'``; ``models.vtcnn2.flax_params`` gives
it for a torch model). Topology: (B, 2, 128, 1) -conv(1,3) x C1, valid,
relu-> (B, 2, 126, C1) -conv(2,3) x C2, valid, relu-> (B, 1, 124, C2)
-flatten-> dense D, relu -> dense NC -> logits.
"""
from __future__ import annotations

import numpy as np


def conv2d_valid(x: np.ndarray, w: np.ndarray, b: np.ndarray) -> np.ndarray:
    """NHWC valid 2D cross-correlation. x: (B, H, W, Cin); w: (kh, kw, Cin,
    Cout); b: (Cout,)."""
    bsz, h, wd, _ = x.shape
    kh, kw, _, cout = w.shape
    ho, wo = h - kh + 1, wd - kw + 1
    out = np.zeros((bsz, ho, wo, cout), dtype=np.float64)
    for i in range(kh):
        for j in range(kw):
            patch = x[:, i:i + ho, j:j + wo, :].astype(np.float64)
            out += patch @ w[i, j].astype(np.float64)
    return out + b.astype(np.float64)


def relu(x: np.ndarray) -> np.ndarray:
    return np.maximum(x, 0.0)


def vtcnn2_forward(params: dict, x: np.ndarray) -> np.ndarray:
    """x: (B, 2, T) float -> logits (B, num_classes), float64."""
    p = params["params"] if "params" in params else params
    h = x.astype(np.float64)[..., None]                    # (B, 2, T, 1) NHWC
    h = relu(conv2d_valid(h, np.asarray(p["Conv1"]["kernel"]), np.asarray(p["Conv1"]["bias"])))
    h = relu(conv2d_valid(h, np.asarray(p["Conv2"]["kernel"]), np.asarray(p["Conv2"]["bias"])))
    h = h.reshape(h.shape[0], -1)                          # (H, W, C) order, as Flax
    h = relu(h @ np.asarray(p["Dense1"]["kernel"], dtype=np.float64)
             + np.asarray(p["Dense1"]["bias"]))
    return (h @ np.asarray(p["Dense2"]["kernel"], dtype=np.float64)
            + np.asarray(p["Dense2"]["bias"]))


def vtcnn2_predict(params: dict, x: np.ndarray) -> np.ndarray:
    return np.argmax(vtcnn2_forward(params, x), axis=-1)
