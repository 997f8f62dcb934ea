"""NumPy weight-packing helpers of ``modulationdetectioncnn_tpu/ops/cnn_kernels.py``,
the port's own copies (the quantizer packs with them). The requantize spec
of that module is ``ops/requant.py``; its Pallas kernels are not ported yet
(ROADMAP.md, Queue 2 rows 17-20).
"""
from __future__ import annotations

import numpy as np


def pack_conv1_weights(w1: np.ndarray) -> np.ndarray:
    """Flax Conv1 kernel (1, 3, 1, C) -> (3, C)."""
    return np.asarray(w1).reshape(3, -1)


def pack_conv2_weights(w2: np.ndarray) -> np.ndarray:
    """Flax Conv2 kernel (2, 3, Cin, Co) -> (2*Cin, 3*Co) tap-packed:
    W2p[h*Cin + cin, k*Co + co] = w2[h, k, cin, co]."""
    w2 = np.asarray(w2)
    kh, kw, cin, co = w2.shape
    return w2.transpose(0, 2, 1, 3).reshape(kh * cin, kw * co)
