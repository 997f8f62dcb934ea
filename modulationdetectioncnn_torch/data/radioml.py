"""RML2016.10a pickle loader, with the synthetic dataset as its fallback.

The port's own copy of ``modulationdetectioncnn_tpu/data/radioml.py``. The
public RadioML-2016.10a pickle is a dict keyed by ``(modulation: str, snr:
int)`` mapping to float32 arrays of shape (1000, 2, 128). This loader reads
that format when the configured file exists and otherwise builds the
synthetic dataset (``data/synthetic.py``). Unpickling runs code from the
file: point ``data.radioml_pickle`` only at a file you trust.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from modulationdetectioncnn_torch.config import DataConfig
from modulationdetectioncnn_torch.data import synthetic


def load_radioml_pickle(path: str):
    """Load an RML2016.10a-format pickle: ``(x, y, snr, classes)`` with x
    float32 (N, 2, 128) and the classes sorted by name."""
    with open(path, "rb") as f:
        # The public pickle is python2-era; latin1 reads its byte strings.
        data = pickle.load(f, encoding="latin1")
    classes = tuple(sorted({k[0] for k in data}))
    cls_index = {c: i for i, c in enumerate(classes)}
    xs, ys, ss = [], [], []
    for (mod, snr), frames in data.items():
        arr = np.asarray(frames, dtype=np.float32)
        if arr.ndim != 3 or arr.shape[1] != 2:
            raise ValueError(f"unexpected frame shape {arr.shape} for {(mod, snr)}")
        xs.append(arr)
        ys.append(np.full(len(arr), cls_index[mod], dtype=np.int32))
        ss.append(np.full(len(arr), int(snr), dtype=np.int32))
    return (np.concatenate(xs), np.concatenate(ys), np.concatenate(ss), classes)


def load_dataset(cfg: DataConfig):
    """The configured dataset: the pickle when it exists, else synthetic.
    Returns ``(x, y, snr, classes)``."""
    if cfg.radioml_pickle and os.path.exists(cfg.radioml_pickle):
        return load_radioml_pickle(cfg.radioml_pickle)
    x, y, s = synthetic.make_dataset(cfg)
    return x, y, s, cfg.classes
