"""Restore of the float VT-CNN2 checkpoint the port reads.

The counterpart of ``modulationdetectioncnn_tpu/utils/checkpoint.py``'s
restore, for the port's own layout: ``<checkpoint_dir>/<step>/params.npz``
holding the Flax-layout parameters under ``Conv1/kernel``-style keys
(``scripts/export_float_npz.py`` writes it from an Orbax checkpoint, which
only JAX can read). ``restore`` returns the newest step's parameters as a
``VTCNN2`` state dict (``models.vtcnn2.params_from_flax``), with the step.
Saving and optimizer state come with training.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from modulationdetectioncnn_torch.models.vtcnn2 import params_from_flax

PARAMS_FILE = "params.npz"


def latest_step(directory: str) -> int | None:
    """The largest integer-named step directory holding ``params.npz``."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory)
             if d.isdigit() and os.path.isfile(os.path.join(directory, d, PARAMS_FILE))]
    return max(steps, default=None)


def load_flax_tree(path: str) -> dict[str, dict[str, np.ndarray]]:
    """``params.npz`` -> ``{'Conv1': {'kernel': ..., 'bias': ...}, ...}``."""
    tree: dict[str, dict[str, np.ndarray]] = {}
    with np.load(path) as z:
        for key in z.files:
            layer, _, name = key.partition("/")
            tree.setdefault(layer, {})[name] = z[key]
    return tree


def restore(directory: str, step: int | None = None
            ) -> tuple[dict[str, torch.Tensor], int] | None:
    """(state dict, step) of ``step`` (default: the newest), or None when
    the directory holds no checkpoint."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    tree = load_flax_tree(os.path.join(directory, str(step), PARAMS_FILE))
    return params_from_flax(tree), step


def restore_model(directory: str, model_cfg, frame_len: int,
                  device: str | torch.device):
    """(``VTCNN2`` in eval mode on ``device`` with the newest step's
    parameters, step), or None when the directory holds no checkpoint."""
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2

    restored = restore(directory)
    if restored is None:
        return None
    state, step = restored
    model = VTCNN2.from_config(model_cfg, frame_len)
    model.load_state_dict(state)
    return model.to(device).eval(), step
