"""Save and restore of the float model's training state.

The counterpart of ``modulationdetectioncnn_tpu/utils/checkpoint.py`` (Orbax,
which only JAX can read), in the port's own layout:

    <checkpoint_dir>/<step>/params.npz     a VT-CNN2's Flax-layout parameters
                                           under ``Conv1/kernel``-style keys;
                                           another architecture's
                                           (``model.arch``) torch state dict
                                           under its own names and layouts
    <checkpoint_dir>/<step>/opt_state.npz  the AdamW state: ``count`` and
                                           ``mu/<name>``, ``nu/<name>`` per
                                           parameter of the state dict

``scripts/export_float_npz.py`` writes ``params.npz`` from an Orbax
checkpoint. ``restore`` returns a step's parameters as a ``VTCNN2`` state
dict (``models.vtcnn2.params_from_flax`` for a VT-CNN2), which ``eval``,
``quantize`` and the stream predictor read, and ``restore_model`` builds the
model that ``model.arch`` names; ``restore_train_state`` also brings back the
optimizer state, from which training resumes. ``save`` keeps the 3 newest
steps (Orbax's ``max_to_keep=3`` in the JAX package) and writes each step
into a temporary directory that it then renames, so an interrupted save
never leaves a step that ``latest_step`` picks up.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from modulationdetectioncnn_torch.models.vtcnn2 import flax_params, params_from_flax

PARAMS_FILE = "params.npz"
OPT_FILE = "opt_state.npz"
MAX_TO_KEEP = 3


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


def restore(directory: str, step: int | None = None, arch: str = "vtcnn2"
            ) -> tuple[dict[str, torch.Tensor], int] | None:
    """(state dict, step) of ``step`` (default: the newest) of a model of
    architecture ``arch``, or None when the directory holds no checkpoint."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    path = os.path.join(directory, str(step), PARAMS_FILE)
    if arch == "vtcnn2":
        return params_from_flax(load_flax_tree(path)), step
    with np.load(path) as z:
        if any("/" in k for k in z.files):
            raise ValueError(f"{path} holds a VT-CNN2 (Flax-layout keys), not a "
                             f"model.arch={arch!r} model")
        return {k: torch.from_numpy(np.array(z[k], np.float32)) for k in z.files}, step


def save(directory: str, step: int, state: dict[str, torch.Tensor],
         opt_state=None, max_to_keep: int = MAX_TO_KEEP) -> str:
    """Write ``<directory>/<step>/`` (the parameters of the state dict
    ``state``, a ``VTCNN2``'s in the Flax layout and any other model's under
    its own names, and, when given, the ``train.loop.AdamState``), then
    delete all but the ``max_to_keep`` newest steps. Returns the step's
    directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    if "conv1.weight" in state:
        tree = flax_params(state)
        arrays = {f"{layer}/{k}": v for layer, d in tree.items() for k, v in d.items()}
    else:
        arrays = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in state.items()}
    np.savez(os.path.join(tmp, PARAMS_FILE), **arrays)
    if opt_state is not None:
        arrays = {"count": np.asarray(opt_state.count, np.int64)}
        for kind in ("mu", "nu"):
            for name, t in getattr(opt_state, kind).items():
                arrays[f"{kind}/{name}"] = t.detach().to("cpu", torch.float32).numpy()
        np.savez(os.path.join(tmp, OPT_FILE), **arrays)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    steps = sorted(int(d) for d in os.listdir(directory)
                   if d.isdigit() and os.path.isfile(os.path.join(directory, d, PARAMS_FILE)))
    for old in steps[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))
    return final


def restore_train_state(directory: str, step: int | None = None,
                        device: str | torch.device = "cpu"):
    """(state dict, ``train.loop.AdamState`` or None, step) of ``step``
    (default: the newest) on ``device``, or None when the directory holds
    no checkpoint. The optimizer state is None for a step saved without one
    (an exported or a ``qat`` checkpoint)."""
    from modulationdetectioncnn_torch.train.loop import AdamState

    restored = restore(directory, step)
    if restored is None:
        return None
    state, step = restored
    state = {k: v.to(device) for k, v in state.items()}
    path = os.path.join(directory, str(step), OPT_FILE)
    if not os.path.isfile(path):
        return state, None, step
    with np.load(path) as z:
        moments = {kind: {k.split("/", 1)[1]: torch.from_numpy(z[k]).to(device)
                          for k in z.files if k.startswith(kind + "/")}
                   for kind in ("mu", "nu")}
        count = int(z["count"])
    return state, AdamState(count=count, **moments), step


def restore_model(directory: str, model_cfg, frame_len: int,
                  device: str | torch.device):
    """(the model that ``model_cfg.arch`` names, ``VTCNN2`` or
    ``ResNetRML18``, in eval mode on ``device`` with the newest step's
    parameters, step), or None when the directory holds no checkpoint."""
    from modulationdetectioncnn_torch.models.resnet_rml18 import ARCH, ResNetRML18
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2

    archs = {"vtcnn2": VTCNN2, ARCH: ResNetRML18}
    if model_cfg.arch not in archs:
        raise ValueError(f"model.arch={model_cfg.arch!r}: known {', '.join(archs)}")
    restored = restore(directory, arch=model_cfg.arch)
    if restored is None:
        return None
    state, step = restored
    model = archs[model_cfg.arch].from_config(model_cfg, frame_len)
    model.load_state_dict(state)
    return model.to(device).eval(), step
