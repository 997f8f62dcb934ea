"""Export a float VT-CNN2 Orbax checkpoint to the ``.npz`` the PyTorch port reads.

The float checkpoint (``artifacts/ckpt_rml11_r5``, step 96000: the step the
committed int8 artifact was quantized from) is an Orbax tree, which only
JAX + orbax can open. The PyTorch package (``modulationdetectioncnn_torch``)
imports neither, so this script writes the step's parameters, unchanged in
dtype, shape and Flax layout, to ``<OUT_DIR>/<step>/params.npz`` under
``Conv1/kernel``-style keys (the port's ``utils/checkpoint.py`` layout).
The optimizer state is left behind.

Usage (from the repo root, where JAX and orbax are installed):

    python scripts/export_float_npz.py [SRC_DIR] [STEP] [OUT_DIR]

Then ``train.checkpoint_dir=modulationdetectioncnn_torch/assets/ckpt_rml11_r5``
means to the port what ``train.checkpoint_dir=artifacts/ckpt_rml11_r5`` means
to the JAX package. The port itself never runs this script.
"""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from modulationdetectioncnn_tpu.utils import checkpoint as ckpt  # noqa: E402

DEFAULT_SRC = os.path.join(ROOT, "artifacts", "ckpt_rml11_r5")
DEFAULT_STEP = 96000
DEFAULT_OUT = os.path.join(ROOT, "modulationdetectioncnn_torch", "assets",
                           "ckpt_rml11_r5")


def restore_params(src: str, step: int) -> dict[str, np.ndarray]:
    """The step's parameters as ``{'Conv1/kernel': array, ...}``."""
    mgr = ckpt.make_manager(src)
    try:
        restored = ckpt.restore(mgr, step=step)
    finally:
        mgr.close()
    if restored is None:
        raise SystemExit(f"no checkpoint at step {step} in {src}")
    params = restored[0]
    params = params.get("params", params)
    return {f"{layer}/{name}": np.asarray(v)
            for layer, leaves in params.items() for name, v in leaves.items()}


def export(src: str = DEFAULT_SRC, step: int = DEFAULT_STEP,
           out_dir: str = DEFAULT_OUT) -> tuple[str, dict[str, np.ndarray]]:
    flat = restore_params(src, step)
    out = os.path.join(out_dir, str(step), "params.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez(out, **flat)
    return out, flat


def main(argv: list[str]) -> int:
    src = argv[0] if argv else DEFAULT_SRC
    step = int(argv[1]) if len(argv) > 1 else DEFAULT_STEP
    out_dir = argv[2] if len(argv) > 2 else DEFAULT_OUT
    out, flat = export(src, step, out_dir)
    for k, v in sorted(flat.items()):
        print(f"{k:14s} {str(v.shape):16s} {v.dtype}")
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
