"""Export the Orbax int8 artifact to the ``.npz`` the PyTorch port reads.

The int8 deployment artifact (``artifacts/ckpt_rml11_int8``) is an Orbax
tree, which only JAX + orbax can open. The PyTorch package
(``modulationdetectioncnn_torch``) imports neither, so this script writes the
same 13 arrays, unchanged in dtype and shape, to an uncompressed ``.npz``
that ships inside the port (``modulationdetectioncnn_torch/assets``).

Usage (from the repo root, where JAX and orbax are installed):

    python scripts/export_int8_npz.py [SRC_DIR] [OUT_NPZ]

It is the only file of the port's work that imports JAX; the port itself
never runs it.
"""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from modulationdetectioncnn_tpu.train.quant import QuantizedModel  # noqa: E402
from modulationdetectioncnn_tpu.utils.checkpoint import load_tree  # noqa: E402

DEFAULT_SRC = os.path.join(ROOT, "artifacts", "ckpt_rml11_int8")
DEFAULT_OUT = os.path.join(ROOT, "modulationdetectioncnn_torch", "assets",
                           "rml11_int8.npz")


def export(src: str = DEFAULT_SRC, out: str = DEFAULT_OUT) -> dict:
    tree = QuantizedModel.from_tree(load_tree(src)).tree()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez(out, **tree)
    return tree


def main(argv: list[str]) -> int:
    src = argv[0] if argv else DEFAULT_SRC
    out = argv[1] if len(argv) > 1 else DEFAULT_OUT
    tree = export(src, out)
    for k, v in sorted(tree.items()):
        print(f"{k:4s} {str(v.shape):14s} {v.dtype}")
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
