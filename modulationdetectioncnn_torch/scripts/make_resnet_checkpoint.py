"""Write the seeded checkpoint of the residual classifier at its published
widths (``models/resnet_rml18.py``): ``lecun_normal`` kernels and zero
biases from ``torch.Generator().manual_seed(seed)``, float32, as step 0.

    python3 -m modulationdetectioncnn_torch.scripts.make_resnet_checkpoint \\
        [--out modulationdetectioncnn_torch/assets/ckpt_resnet_rml18] [--seed 2018]

The committed ``assets/ckpt_resnet_rml18/0/params.npz`` is this script's
output with its defaults: weights drawn from a seed, never trained, so a
run on them is judged by agreement with the reference, not by accuracy.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from modulationdetectioncnn_torch.models.resnet_rml18 import ResNetRML18
from modulationdetectioncnn_torch.utils import checkpoint

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "assets", "ckpt_resnet_rml18")
SEED = 2018


def make(out: str = ASSET, seed: int = SEED) -> str:
    """Write step 0 of the seeded model into ``out``; returns its directory."""
    model = ResNetRML18(generator=torch.Generator().manual_seed(seed))
    return checkpoint.save(out, 0, model.state_dict())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="make_resnet_checkpoint")
    p.add_argument("--out", default=ASSET)
    p.add_argument("--seed", type=int, default=SEED)
    a = p.parse_args(argv)
    print(make(a.out, a.seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
