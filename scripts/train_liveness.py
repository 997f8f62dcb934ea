"""Train the VT-CNN2 with both packages' loops on the CPU and report how many
of each layer's activations are live (positive before the ReLU).

Both runs use one config and one synthetic dataset (the packages' generators
give equal frames); their random numbers differ, so the comparison is of
behaviour, not of bits. Over all 20 SNRs a few hundred steps kill most of
Dense1's units in both, which PTQ cannot scale; over 0..18 dB they learn.

    python scripts/train_liveness.py                        # -20..18 dB
    python scripts/train_liveness.py data.snr_db_min=0      # 0..18 dB

Needs JAX (CPU) and the repository on the path; prints one JSON line per
package: the loss every ``train.eval_every`` steps and the live shares.
"""
from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEFAULTS = ["data.frames_per_class_per_snr=10", "train.batch_size=256",
            "train.num_steps=160", "train.eval_every=20"]


def main(argv: list[str]) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
    from modulationdetectioncnn_torch.data import synthetic
    from modulationdetectioncnn_torch.train import loop as tloop
    from modulationdetectioncnn_tpu.config import AmcConfig as JAmcConfig
    from modulationdetectioncnn_tpu.config import apply_overrides as japply
    from modulationdetectioncnn_tpu.models import VTCNN2
    from modulationdetectioncnn_tpu.train import loop as jloop

    overrides = DEFAULTS + argv
    cfg = apply_overrides(AmcConfig(), ["device=cpu", *overrides])
    x, y, _ = synthetic.make_dataset(cfg.data)
    probe = x[:256]

    params, hist = jloop.train(japply(JAmcConfig(), overrides), (x, y), mesh=jloop.make_mesh(1))
    _, inter = VTCNN2.from_config(cfg.model).apply(params, jnp.asarray(probe),
                                                   capture_intermediates=True)
    live = {k: float((np.asarray(inter["intermediates"][k]["__call__"][0], np.float32) > 0)
                     .mean()) for k in ("Conv1", "Conv2", "Dense1")}
    print(json.dumps({"package": "jax", "overrides": overrides,
                      "loss": [h["loss"] for h in hist], "live_share": live}), flush=True)

    model, hist = tloop.train(cfg, (x, y))
    inter = {}
    with torch.no_grad():
        model(torch.from_numpy(probe), inter)
    live = {k: float((v > 0).float().mean()) for k, v in inter.items()}
    print(json.dumps({"package": "torch", "overrides": overrides,
                      "loss": [h["loss"] for h in hist], "live_share": live}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
