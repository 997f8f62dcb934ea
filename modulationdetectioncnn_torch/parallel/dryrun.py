"""The multi-rank dryrun: one full training step on a (data, model) mesh,
then the time-sharded stream.

Counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``
(which ``halo.dryrun`` follows there too). Run it on every rank:

    torchrun --nproc-per-node 4 -m modulationdetectioncnn_torch.parallel.dryrun
    torchrun --nproc-per-node 2 -m modulationdetectioncnn_torch.parallel.dryrun device=cpu

Without ``torchrun`` it runs on one rank.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from modulationdetectioncnn_torch.config import MeshConfig
from modulationdetectioncnn_torch.device import resolve_device
from modulationdetectioncnn_torch.parallel import halo
from modulationdetectioncnn_torch.parallel import mesh as pmesh


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> float:
    """On a mesh of ``n_devices`` ranks, (data = n/2, model = 2) when n is
    even, else (n, 1): the full-width bf16 VT-CNN2 sharded by the VT-CNN2
    rules, Adam at 1e-3 (the JAX dryrun's optax.adam), one training step on
    8 seeded frames per rank with dropout; then ``halo.dryrun`` on the same
    ranks. Returns the step's loss (this rank's slice; > 0)."""
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2
    from modulationdetectioncnn_torch.train.loop import AdamW, make_train_step

    dev = resolve_device(device)
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = pmesh.make_mesh(MeshConfig(data=n_devices // model_axis, model=model_axis,
                                      time=1), dev)
    model = VTCNN2(generator=torch.Generator().manual_seed(0)).to(dev)
    sharded = pmesh.shard_params(model, mesh)
    opt = AdamW(lambda count: 1e-3)
    opt_state = opt.init(dict(sharded.named_parameters()))
    batch = 8 * n_devices
    x = np.random.default_rng(0).standard_normal((batch, 2, 128)).astype(np.float32)
    y = np.random.default_rng(1).integers(0, 11, size=batch)
    generator = torch.Generator(device=dev).manual_seed(2)
    loss, _ = make_train_step(sharded, opt, mesh)(opt_state, (x, y), generator)
    loss = float(loss)
    if not loss > 0.0:
        raise RuntimeError(f"dryrun step: loss {loss}")
    halo.dryrun(mesh)
    return loss


def main(argv: list[str] | None = None) -> int:
    """``python -m modulationdetectioncnn_torch.parallel.dryrun [device=cpu]``
    on every rank: prints one JSON line per rank."""
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "device=cpu" in argv else "cuda"
    pmesh.ensure_process_group(device)
    n = dist.get_world_size()
    loss = dryrun_multichip(n, device)
    print(json.dumps({"dryrun_multichip": "ok", "rank": dist.get_rank(), "world": n,
                      "backend": dist.get_backend(), "loss": loss}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
