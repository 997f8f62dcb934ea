"""One rank of tests/test_torch_parallel.py: a process of its own on the CPU,
in a gloo group initialized from a file store.

    python tests/torch_parallel_worker.py SCENARIO RANK WORLD STORE_FILE OUT_DIR

Runs the scenario's checks with the port's parallel paths and writes what
the tests compare to OUT_DIR/rank<RANK>.npz. Imports torch and the port
only (no JAX), so a rank starts in about a second.
"""
from __future__ import annotations

import os
import sys
import warnings
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from modulationdetectioncnn_torch.config import (  # noqa: E402
    AmcConfig, MeshConfig, StreamConfig, apply_overrides)
from modulationdetectioncnn_torch.dsp import pipeline  # noqa: E402
from modulationdetectioncnn_torch.dsp.framer import to_planes  # noqa: E402
from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2  # noqa: E402
from modulationdetectioncnn_torch.parallel import halo  # noqa: E402
from modulationdetectioncnn_torch.parallel import mesh as pmesh  # noqa: E402

# tests/test_halo.py's stream configurations and block per rank.
SC_PLAIN = StreamConfig(num_subbands=8, taps_per_branch=8, block_len=8 * 128)
SC_RESAMPLED = StreamConfig(num_subbands=8, taps_per_branch=8, resample_up=2,
                            resample_down=3, fir_taps=33, block_len=8 * 128 * 3)
# tests/test_model_sharding.py's training configuration.
TRAIN_BASE = ["device=cpu", "data.classes=BPSK,QPSK", "model.num_classes=2",
              "model.conv1_filters=32", "model.conv2_filters=16", "model.dense_units=32",
              "model.dtype=float32", "model.dropout_rate=0.1", "train.batch_size=64",
              "train.warmup_steps=5"]
DEMO_BLOCK = 8192


def wideband(t_len: int, seed: int = 9) -> np.ndarray:
    """tests/test_halo.py's signal: a carrier at 0.19 over noise."""
    r = np.random.default_rng(seed)
    n = np.arange(t_len)
    x = np.exp(2j * np.pi * 0.19 * n) + 0.4 * (r.standard_normal(t_len)
                                                + 1j * r.standard_normal(t_len))
    return x.astype(np.complex64)


def float_predictor():
    """A seeded float32 VT-CNN2's argmax (tests/test_halo.py's predictor)."""
    model = VTCNN2(dtype="float32", generator=torch.Generator().manual_seed(1)).eval()

    @torch.no_grad()
    def predict(xb):
        return model(xb).argmax(-1)

    return predict


def sharded_vs_single(sc: StreamConfig, world: int, t_local: int) -> dict:
    x = to_planes(wideband(world * t_local))
    predict = float_predictor()
    tm = halo.time_mesh(world, "cpu")
    return {"got": halo.classify_stream_sharded(x, predict, sc, tm).numpy(),
            "want": pipeline.classify_stream(x, predict, sc).numpy()}


def tp_forward(cfg: MeshConfig) -> dict:
    """The channel-sharded forward against the unsharded one on 64 seeded
    frames, in eval mode and in train mode (dropout masks from one seed)."""
    mesh = pmesh.make_mesh(cfg, "cpu")
    model = VTCNN2(dtype="float32", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 2, 128))
                         .astype(np.float32))
    rows = pmesh.batch_sharding(mesh).rows(64)
    sharded = pmesh.shard_params(model, mesh)
    out = {"replicated_rows": pmesh.replicated(mesh).rows(64) == slice(0, 64)}
    with torch.no_grad():
        want = model.eval()(x)
        out["eval_err"] = float((sharded.eval()(x[rows]) - want[rows]).abs().max())
        out["scale"] = float(want.abs().max())
        model.train(), sharded.train()
        want = model(x, generator=torch.Generator().manual_seed(5))
        got = sharded(x[rows], generator=torch.Generator().manual_seed(5), rows=rows,
                      total=64)
        out["train_err"] = float((got - want[rows]).abs().max())
    gathered = pmesh.gather_model(sharded).state_dict()
    out["gather_equal"] = all(torch.equal(gathered[k], v) for k, v in model.state_dict().items())
    return out


def scenario_four(rank: int, world: int) -> dict:
    res = {}
    # The exchanged halo: the left neighbour's last 3 samples, zeros on rank 0.
    tm = halo.time_mesh(world, "cpu")
    t_local = 16
    x = torch.arange(world * t_local, dtype=torch.float32)
    res["halo"] = halo.left_halo_exchange(x[rank * t_local:(rank + 1) * t_local], 3,
                                          tm.get_group("time")).numpy()
    for k, v in sharded_vs_single(SC_PLAIN, world, 8 * 128 * 2).items():
        res[f"plain_{k}"] = v
    # The deployed int8 artifact through v7 on a demo-style signal (the JAX
    # side of the comparison runs in the test's own process).
    from modulationdetectioncnn_torch.ops.infer import make_int8_predict
    from modulationdetectioncnn_torch.quant import load_int8

    cfg = AmcConfig(device="cpu", stream=StreamConfig(block_len=DEMO_BLOCK))
    wide, _ = pipeline.make_demo_signal(cfg)
    res["v7_labels"] = halo.classify_stream_sharded(
        to_planes(wide), make_int8_predict(load_int8(device="cpu")), cfg.stream, tm).numpy()
    for k, v in tp_forward(MeshConfig(data=2, model=2)).items():
        res[f"tp22_{k}"] = v
    s14 = pmesh.shard_params(VTCNN2(generator=torch.Generator().manual_seed(0)),
                             pmesh.make_mesh(MeshConfig(data=1, model=4), "cpu"))
    res["shard_shapes"] = np.array([s14.conv1.weight.shape[0], s14.conv1.bias.shape[0],
                                    s14.conv2.weight.shape[1], s14.dense1.weight.shape[0],
                                    s14.dense2.weight.shape[1], s14.conv2.bias.shape[0]])
    try:
        pmesh.make_mesh(MeshConfig(data=4, model=2), "cpu")
    except ValueError as e:
        res["too_few_ranks"] = str(e)
    # Two hosts of two ranks (torchrun's LOCAL_WORLD_SIZE): the host count
    # and the floor's warning on a short per-rank block.
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    res["n_hosts"] = pipeline.n_hosts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sharded_vs_single(SC_PLAIN, world, 8 * 128 * 2)
    res["dcn_warning"] = any("multi-host floor" in str(w.message) for w in caught)
    del os.environ["LOCAL_WORLD_SIZE"]
    from modulationdetectioncnn_torch.parallel.dryrun import dryrun_multichip

    res["dryrun_loss"] = dryrun_multichip(world, "cpu")
    return res


def scenario_two(rank: int, world: int) -> dict:
    res = {}
    for k, v in sharded_vs_single(SC_PLAIN, world, 8 * 128 * 2).items():
        res[f"plain_{k}"] = v
    for k, v in sharded_vs_single(SC_RESAMPLED, world, 8 * 128 * 3).items():
        res[f"resampled_{k}"] = v
    for k, v in tp_forward(MeshConfig(data=1, model=2)).items():
        res[f"tp12_{k}"] = v
    return res


def scenario_train(rank: int, world: int) -> dict:
    """tests/test_model_sharding.py's two training runs, then the CLI's
    train on a mesh with a checkpoint and a resume."""
    from modulationdetectioncnn_torch import cli
    from modulationdetectioncnn_torch.data import synthetic
    from modulationdetectioncnn_torch.train import loop

    res = {}
    cfg = apply_overrides(AmcConfig(), TRAIN_BASE + ["train.num_steps=150",
                                                     "train.eval_every=50",
                                                     "mesh.data=2", "mesh.model=2"])
    x, y, _ = synthetic.make_dataset(cfg.data, snrs=[18], frames_per_class_per_snr=128)
    _, history = loop.train(cfg, (x, y))
    res["learn_loss"] = np.array([h["loss"] for h in history])
    res["learn_acc"] = np.array([h["train_acc"] for h in history])
    x, y, _ = synthetic.make_dataset(cfg.data, snrs=[18], frames_per_class_per_snr=96)
    short = ["train.num_steps=60", "train.eval_every=30"]
    for name, axes in (("tp", ["mesh.data=2", "mesh.model=2"]), ("dp", ["mesh.data=4"])):
        model, _ = loop.train(apply_overrides(AmcConfig(), TRAIN_BASE + short + axes), (x, y))
        for k, v in model.state_dict().items():
            res[f"{name}/{k}"] = v.numpy()
    ck = os.environ["AMC_TEST_CKPT"]
    tiny = ["train", *TRAIN_BASE, "mesh.data=2", "mesh.model=2",
            "data.frames_per_class_per_snr=16", "data.snr_db_min=10", "data.snr_db_max=18",
            "data.snr_db_step=8", "train.batch_size=16", "train.eval_every=2",
            "train.checkpoint_every=2", "train.warmup_steps=1", f"train.checkpoint_dir={ck}"]
    assert cli.main([*tiny, "train.num_steps=4"]) == 0
    _, history, _, _ = cli.cmd_train(apply_overrides(
        AmcConfig(), [*tiny[1:], "train.num_steps=6", "train.eval_every=1"]))
    res["resumed_steps"] = np.array([h["step"] for h in history])
    return res


SCENARIOS = {"four": scenario_four, "two": scenario_two, "train": scenario_train}


def main() -> None:
    scenario, rank, world, store, out = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                         sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        res = SCENARIOS[scenario](rank, world)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **{k: np.asarray(v) for k, v in res.items()})


if __name__ == "__main__":
    main()
