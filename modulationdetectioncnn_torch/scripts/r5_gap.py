"""Where the port's r5-length training parts from the JAX package's r5 run.

    python -m modulationdetectioncnn_torch.scripts.r5_gap grads [key=value ...] [out=FILE]
    python -m modulationdetectioncnn_torch.scripts.r5_gap curve steps=N [reduced=off] \\
        [cache=DIR] [key=value ...] out=DIR

``grads``: one training step of the configured model (the initial weights
of ``train.seed``) on ``train.batch_size`` synthesized frames, in
``model.dtype`` with cuBLAS's reduced-precision reductions for bf16 GEMMs
allowed (PyTorch's default) and disallowed, and in float64, each on the
same frames with the same dropout masks. Per parameter: the relative L2
distance of each gradient from the float64 one, beside that of the float64
gradient rounded to bf16 once (the least a bf16 gradient can be off). One
JSON line, also written to ``out`` when given.

``curve``: ``train/loop.py::train`` for the first ``steps`` steps of a run
of ``train.num_steps`` (by default the r5 run's 96,000, so the schedule is
that run's), on the configured dataset (cached in ``cache``, by default
``_checkout/r5``, where the flagship script caches it), with the in-training
records in ``DIR/train_rml11.jsonl`` to set beside
``artifacts/train_rml11_r5.jsonl``. ``reduced=off`` disallows the
reduced-precision reductions for the run.

Both run on the card unless ``device=cpu`` is given. The data and train
fields default to the r5 run's overrides.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
from modulationdetectioncnn_torch.device import resolve_device
from modulationdetectioncnn_torch.scripts import refuse_artifacts

R5 = ("data.frames_per_class_per_snr=4000", "train.num_steps=96000", "train.eval_every=1000")
DEFAULT_CACHE = os.path.join("_checkout", "r5")


def _reduced(on: bool) -> None:
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = on


def _step_grads(model, x, y, seed: int) -> dict[str, torch.Tensor]:
    """float64 gradients of one training step's loss, dropout masks drawn
    from a generator seeded with ``seed``."""
    from modulationdetectioncnn_torch.train import loop

    gen = torch.Generator(device=x.device).manual_seed(seed)
    model.train()
    model.zero_grad(set_to_none=True)
    loop.cross_entropy(model(x, generator=gen), y).backward()
    return {k: p.grad.detach().double() for k, p in model.named_parameters()}


def grads(cfg: AmcConfig) -> dict:
    from modulationdetectioncnn_torch.data import synthetic
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2

    dev = resolve_device(cfg.device)
    tc = cfg.train
    n_snr = len(range(cfg.data.snr_db_min, cfg.data.snr_db_max + 1, cfg.data.snr_db_step))
    per = -(-tc.batch_size // (len(cfg.data.classes) * n_snr))
    x, y, _ = synthetic.make_dataset(cfg.data, frames_per_class_per_snr=per)
    pick = np.random.default_rng(tc.seed).permutation(len(x))[:tc.batch_size]
    x = torch.from_numpy(x[pick]).to(dev)
    y = torch.from_numpy(y[pick]).long().to(dev)
    model = VTCNN2.from_config(cfg.model, cfg.data.frame_len,
                               generator=torch.Generator().manual_seed(tc.seed)).to(dev)
    ref = VTCNN2.from_config(dataclasses.replace(cfg.model, dtype="float32"),
                             cfg.data.frame_len)
    ref.dtype = torch.float64
    ref.load_state_dict(model.state_dict())
    ref = ref.double().to(dev)
    want = _step_grads(ref, x.double(), y, tc.seed)
    got = {}
    try:
        for on in (True, False):
            _reduced(on)
            got[on] = _step_grads(model, x, y, tc.seed)
    finally:
        _reduced(True)

    def rel(a: torch.Tensor, b: torch.Tensor) -> float:
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    rows = [{"param": k, "reduced_on": rel(got[True][k], w), "reduced_off": rel(got[False][k], w),
             "on_vs_off": rel(got[True][k], got[False][k]),
             "round_once": rel(w.to(torch.bfloat16).double(), w)}
            for k, w in want.items()]
    return {"mode": "grads", "dtype": cfg.model.dtype, "batch": tc.batch_size,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "params": rows}


def curve(cfg: AmcConfig, steps: int, out_dir: str, cache: str, reduced: bool) -> dict:
    from modulationdetectioncnn_torch.data import synthetic
    from modulationdetectioncnn_torch.scripts.train_eval_full import load_or_build_dataset
    from modulationdetectioncnn_torch.train import loop

    resolve_device(cfg.device)
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(cache, exist_ok=True)
    x, y, s, _ = load_or_build_dataset(cfg, cache)
    (xtr, ytr, _), held_out = synthetic.train_test_split(x, y, s, test_frac=0.2)
    horizon = cfg.train.num_steps
    log = os.path.join(out_dir, "train_rml11.jsonl")
    if os.path.exists(log):
        os.remove(log)
    run = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_steps=steps, log_jsonl=log, checkpoint_dir=None))
    make = loop.make_optimizer
    loop.make_optimizer = lambda c: make(dataclasses.replace(
        c, train=dataclasses.replace(c.train, num_steps=horizon)))
    t0 = time.time()
    try:
        _reduced(reduced)
        _, history = loop.train(run, (xtr, ytr), held_out[:2])
    finally:
        _reduced(True)
        loop.make_optimizer = make
    return {"mode": "curve", "steps": steps, "horizon": horizon, "reduced": reduced,
            "seed": cfg.train.seed, "dtype": cfg.model.dtype, "seconds": time.time() - t0,
            "records": history}


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv and "=" not in argv[0] else "grads"
    opts = dict(a.split("=", 1) for a in argv if "=" in a and a.split("=", 1)[0]
                in ("out", "steps", "reduced", "cache"))
    overrides = [a for a in argv if "=" in a and a.split("=", 1)[0] not in opts]
    cfg = apply_overrides(AmcConfig(), [*R5, *overrides])
    out = opts.get("out")
    if out:
        refuse_artifacts(out)
    if mode == "grads":
        result = grads(cfg)
    elif mode == "curve":
        if not out:
            raise SystemExit("curve needs out=DIR")
        result = curve(cfg, int(opts.get("steps", cfg.train.num_steps)), out,
                       opts.get("cache", DEFAULT_CACHE), opts.get("reduced", "on") != "off")
    else:
        raise SystemExit(f"unknown mode {mode!r}: grads or curve")
    line = json.dumps(result)
    print(line, flush=True)
    if out:
        path = out if mode == "grads" else os.path.join(out, "curve.json")
        with open(path, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
