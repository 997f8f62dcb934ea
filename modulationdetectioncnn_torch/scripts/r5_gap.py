"""Where the port's r5-length training parts from the JAX package's r5 run.

    python -m modulationdetectioncnn_torch.scripts.r5_gap grads [key=value ...] [out=FILE]
    python -m modulationdetectioncnn_torch.scripts.r5_gap curve steps=N [reduced=off] \\
        [cache=DIR] [key=value ...] out=DIR
    python -m modulationdetectioncnn_torch.scripts.r5_gap full [tf32=off] \\
        [key=value ...] out=DIR
    python -m modulationdetectioncnn_torch.scripts.r5_gap spread [out=FILE]

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

``full``: the whole flagship run, ``train_eval_full.main`` with the r5
overrides, the given keys and ``out=DIR``; ``tf32=off`` disallows TF32
for cuDNN's convolutions and cuBLAS's float32 matmuls for the whole run
and restores both settings after, else they stay as they are.
``DIR/full.json`` holds the two settings
in force, the relative error of a float32 conv2 (the model's shape) and of
a float32 matmul on the device against float64 under them, and the run's
summary. With ``model.dtype=float32`` and ``tf32=off`` that is a true
float32 run.

``spread``: the port's r5 records at the train seeds ``SPREAD_SEEDS`` (42
from ``assets/flagship_r5_h100/``, the others from
``assets/flagship_r5_h100_seeds/seed<s>/``) against the JAX r5 summary
(``artifacts/summary_rml11.json``): per seed the float headline and
``eval_acc`` at the last step, their min, max and mean, and the closing
rule of the 0 dB headline's gap: the JAX value lies within the seeds'
range, and the mean lies within ``SPREAD_BAND`` of it. The float32 run at
seed 42 (``f32_seed42/``) is reported beside it and does not enter the
rule. Written to ``FILE``, by default ``flagship_r5_h100_seeds/spread.json``.

The other modes run on the card unless ``device=cpu`` is given. The data
and train fields default to the r5 run's overrides.
"""
from __future__ import annotations

import dataclasses
import json
import logging
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
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ASSETS = os.path.join(REPO, "modulationdetectioncnn_torch", "assets")
SEEDS_DIR = os.path.join(ASSETS, "flagship_r5_h100_seeds")
JAX_SUMMARY = os.path.join(REPO, "artifacts", "summary_rml11.json")
SPREAD_SEEDS = (42, 43, 44, 45, 46)
SPREAD_BAND = 0.015
HEADLINES = ("acc_at_0dB", "acc_at_10dB", "acc_at_18dB")


def _reduced(on: bool) -> None:
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = on


def _set_tf32(cudnn: bool, matmul: bool) -> None:
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


def _tf32_settings() -> dict:
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def _float32_error(dev: torch.device) -> dict:
    """Relative L2 error against float64 of a float32 conv2 (256 channels
    of 2 x 126 to 80 of 1 x 124, taps 2 x 3) and of a float32 matmul of
    the dense1 layer's shape, under the settings in force: ~1e-7 in
    float32, ~1e-4 where TF32 rounds the inputs."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 256, 2, 126, generator=gen)
    w = torch.randn(80, 256, 2, 3, generator=gen)
    a = torch.randn(256, 9920, generator=gen)
    b = torch.randn(9920, 256, generator=gen)

    def rel(got: torch.Tensor, want: torch.Tensor) -> float:
        return float(torch.linalg.vector_norm(got.double().cpu() - want)
                     / torch.linalg.vector_norm(want))

    conv = torch.nn.functional.conv2d
    return {"conv2": rel(conv(x.to(dev), w.to(dev)), conv(x.double(), w.double())),
            "matmul": rel(a.to(dev) @ b.to(dev), a.double() @ b.double())}


def full(argv: list[str], out_dir: str, tf32_off: bool) -> dict:
    from modulationdetectioncnn_torch.scripts import train_eval_full

    cfg = apply_overrides(AmcConfig(), [*R5, *argv])
    dev = resolve_device(cfg.device)
    before = tuple(_tf32_settings().values())
    try:
        if tf32_off:
            _set_tf32(False, False)
        settings = _tf32_settings()
        error = _float32_error(dev)
        summary = train_eval_full.main([*R5, *argv, f"out={out_dir}"])
    finally:
        _set_tf32(*before)
    return {"mode": "full", "tf32": settings, "float32_rel_error_vs_float64": error,
            "seed": cfg.train.seed, "dtype": cfg.model.dtype,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "summary": summary}


def _read_run(path: str) -> dict:
    """A flagship record's float and int8 headlines, ``eval_acc`` at its
    last step and its median training rate over the record windows."""
    with open(os.path.join(path, "summary_rml11.json")) as f:
        summary = json.load(f)
    with open(os.path.join(path, "train_rml11.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return {"record": os.path.relpath(path, REPO),
            **{f"float_{k}": summary["float_headline"][k] for k in HEADLINES},
            **{f"int8_{k}": summary["int8_headline"][k] for k in HEADLINES},
            "last_step": records[-1]["step"], "eval_acc": records[-1]["eval_acc"],
            "median_window_samples_per_sec": float(np.median(
                [r["samples_per_sec"] for r in records]))}


def spread() -> dict:
    with open(JAX_SUMMARY) as f:
        jax_summary = json.load(f)
    ref = {**{f"float_{k}": jax_summary["float_headline"][k] for k in HEADLINES},
           "eval_acc": jax_summary["train_history_tail"][-1]["eval_acc"]}
    runs = {str(s): _read_run(os.path.join(ASSETS, "flagship_r5_h100") if s == 42
                              else os.path.join(SEEDS_DIR, f"seed{s}"))
            for s in SPREAD_SEEDS}
    stats = {}
    for key, want in ref.items():
        values = [r[key] for r in runs.values()]
        stats[key] = {"min": min(values), "max": max(values), "mean": float(np.mean(values)),
                      "reference": want, "mean_minus_reference": float(np.mean(values)) - want}
    a0 = stats["float_acc_at_0dB"]
    in_range = a0["min"] <= a0["reference"] <= a0["max"]
    in_band = abs(a0["mean_minus_reference"]) <= SPREAD_BAND
    result = {
        "reference_file": os.path.relpath(JAX_SUMMARY, REPO), "seeds": list(SPREAD_SEEDS),
        "runs": runs, "stats": stats,
        "rule": {"a_min_le_reference_le_max": in_range,
                 "b_abs_mean_minus_reference_le_band": in_band, "band": SPREAD_BAND},
        "verdict": "closed: seed spread, not a fault" if in_range and in_band else "open",
    }
    f32 = os.path.join(SEEDS_DIR, "f32_seed42")
    if os.path.isdir(f32):
        result["float32_tf32_off_seed42"] = _read_run(f32)
    return result


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
                in ("out", "steps", "reduced", "cache", "tf32"))
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
    elif mode == "full":
        if not out:
            raise SystemExit("full needs out=DIR")
        if opts.get("tf32", "off") != "off":
            raise SystemExit(f"tf32={opts['tf32']}: only tf32=off is taken")
        result = full(overrides, out, "tf32" in opts)
    elif mode == "spread":
        out = out or os.path.join(SEEDS_DIR, "spread.json")
        result = spread()
    else:
        raise SystemExit(f"unknown mode {mode!r}: grads, curve, full or spread")
    line = json.dumps(result)
    print(line, flush=True)
    if out:
        path = out if mode in ("grads", "spread") else os.path.join(out, f"{mode}.json")
        with open(path, "w") as f:
            f.write((json.dumps(result, indent=1) if mode == "spread" else line) + "\n")
    return result


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
