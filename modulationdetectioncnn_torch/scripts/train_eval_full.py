"""The flagship pipeline on the card.

Counterpart of the JAX package's ``scripts/train_eval_full.py``:

1. the configured dataset (by default the 11-class synthetic one over -20
   .. +18 dB, 1000 frames per class and SNR), cached in ``DIR`` under the
   JAX script's name, then ``train_test_split(..., test_frac=0.2)``;
2. ``train/loop.py::train`` (checkpoints in ``DIR/ckpt_rml11``, records in
   ``DIR/train_rml11.jsonl``); run again with the same ``DIR`` and
   ``train.num_steps``, it reads the cached dataset and resumes from the
   newest checkpoint;
3. the float SNR sweep of the held-out split -> ``DIR/results.json``;
4. PTQ on ``cli.calibration_frames`` -> ``DIR/ckpt_rml11_int8/int8.npz``;
5. the int8 sweep through the kernels of ``eval.int8_kernel`` (default v7)
   -> ``DIR/results_int8.json``, the agreement of their labels on the first
   512 held-out frames with the plain chain (``make_int8_predict(...,
   interpret=True)``, which the CPU tests hold to the JAX package's integer
   reference), and ``DIR/summary_rml11.json`` with the JAX script's keys.

    python -m modulationdetectioncnn_torch.scripts.train_eval_full [key=value ...] [out=DIR]

``DIR`` defaults to ``chiprun_out/train_eval_full``. Nothing is written
elsewhere: not into ``artifacts/``, the JAX package's records, and not to a
``results.json`` at the repository's root, both of which the JAX script
writes. It runs on the card unless ``device=cpu`` is given.
"""
from __future__ import annotations

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

log = logging.getLogger("amc.full")

DEFAULT_OUT = os.path.join("chiprun_out", "train_eval_full")
AGREEMENT_FRAMES = 512


def dataset_cache(cfg: AmcConfig, out_dir: str) -> str:
    """The JAX script's cache file name, in ``out_dir``."""
    from modulationdetectioncnn_torch.data import synthetic

    return os.path.join(out_dir, f"dataset_v{synthetic.GENERATOR_VERSION}_"
                        f"{len(cfg.data.classes)}c_{cfg.data.frames_per_class_per_snr}f_"
                        f"seed{cfg.data.seed}.npz")


def load_or_build_dataset(cfg: AmcConfig, out_dir: str):
    """``(x, y, snr, classes)``: from the cache when it exists and no pickle
    is configured, else built by ``load_dataset`` (and cached, unless it
    came from a pickle)."""
    from modulationdetectioncnn_torch.data.radioml import load_dataset

    t0 = time.time()
    cache = dataset_cache(cfg, out_dir)
    if os.path.exists(cache) and not cfg.data.radioml_pickle:
        with np.load(cache, allow_pickle=False) as z:
            x, y, s = z["x"], z["y"], z["s"]
        classes = cfg.data.classes
        log.info("dataset %s loaded from cache in %.1fs", x.shape, time.time() - t0)
    else:
        x, y, s, classes = load_dataset(cfg.data)
        if not cfg.data.radioml_pickle:
            # Written beside the cache and renamed, so a run cut while
            # writing (~0.9 GB at 4000 frames per class and SNR) leaves no
            # torn file for the next run to load.
            tmp = f"{cache}.tmp-{os.getpid()}.npz"
            np.savez(tmp, x=x, y=y, s=s)
            os.replace(tmp, cache)
        log.info("dataset %s built in %.1fs", x.shape, time.time() - t0)
    return x, y, s, classes


def evaluate_and_quantize(model, held_out, classes, cfg: AmcConfig, out_dir: str,
                          history: list[dict] | None = None) -> dict:
    """Everything after training: the float sweep of ``held_out`` = (x, y,
    snr), PTQ, the int8 sweep through the kernels, their agreement with the
    plain chain, and the summary; writes ``results.json``,
    ``ckpt_rml11_int8/int8.npz``, ``results_int8.json`` and
    ``summary_rml11.json`` into ``out_dir`` and returns the summary."""
    from modulationdetectioncnn_torch.cli import calibration_frames
    from modulationdetectioncnn_torch.data import synthetic
    from modulationdetectioncnn_torch.eval import harness
    from modulationdetectioncnn_torch.ops.infer import make_int8_predict
    from modulationdetectioncnn_torch.train import loop
    from modulationdetectioncnn_torch.train.quant import quantize

    dev = resolve_device(cfg.device)
    xte, yte, ste = held_out
    bs = cfg.eval.batch_size
    eval_step = loop.make_eval_step(model)
    t0 = time.time()
    result = harness.snr_sweep(lambda xb: eval_step(xb).cpu().numpy(), xte, yte, ste,
                               classes, batch_size=bs)
    harness.save_results(result, os.path.join(out_dir, "results.json"))
    log.info("float sweep of %d frames in %.1fs", len(xte), time.time() - t0)
    print(harness.format_curve(result))
    print("float headline:", json.dumps(result["headline"]), flush=True)

    t0 = time.time()
    qm = quantize(model, calibration_frames(cfg), percentile=cfg.quant.act_percentile)
    qm.save(os.path.join(out_dir, "ckpt_rml11_int8"))
    log.info("int8 artifact saved to %s/ckpt_rml11_int8 in %.1fs", out_dir, time.time() - t0)

    kernel = cfg.eval.int8_kernel
    classify = make_int8_predict(qm, kernel, device=dev)

    def predict_q(xb: np.ndarray) -> np.ndarray:
        return classify(torch.from_numpy(xb)).cpu().numpy()

    t0 = time.time()
    result_q = harness.snr_sweep(predict_q, xte, yte, ste, classes, batch_size=bs)
    harness.save_results(result_q, os.path.join(out_dir, "results_int8.json"))
    log.info("int8 sweep (%s) of %d frames in %.1fs", kernel, len(xte), time.time() - t0)
    print(harness.format_curve(result_q))
    print("int8 headline:", json.dumps(result_q["headline"]), flush=True)

    t0 = time.time()
    xs = xte[:AGREEMENT_FRAMES]
    plain = make_int8_predict(qm, kernel, device="cpu", interpret=True)
    agreement = float((predict_q(xs) == plain(torch.from_numpy(xs)).numpy()).mean())
    log.info("agreement with the plain chain on %d frames in %.1fs", len(xs), time.time() - t0)
    deltas = {k: None if result["headline"][k] is None
              else round(result_q["headline"][k] - result["headline"][k], 5)
              for k in result["headline"]}
    summary = {
        "float_headline": result["headline"],
        "int8_headline": result_q["headline"],
        "int8_minus_float": deltas,
        "int8_kernel": kernel,
        "int8_on_chip": dev.type == "cuda",
        # The JAX script's name, so the file compares with its summary.
        f"pallas_{kernel}_vs_golden_int8_agreement": agreement,
        "generator_version": synthetic.GENERATOR_VERSION,
        "train_history_tail": (history or [])[-3:],
    }
    with open(os.path.join(out_dir, "summary_rml11.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1), flush=True)
    return summary


def main(argv: list[str] | None = None) -> dict:
    """``[key=value ...] [out=DIR]``: the whole pipeline; returns the
    summary. Words without ``=`` are ignored, as in the JAX script."""
    from modulationdetectioncnn_torch.data import synthetic
    from modulationdetectioncnn_torch.train import loop

    argv = sys.argv[1:] if argv is None else argv
    out_dir = DEFAULT_OUT
    overrides = []
    for arg in argv:
        if arg.startswith("out="):
            out_dir = arg[len("out="):]
        elif "=" in arg:
            overrides.append(arg)
    refuse_artifacts(out_dir)
    cfg = apply_overrides(AmcConfig(), [
        f"train.checkpoint_dir={os.path.join(out_dir, 'ckpt_rml11')}",
        f"train.log_jsonl={os.path.join(out_dir, 'train_rml11.jsonl')}", *overrides])
    resolve_device(cfg.device)
    os.makedirs(out_dir, exist_ok=True)
    x, y, s, classes = load_or_build_dataset(cfg, out_dir)
    (xtr, ytr, _), held_out = synthetic.train_test_split(x, y, s, test_frac=0.2)
    t0 = time.time()
    model, history = loop.train(cfg, (xtr, ytr), held_out[:2])
    log.info("training to step %d in %.1fs", cfg.train.num_steps, time.time() - t0)
    # The whole run's records: a resumed run logs only its own steps, and
    # none when the checkpoint already stands at num_steps.
    history = loop.read_records(cfg.train.log_jsonl) or history
    return evaluate_and_quantize(model, held_out, classes, cfg, out_dir, history)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
