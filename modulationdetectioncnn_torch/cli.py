"""CLI of the port: ``python -m modulationdetectioncnn_torch <cmd> [key=value ...]``.

Commands:

- ``train``: train the float VT-CNN2 on the configured dataset's training
  split (``train_test_split(test_frac=0.2)``), the whole split resident on
  the device, with the in-training eval on the held-out part; with
  ``train.checkpoint_dir`` it resumes from the newest step there and saves
  every ``train.checkpoint_every`` steps (``<dir>/<step>/params.npz`` and
  ``opt_state.npz``, the 3 newest kept). Records go to stderr (and
  ``train.log_jsonl``), a summary JSON line to stdout;
- ``qat``: quantization-aware fine-tuning of the checkpoint in
  ``train.checkpoint_dir`` (``train.num_steps`` steps of Adam at
  ``train.learning_rate``), saved to ``<checkpoint_dir>_qat`` at step 0,
  which ``quantize train.checkpoint_dir=<dir>_qat`` then exports;
- ``eval``: sweep the configured dataset (with ``eval.test_split=0.2``, its
  held-out test part) with ``eval.backend`` (``flax``,
  the torch float model restored from ``train.checkpoint_dir``; ``golden``,
  the NumPy float forward of the same parameters; ``int8``, the CUDA
  kernels that ``eval.int8_kernel`` (v1 to v10) names on
  ``eval.int8_artifact``, default the committed artifact), write ``eval.results_path`` and print the
  per-SNR curve and the headline JSON;
- ``quantize``: post-training int8 quantization of the checkpoint in
  ``train.checkpoint_dir``, written to ``<checkpoint_dir>_int8``, with the
  int8-vs-float agreement printed as JSON;
- ``stream``: the streaming demo through the int8 CUDA kernels (with
  ``stream.resample_up/down`` the wideband resampler in front, with
  ``stream.normalize_timing=true`` the per-frame timing correction); with
  ``AMC_TRACE_DIR=<dir>`` it runs under ``utils/profiler.py::trace`` and
  writes the command's Chrome trace and span summary there;
- ``bench``: the port's benchmark (``bench.py``: one JSON contract line on
  stdout, calibration and the stream chain's rate on stderr);
- ``scaling``: the bench's measured one-card rate (quietly, by default the
  v7/v10 calibration), then ``eval/scaling.py::scaling_report``: the stream
  and data-parallel training efficiency over cards and hosts projected from
  that rate, the card's training rate and the H100's link constants,
  printed as indented JSON.

Overrides use the JAX package's names, plus ``device=``:

    python -m modulationdetectioncnn_torch train data.classes=BPSK,QPSK \
        model.num_classes=2 train.num_steps=200 train.checkpoint_dir=/tmp/ck
    python -m modulationdetectioncnn_torch quantize train.checkpoint_dir=/tmp/ck
    python -m modulationdetectioncnn_torch eval eval.backend=int8 \
        eval.int8_kernel=v1 eval.int8_artifact=/tmp/ck_int8 \
        data.classes=BPSK,QPSK model.num_classes=2
    python -m modulationdetectioncnn_torch qat train.checkpoint_dir=/tmp/ck \
        train.num_steps=50 data.classes=BPSK,QPSK model.num_classes=2
    python -m modulationdetectioncnn_torch bench pallas_bf16_v4
    python -m modulationdetectioncnn_torch bench bench.backend=pallas_bf16
    python -m modulationdetectioncnn_torch eval eval.backend=int8 eval.int8_kernel=v5
    python -m modulationdetectioncnn_torch eval \\
        train.checkpoint_dir=modulationdetectioncnn_torch/assets/ckpt_rml11_r5
    python -m modulationdetectioncnn_torch eval eval.backend=int8 eval.int8_kernel=v5 \\
        data.frames_per_class_per_snr=4000 eval.test_split=0.2  # the artifacts' split
    python -m modulationdetectioncnn_torch quantize \\
        train.checkpoint_dir=modulationdetectioncnn_torch/assets/ckpt_rml11_r5
    python -m modulationdetectioncnn_torch stream
    python -m modulationdetectioncnn_torch stream device=cpu eval.int8_kernel=v10
    python -m modulationdetectioncnn_torch stream stream.normalize_timing=true
    python -m modulationdetectioncnn_torch stream stream.resample_up=1 stream.resample_down=2
    python -m modulationdetectioncnn_torch eval eval.backend=int8 eval.int8_kernel=v3
    python -m modulationdetectioncnn_torch bench
    python -m modulationdetectioncnn_torch bench pallas_int8_v9
    python -m modulationdetectioncnn_torch bench pallas_int8   # v2 logits + argmax
    python -m modulationdetectioncnn_torch bench device=cpu bench.batch_size=64
    python -m modulationdetectioncnn_torch scaling
    python -m modulationdetectioncnn_torch scaling device=cpu bench.batch_size=64

Every command runs on the card unless ``device=cpu`` is given. As in the
JAX package, words without ``=`` are ignored (with a warning on stderr),
except by ``bench``, which reads a bare word as a backend name or as
``stream`` (``bench.py::parse_args``).

Under ``torchrun`` with more than one rank the process group is initialized
from its environment, and ``train`` runs on the mesh that ``mesh.data``,
``mesh.model`` (and ``mesh.time``) give, one rank per process:

    torchrun --nproc-per-node 4 -m modulationdetectioncnn_torch train \
        mesh.data=2 mesh.model=2 data.classes=BPSK,QPSK model.num_classes=2
    torchrun --nproc-per-node 2 -m modulationdetectioncnn_torch train device=cpu \
        mesh.data=2 data.classes=BPSK,QPSK model.num_classes=2
"""
from __future__ import annotations

import json
import logging
import sys

import numpy as np
import torch

from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
from modulationdetectioncnn_torch.device import resolve_device

COMMANDS = ("train", "eval", "quantize", "qat", "stream", "bench", "scaling")
EVAL_BACKENDS = ("flax", "golden", "int8")


def _build_dataset(cfg: AmcConfig, snrs=None):
    """``(x, y, snr, classes)``: the configured dataset, or with ``snrs`` the
    synthetic one at those SNRs alone (the JAX CLI's ``snrs``)."""
    from modulationdetectioncnn_torch.data import synthetic
    from modulationdetectioncnn_torch.data.radioml import load_dataset

    if snrs is not None:
        x, y, s = synthetic.make_dataset(cfg.data, snrs=snrs)
        return x, y, s, cfg.data.classes
    return load_dataset(cfg.data)


def cmd_train(cfg: AmcConfig, snrs=None):
    """Train on the configured dataset's training split (with ``snrs``, the
    synthetic one at those SNRs), evaluating on the held-out part. Returns
    (model, records, (x, y, snr) held out, classes)."""
    from modulationdetectioncnn_torch.data.synthetic import train_test_split
    from modulationdetectioncnn_torch.train import loop

    resolve_device(cfg.device)
    x, y, s, classes = _build_dataset(cfg, snrs)
    logging.getLogger("amc").info("dataset: %s frames, %d classes", x.shape, len(classes))
    (xtr, ytr, _), (xte, yte, ste) = train_test_split(x, y, s, test_frac=0.2)
    model, history = loop.train(cfg, (xtr, ytr), (xte, yte))
    print(json.dumps({"train": history[-1] if history else None,
                      "checkpoint_dir": cfg.train.checkpoint_dir}))
    return model, history, (xte, yte, ste), classes


def load_float_model(cfg: AmcConfig):
    """The float VT-CNN2 of ``train.checkpoint_dir``'s newest step, in eval
    mode on ``cfg.device``."""
    from modulationdetectioncnn_torch.utils.checkpoint import restore_model

    if not cfg.train.checkpoint_dir:
        raise SystemExit("this command requires train.checkpoint_dir=<dir>")
    restored = restore_model(cfg.train.checkpoint_dir, cfg.model,
                             cfg.data.frame_len, resolve_device(cfg.device))
    if restored is None:
        raise SystemExit(f"no checkpoint found in {cfg.train.checkpoint_dir}")
    model, step = restored
    print(f"restored checkpoint step {step}", file=sys.stderr)
    return model


def _float_labels(model, xb: np.ndarray) -> np.ndarray:
    dev = next(model.parameters()).device
    with torch.no_grad():
        return model(torch.from_numpy(xb).to(dev)).argmax(-1).cpu().numpy()


def make_predict_fn(cfg: AmcConfig, model=None):
    """The (B, 2, T) float32 -> (B,) labels predictor of ``eval.backend``
    (NumPy in, NumPy out), as the harness calls it."""
    backend = cfg.eval.backend
    if backend == "flax":
        return lambda xb: _float_labels(model, xb)
    if backend == "golden":
        from modulationdetectioncnn_torch.golden import cnn as gcnn
        from modulationdetectioncnn_torch.models.vtcnn2 import flax_params

        p = flax_params(model)
        return lambda xb: gcnn.vtcnn2_predict(p, xb)
    if backend == "int8":
        from modulationdetectioncnn_torch.ops.infer import make_int8_predict
        from modulationdetectioncnn_torch.quant import load_int8

        classify = make_int8_predict(load_int8(cfg.eval.int8_artifact, cfg.device),
                                     cfg.eval.int8_kernel)
        return lambda xb: classify(torch.from_numpy(xb)).cpu().numpy()
    raise SystemExit(f"unknown eval.backend {backend!r}; use {'/'.join(EVAL_BACKENDS)}")


def cmd_eval(cfg: AmcConfig) -> tuple[dict, np.ndarray]:
    """Sweep the configured dataset, or with ``eval.test_split`` its held-out
    test part; write and print the results. Returns the results dict and
    the predicted labels, in the order of the frames swept."""
    from modulationdetectioncnn_torch.data.synthetic import train_test_split
    from modulationdetectioncnn_torch.eval import harness

    resolve_device(cfg.device)
    if cfg.eval.backend not in EVAL_BACKENDS:
        raise SystemExit(f"unknown eval.backend {cfg.eval.backend!r}; "
                         f"use {'/'.join(EVAL_BACKENDS)}")
    model = load_float_model(cfg) if cfg.eval.backend != "int8" else None
    predict = make_predict_fn(cfg, model)
    x, y, s, classes = _build_dataset(cfg)
    if cfg.eval.test_split:
        _, (x, y, s) = train_test_split(x, y, s, test_frac=cfg.eval.test_split)
    pred = harness.predict_all(predict, x, cfg.eval.batch_size)
    result = harness.score(pred, y, s, classes)
    harness.save_results(result, cfg.eval.results_path)
    print(harness.format_curve(result))
    print(json.dumps(result["headline"]))
    return result, pred


def calibration_frames(cfg: AmcConfig) -> np.ndarray:
    """``quantize``'s calibration set: ``calib_frames // (classes * 3)``
    frames per class at 0, 10 and 18 dB, seed ``data.seed + 99``."""
    from modulationdetectioncnn_torch.data import synthetic

    x, _, _ = synthetic.make_dataset(
        cfg.data,
        frames_per_class_per_snr=max(1, cfg.quant.calib_frames // (len(cfg.data.classes) * 3)),
        snrs=[0, 10, 18], seed=cfg.data.seed + 99)
    return x


def cmd_quantize(cfg: AmcConfig, out_dir: str | None = None) -> tuple[str, float]:
    """PTQ: checkpoint -> int8 artifact (``<out_dir>/int8.npz``, default
    ``<checkpoint_dir>_int8``) and the int8-vs-float label agreement on the
    first 1024 calibration frames, the int8 side through the kernels of
    ``eval.int8_kernel``."""
    from modulationdetectioncnn_torch.ops.infer import make_int8_predict
    from modulationdetectioncnn_torch.quant import int8_weights_from_numpy
    from modulationdetectioncnn_torch.train.quant import quantize

    dev = resolve_device(cfg.device)
    model = load_float_model(cfg)
    calib_x = calibration_frames(cfg)
    qm = quantize(model, calib_x, cfg.quant.act_percentile)
    out_dir = out_dir or (cfg.train.checkpoint_dir.rstrip("/") + "_int8")
    qm.save(out_dir)
    xs = calib_x[:1024]
    classify = make_int8_predict(int8_weights_from_numpy(qm, dev), cfg.eval.int8_kernel)
    pred_q = classify(torch.from_numpy(xs)).cpu().numpy()
    agree = float((pred_q == _float_labels(model, xs)).mean())
    print(json.dumps({"int8_artifact": out_dir, "agreement_vs_float": agree}))
    return out_dir, agree


def cmd_qat(cfg: AmcConfig) -> str:
    """QAT fine-tune of the float checkpoint, saved to
    ``<checkpoint_dir>_qat`` at step 0 (parameters only); returns that
    directory."""
    from modulationdetectioncnn_torch.train.qat import finetune_qat
    from modulationdetectioncnn_torch.train.quant import calibrate_activations
    from modulationdetectioncnn_torch.utils import checkpoint as ckpt

    model = load_float_model(cfg)
    x, y, _, _ = _build_dataset(cfg)
    calib = x[::max(1, len(x) // cfg.quant.calib_frames)]
    scales = calibrate_activations(model, calib, cfg.quant.act_percentile)
    tuned = finetune_qat(
        model.state_dict(), scales, x, y, num_steps=cfg.train.num_steps,
        batch_size=cfg.train.batch_size, learning_rate=cfg.train.learning_rate,
        seed=cfg.train.seed, dropout_rate=cfg.model.dropout_rate)
    out_dir = cfg.train.checkpoint_dir.rstrip("/") + "_qat"
    ckpt.save(out_dir, 0, tuned)
    logging.getLogger("amc").info("QAT-tuned checkpoint saved to %s", out_dir)
    print(json.dumps({"qat_checkpoint": out_dir}))
    return out_dir


def cmd_stream(cfg: AmcConfig):
    """The stream demo; with ``AMC_TRACE_DIR`` set, under ``trace()``: the
    command's Chrome trace (the program's ``amc.*`` spans beside its device
    work) and its span summary are written there."""
    from modulationdetectioncnn_torch.dsp import pipeline
    from modulationdetectioncnn_torch.utils.profiler import trace

    with trace():
        return pipeline.run_stream_demo(cfg)


def cmd_bench(cfg: AmcConfig) -> dict:
    """The port's benchmark on ``cfg`` (``bench.run``); returns its contract
    line. ``main`` reads ``bench``'s bare words itself (``bench.main``)."""
    from modulationdetectioncnn_torch import bench

    return bench.run(cfg)


def cmd_scaling(cfg: AmcConfig) -> dict:
    """The bench's rate on ``cfg.device``, then the scaling report from it,
    printed as indented JSON; returns the report."""
    from modulationdetectioncnn_torch import bench
    from modulationdetectioncnn_torch.eval.scaling import scaling_report

    rate = bench.run(cfg, quiet=True)["value"]
    report = scaling_report(cfg, measured_chip_rate=float(rate))
    print(json.dumps(report, indent=1))
    return report


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, *overrides = argv
    if cmd not in COMMANDS:
        raise SystemExit(f"unknown command {cmd!r}; use {'/'.join(COMMANDS)}")
    if cmd == "bench":
        from modulationdetectioncnn_torch import bench

        return bench.main(overrides)
    bare = [o for o in overrides if "=" not in o]
    if bare:
        print(f"ignoring {' '.join(bare)}: overrides are key=value", file=sys.stderr)
    try:
        cfg = apply_overrides(AmcConfig(), [o for o in overrides if "=" in o])
    except (KeyError, ValueError, TypeError) as e:
        raise SystemExit(f"bad override: {e}") from e
    if cmd in ("train", "qat"):      # their progress records, on stderr
        logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                            format="%(asctime)s %(name)s %(levelname)s %(message)s")
    # Under torchrun with more than one rank: the process group (NCCL on the
    # cards, gloo with device=cpu), which train's mesh.* needs.
    import torch.distributed as dist

    from modulationdetectioncnn_torch.parallel.mesh import init_from_env

    owned = init_from_env(cfg.device)
    try:
        {"train": cmd_train, "eval": cmd_eval, "quantize": cmd_quantize, "qat": cmd_qat,
         "stream": cmd_stream, "scaling": cmd_scaling}[cmd](cfg)
    finally:
        if owned:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
