"""The port's benchmark: classified I/Q samples per second on one card.

Counterpart of the repo-root ``bench.py`` (the JAX package's harness), for
the PyTorch port. It prints ONE JSON line on stdout with the same keys:
``metric``, ``value``, ``unit``, ``vs_baseline`` (value / 1e9), ``backend``
and ``fallback`` (always false here), and its details on stderr:
``kernel_calibration`` (every candidate's median, in us per iteration), the
roofline against the H100's data-sheet peaks, and, in cnn mode, the
``stream_extra`` line (the stream chain's rate).

    python -m modulationdetectioncnn_torch.bench                 # cnn mode
    python -m modulationdetectioncnn_torch.bench stream          # stream mode
    python -m modulationdetectioncnn_torch.bench pallas_int8_v9  # one backend
    python -m modulationdetectioncnn_torch.bench pallas_bf16     # the bf16 v2 forward
    python -m modulationdetectioncnn_torch.bench pallas_bf16_v4  # the bf16 v4 classifier
    python -m modulationdetectioncnn_torch.bench device=cpu bench.batch_size=64

Backends keep the JAX package's names, so an override means the same in
both packages: ``pallas_int8_v3`` .. ``pallas_int8_v10`` name the port's
CUDA counterparts of those Pallas classifiers, ``pallas_int8`` the v2
forward's logits and their argmax, ``pallas_bf16`` the argmax of the bf16
v2 forward's logits (``ops/infer_bf16.py::make_bf16_forward_v2``: the
tap-row prologue in plain torch, then two CUDA kernels), ``xla_int8`` the
int8 chain from library ops (``ops/infer_xla.py``: ``torch._int_mm``, no
kernel of the port) and ``xla_bf16`` the torch VT-CNN2 in bf16
(cuBLAS/cuDNN); ``pallas_bf16_v4`` the bf16 v4 classifier (two CUDA
kernels). Both bf16 backends serve the float weights unquantized. As in the
JAX package, ``pallas_int8_v5`` and ``pallas_bf16_v4`` are accepted by name
but left out of ``BACKENDS``, and a name it does not know raises
``ValueError``. Weights are random (a ``torch.Generator`` seeded 0) and, for
the int8 backends, quantized by the port's PTQ on 256 seeded frames:
throughput does not depend on weight values.

A backend named on the command line is measured as asked: calibration runs
only when none is named. There is no retry and no fallback: a backend or a
calibration candidate that fails raises, and the bench exits non-zero.
"""
from __future__ import annotations

import json
import sys
import traceback

import numpy as np
import torch

from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
from modulationdetectioncnn_torch.device import resolve_device

TARGET_SAMPLES_PER_SEC = 1.0e9  # vs_baseline = value / 1 GS/s

# Backend -> make_int8_predict version ("v2": the argmax of the v2 logits).
INT8_BACKENDS = {"pallas_int8_v7": "v7", "pallas_int8_v9": "v9",
                 "pallas_int8_v10": "v10", "pallas_int8_v6": "v6",
                 "pallas_int8_v4": "v4", "pallas_int8_v5": "v5",
                 "pallas_int8_v3": "v3", "pallas_int8": "v2"}
# The JAX package's list; v5 and bf16 v4 are accepted by name but not
# listed.
BACKENDS = ("pallas_int8_v10", "pallas_int8_v7", "pallas_int8_v9",
            "pallas_int8_v6", "pallas_int8_v4", "pallas_int8_v3",
            "pallas_int8", "pallas_bf16", "xla_bf16", "xla_int8")
NAMED_ONLY = ("pallas_int8_v5", "pallas_bf16_v4")


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _frames_and_model(cfg: AmcConfig, batch: int):
    """The bench's frames (``batch`` from ``default_rng(0)``), that rng,
    and the random-init float VT-CNN2 (``torch.Generator`` seeded 0), on
    ``cfg.device``."""
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2

    dev = resolve_device(cfg.device)
    frame_len = cfg.data.frame_len
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.standard_normal((batch, 2, frame_len)).astype(np.float32)).to(dev)
    model = VTCNN2.from_config(cfg.model, frame_len,
                               generator=torch.Generator().manual_seed(0))
    return x, rng, model.to(dev).eval()


def make_int8_weights(cfg: AmcConfig, batch: int):
    """(int8 weights, frames) of the int8 backends: the float model
    quantized by PTQ on the rng's next 256 frames."""
    from modulationdetectioncnn_torch.quant import int8_weights_from_numpy
    from modulationdetectioncnn_torch.train.quant import quantize

    x, rng, model = _frames_and_model(cfg, batch)
    calib = rng.standard_normal((256, 2, cfg.data.frame_len)).astype(np.float32)
    qm = quantize(model, calib, cfg.quant.act_percentile)
    return int8_weights_from_numpy(qm, x.device), x


def make_classifier(cfg: AmcConfig, backend: str, batch: int):
    """(classifier, (input batch,)) for a named backend, on ``cfg.device``."""
    from modulationdetectioncnn_torch.ops.infer import argmax_lowest, make_int8_predict

    if backend not in BACKENDS and backend not in NAMED_ONLY:
        raise ValueError(f"unknown bench backend {backend!r}; use one of "
                         f"{', '.join(BACKENDS + NAMED_ONLY)}")
    if backend == "xla_bf16":
        x, _, model = _frames_and_model(cfg, batch)

        def classify(xb: torch.Tensor) -> torch.Tensor:
            return model(xb).argmax(-1)

        return classify, (x,)
    if backend == "pallas_bf16_v4":
        from modulationdetectioncnn_torch.ops.infer_bf16 import make_bf16_classifier_v4

        x, _, model = _frames_and_model(cfg, batch)
        return make_bf16_classifier_v4(model.state_dict(), x.device), (x,)
    if backend == "pallas_bf16":
        from modulationdetectioncnn_torch.ops.infer_bf16 import make_bf16_forward_v2

        x, _, model = _frames_and_model(cfg, batch)
        fwd = make_bf16_forward_v2(model.state_dict(), x.device)
        return (lambda xb: argmax_lowest(fwd(xb))), (x,)
    qw, x = make_int8_weights(cfg, batch)
    if backend == "xla_int8":
        from modulationdetectioncnn_torch.ops.infer_xla import make_int8_predict_xla

        return make_int8_predict_xla(qw), (x,)
    return make_int8_predict(qw, INT8_BACKENDS[backend]), (x,)


def _median(samples: list[float]) -> float:
    return sorted(samples)[len(samples) // 2]


def _measure(fwd, args, bc, frame_len: int):
    """Chained timing (utils/timing.py): each iteration's input carries a
    data dependency on the previous iteration's labels. The headline is the
    median of 5 (n1, n2) pair estimates."""
    from modulationdetectioncnn_torch.utils.timing import (
        measure_per_iter_chained_samples)

    x0 = args[-1]
    fixed = args[:-1]

    def body(xc):
        out = fwd(*fixed, xc)
        probe = out.reshape(-1)[0].to(torch.float32)
        return xc + probe * 1e-38

    samples = sorted(measure_per_iter_chained_samples(
        body, x0, n1=bc.warmup_iters, n2=bc.warmup_iters + bc.timed_iters,
        repeats=5))
    sec_per_iter = _median(samples)
    frames_per_sec = bc.batch_size / sec_per_iter
    return frames_per_sec, frames_per_sec * frame_len, {
        "samples_per_sec_min": round(bc.batch_size * frame_len / samples[0]),
        "timing_samples_us": [round(s * 1e6, 1) for s in samples],
    }


def _contract(metric: str, samples_per_sec: float, backend: str) -> dict:
    return {
        "metric": metric,
        "value": round(samples_per_sec),
        "unit": "samples/s",
        "vs_baseline": round(samples_per_sec / TARGET_SAMPLES_PER_SEC, 4),
        "backend": backend,
        "fallback": False,
    }


def run(cfg: AmcConfig | None = None, quiet: bool = False,
        backend: str | None = None) -> dict:
    """cnn mode (or stream mode, by ``bench.mode``): measure, print the
    contract line on stdout and the details on stderr, return the line.
    Calibration over ``bench.calibration_candidates`` runs when no
    ``backend`` is passed and ``bench.backend`` is one of them."""
    from modulationdetectioncnn_torch.utils.profiler import roofline

    cfg = cfg or AmcConfig()
    bc = cfg.bench
    dev = resolve_device(cfg.device)
    explicit = backend is not None
    backend = backend or bc.backend
    if bc.mode == "stream":
        return run_stream_bench(cfg, quiet=quiet, backend=backend)
    if bc.mode != "cnn":
        raise ValueError(f"unknown bench.mode {bc.mode!r}; use cnn or stream")

    measured: dict[str, tuple] = {}
    if (not explicit and bc.calibrate and backend in bc.calibration_candidates
            and len(bc.calibration_candidates) > 1):
        for cand in bc.calibration_candidates:
            fwd_c, args_c = make_classifier(cfg, cand, bc.batch_size)
            measured[cand] = _measure(fwd_c, args_c, bc, cfg.data.frame_len)
        backend = max(measured, key=lambda k: measured[k][1])
        if not quiet:
            print(json.dumps({
                "kernel_calibration": {
                    k: _median(v[2]["timing_samples_us"]) for k, v in measured.items()},
                "winner": backend}), file=sys.stderr)

    if backend in measured:
        frames_per_sec, samples_per_sec, spread = measured[backend]
    else:
        fwd, args = make_classifier(cfg, backend, bc.batch_size)
        frames_per_sec, samples_per_sec, spread = _measure(
            fwd, args, bc, cfg.data.frame_len)
    result = _contract("classified_iq_samples_per_sec_per_chip",
                       samples_per_sec, backend)
    if not quiet:
        print(json.dumps(result), flush=True)
        # The roofline is against the card's peaks: a CPU run has none.
        roof = roofline(samples_per_sec).as_dict() if dev.type == "cuda" else {}
        print(json.dumps({
            "backend": backend,
            "batch": bc.batch_size,
            "frames_per_sec": round(frames_per_sec),
            "device": device_name(dev),
            **roof,
            **spread,
        }), file=sys.stderr)
    return result


def run_stream_bench(cfg: AmcConfig, quiet: bool = False,
                     backend: str | None = None) -> dict:
    """The full chain ([resample ->] channelize -> frame -> normalize ->
    classify) on continuous wideband I/Q, samples/s, chained timing."""
    from modulationdetectioncnn_torch.dsp import pipeline
    from modulationdetectioncnn_torch.dsp.channelizer import design_prototype
    from modulationdetectioncnn_torch.utils.timing import (
        measure_per_iter_chained_samples)

    dev = resolve_device(cfg.device)
    backend = backend or cfg.bench.backend
    sc = cfg.stream
    m = sc.num_subbands
    if sc.frame_len != cfg.data.frame_len:
        raise ValueError("stream.frame_len must match the classifier's input "
                         "length (data.frame_len)")
    # Size the wideband block so the classifier sees ~bench.batch_size
    # frames per iteration.
    align = m * sc.frame_hop * max(sc.resample_down, 1)
    t_len = (cfg.bench.batch_size * sc.frame_len // align) * align
    h = design_prototype(m, sc.taps_per_branch)
    n_frames = pipeline.total_frames(sc, t_len) * m
    classify, _ = make_classifier(cfg, backend, cfg.bench.batch_size)

    def chain(xiq: torch.Tensor) -> torch.Tensor:
        fr = pipeline.subband_frames(xiq, h, sc)           # (M, F, 2, frame_len)
        return classify(fr.reshape(-1, 2, fr.shape[-1]))

    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((2, t_len)).astype(np.float32)).to(dev)

    def body(xc):
        probe = chain(xc).reshape(-1)[0].to(torch.float32)
        return xc + probe * 1e-38

    samples = measure_per_iter_chained_samples(
        body, x0, n1=cfg.bench.warmup_iters,
        n2=cfg.bench.warmup_iters + cfg.bench.timed_iters, repeats=5)
    samples_per_sec = t_len / _median(samples)
    result = _contract("streamed_iq_samples_per_sec_per_chip", samples_per_sec,
                       backend)
    if not quiet:
        print(json.dumps(result), flush=True)
        print(json.dumps({
            "mode": "stream", "subbands": m, "block_samples": t_len,
            "frames_per_iter": n_frames, "backend": backend,
            "device": device_name(dev),
            "timing_samples_us": [round(s * 1e6, 1) for s in sorted(samples)],
        }), file=sys.stderr)
    return result


def run_with_stream_extra(cfg: AmcConfig) -> dict:
    """``run``, then in cnn mode (with ``bench.stream_extra``) the stream
    chain's rate as one ``stream_extra`` line on stderr. A failure of that
    extra measurement is reported as ``stream_extra_error`` with its
    traceback; the contract line is already out."""
    result = run(cfg)
    if cfg.bench.mode != "stream" and cfg.bench.stream_extra:
        try:
            sres = run_stream_bench(cfg, quiet=True)
        except Exception as e:  # noqa: BLE001 -- reported, headline stands
            traceback.print_exc()
            print(json.dumps({"stream_extra_error": repr(e)}), file=sys.stderr)
        else:
            print(json.dumps({**sres, "mode": "stream_extra"}), file=sys.stderr)
    return result


def parse_args(argv: list[str]) -> AmcConfig:
    """``stream`` -> bench.mode=stream; ``key=value`` -> an override; any
    other word -> bench.backend. Naming a backend turns calibration off
    (unless ``bench.calibrate=true`` comes after it)."""
    overrides = []
    for arg in argv:
        if arg == "stream":
            overrides.append("bench.mode=stream")
        elif "=" in arg:
            overrides.append(arg)
        else:
            overrides.append(f"bench.backend={arg}")
    if any(o.startswith("bench.backend=") for o in overrides):
        overrides.insert(0, "bench.calibrate=false")
    return apply_overrides(AmcConfig(), overrides)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        cfg = parse_args(argv)
    except (KeyError, ValueError, TypeError) as e:
        raise SystemExit(f"bad override: {e}") from e
    run_with_stream_extra(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
