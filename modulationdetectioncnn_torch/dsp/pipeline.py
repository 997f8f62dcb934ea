"""Streaming classification pipeline (the product ``stream`` path).

Counterpart of the JAX ``dsp/pipeline.py`` for one process: continuous
wideband I/Q -> [rational FIR resampler] -> overlap-save blocks -> polyphase
channelizer -> per-subband framing -> per-frame power, CFO and [timing]
normalization -> int8 classifier. The bracketed stages are off by default
(``StreamConfig.resample_up/down``, ``normalize_timing``).

The load-bearing invariant: classifying a stream block by block, each block
carrying a halo of history, gives exactly the labels of classifying the
whole stream at once (``classify_stream_blocked`` == ``classify_stream``).
``plan_frontend`` composes that halo through the resampler (``fir_taps - 1``
upsampled-rate inputs of history), the channelizer (its FIR history) and
the framer (overlapping frames' reach).

The classifier is the int8 artifact through the CUDA kernels, or the float
model of a checkpoint that has no artifact yet, in bf16 through the fused
bf16 kernels where it fits them (``_make_predictor``). The
time-sharded path across ranks is ``parallel/halo.py``.
"""
from __future__ import annotations

import os
import time
from collections import Counter
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from modulationdetectioncnn_torch.config import (
    AmcConfig, DataConfig, RML_CLASSES, StreamConfig)
from modulationdetectioncnn_torch.device import resolve_device
from modulationdetectioncnn_torch.dsp import channelizer, fir, framer, normalize
from modulationdetectioncnn_torch.dsp.channelizer import design_prototype
from modulationdetectioncnn_torch.utils.profiler import span

Predictor = Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class FrontEndPlan:
    """Halo/trim bookkeeping for seamless blocked streaming."""
    m: int                # channelizer subbands
    up: int               # resample numerator
    down: int             # resample denominator
    frame_len: int
    hop: int
    halo_in: int          # wideband input samples of history per block
    trim_res: int         # resampled samples dropped right after resampling
    n_hist_sub: int       # subband samples of history kept after channelizing
    n_lead_frames: int    # invalid leading frames (zero history) to drop


def plan_frontend(sc: StreamConfig) -> FrontEndPlan:
    """Compose the input halo through resampler -> channelizer -> framer.

    The alignment of a block (block_len*up % down == 0, and the resulting
    subband count per block divisible by frame_hop) is checked by
    ``check_block_alignment``, not here."""
    m, up, down = sc.num_subbands, sc.resample_up, sc.resample_down
    f, hop = sc.frame_len, sc.frame_hop
    if f % hop != 0:
        raise ValueError(
            f"frame_hop ({hop}) must divide frame_len ({f}) for seamless "
            "overlapping-frame streaming")
    # Subband-rate history: channelizer FIR state + overlapping-frame reach.
    n_hist_sub = (sc.taps_per_branch - 1) + (f - hop)
    h_y = n_hist_sub * m                      # in resampled wideband samples
    if (up, down) == (1, 1):
        return FrontEndPlan(m, up, down, f, hop, h_y, 0, n_hist_sub,
                            (f - hop) // hop)
    # Resampled output y[j] needs inputs back to (j*down - Lr + 1)/up; exact
    # outputs from j = -h_y need halo_in*up >= h_y*down + Lr - 1, rounded so
    # the per-block decimation phase matches the full stream's
    # ((halo_in*up) % down == 0).
    halo_in = -(-(h_y * down + sc.fir_taps - 1) // up)
    while (halo_in * up) % down:
        halo_in += 1
    trim_res = halo_in * up // down - h_y
    return FrontEndPlan(m, up, down, f, hop, halo_in, trim_res, n_hist_sub,
                        (f - hop) // hop)


def n_hosts() -> int:
    """The hosts of this run (the JAX package's ``jax.process_count()``):
    ``WORLD_SIZE // LOCAL_WORLD_SIZE`` under an initialized process group
    started by ``torchrun``, else 1. Ranks on one host are not counted."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return max(1, world // max(1, local))


def effective_block_len(sc: StreamConfig, n_processes: int = 1) -> int:
    """Per-rank overlap-save block length under the multi-host policy.

    Within one host the configured ``block_len`` stands. Once the time axis
    spans hosts (``n_processes`` > 1, counted by ``n_hosts``), blocks are
    floored at ``block_len_dcn_floor``, so each hop's latency between hosts
    amortizes over a long block; the halo (~112 samples) is unchanged, and
    larger blocks cost nothing locally."""
    if n_processes <= 1:
        return sc.block_len
    return max(sc.block_len, sc.block_len_dcn_floor)


def halo_wideband(sc: StreamConfig) -> int:
    """Wideband input samples of history a block needs for seamless
    streaming through the full front end (resample, channelize, frame)."""
    return plan_frontend(sc).halo_in


def design_resampler(sc: StreamConfig) -> np.ndarray:
    """Anti-alias lowpass for the wideband up/down resampler (gain = up)."""
    cutoff = 0.5 / max(sc.resample_up, sc.resample_down)
    return fir.design_lowpass(sc.fir_taps, cutoff) * sc.resample_up


def batch_subband_len(sc: StreamConfig, t_len: int) -> int:
    """Subband-stream length the batch path produces for a T-sample input."""
    if (sc.resample_up, sc.resample_down) != (1, 1):
        t_len = -(-t_len * sc.resample_up // sc.resample_down)
    return t_len // sc.num_subbands


def total_frames(sc: StreamConfig, t_len: int) -> int:
    """Per-subband classification frames for a T-sample wideband input."""
    ts = batch_subband_len(sc, t_len)
    return max(0, (ts - sc.frame_len) // sc.frame_hop + 1)


def check_block_alignment(sc: StreamConfig, block: int) -> int:
    """Validate block length against the plan; returns subband samples/block."""
    m, up, down = sc.num_subbands, sc.resample_up, sc.resample_down
    if (block * up) % down != 0:
        raise ValueError("block_len*up must be divisible by resample_down")
    bs_wide = block * up // down
    if bs_wide % m != 0:
        raise ValueError("resampled block must align to subbands")
    bs = bs_wide // m
    if bs % sc.frame_hop != 0:
        raise ValueError("per-block subband samples must align to frame_hop")
    return bs


def _normalize_frames(fr: torch.Tensor, sc: StreamConfig) -> torch.Tensor:
    """Per-frame normalization chain: power -> CFO -> timing."""
    fr = normalize.power_normalize(fr)
    if sc.normalize_cfo:
        with span("amc.frontend.cfo"):
            fr = normalize.correct_cfo(
                fr, normalize.estimate_cfo(fr, pad_factor=sc.cfo_pad_factor))
    if sc.normalize_timing:
        with span("amc.frontend.timing"):
            tau = normalize.estimate_timing(fr, sc.sps)
            fr = normalize.correct_timing(fr, tau, sc.sps, sc.timing_phases)
    return fr


def subband_frames(x: torch.Tensor, h: np.ndarray, sc: StreamConfig) -> torch.Tensor:
    """Wideband I/Q planes (..., 2, T) -> (..., M, F, 2, frame_len)
    normalized frames: the whole-stream ('batch') reference path."""
    m = sc.num_subbands
    if (sc.resample_up, sc.resample_down) != (1, 1):
        x = fir.fir_resample_iq(x, design_resampler(sc), sc.resample_up,
                                sc.resample_down)
        x = x[..., :x.shape[-1] - x.shape[-1] % m]            # whole subbands
    sub = channelizer.channelize(x, h, m)                     # (..., 2, T/M, M)
    sub = torch.movedim(sub, -1, -3)                          # (..., M, 2, T/M)
    fr = framer.frames_from_stream(sub, sc.frame_len, sc.frame_hop)
    fr = fr.transpose(-2, -3)                                 # (..., M, F, 2, f)
    return _normalize_frames(fr, sc)


def block_frontend(xb: torch.Tensor, h: np.ndarray, hr: np.ndarray | None,
                   sc: StreamConfig, plan: FrontEndPlan) -> torch.Tensor:
    """Halo'd wideband blocks (..., 2, halo_in + B) -> normalized frames
    (..., M, F_b, 2, frame_len). ``hr`` is the resampler's lowpass
    (``design_resampler``), None when there is no resampling. Frame k of
    block b starts at global subband index b*Bs - (frame_len - hop) + k*hop."""
    if (plan.up, plan.down) != (1, 1):
        if hr is None:
            raise ValueError("a resampling plan needs the resampler's filter")
        xb = fir.fir_resample_iq(xb, hr, plan.up, plan.down)[..., plan.trim_res:]
    with span("amc.frontend.channelize"):
        sub = channelizer.channelize(xb, h, plan.m)
    sub = torch.movedim(sub, -1, -3)                   # (..., M, 2, hist + Bs)
    sub = framer.trim_halo(sub, sc.taps_per_branch - 1)
    fr = framer.frames_from_stream(sub, plan.frame_len, plan.hop)
    fr = fr.transpose(-2, -3)                          # (..., M, F_b, 2, f)
    return _normalize_frames(fr, sc)


def classify_stream(x: torch.Tensor, predict_fn: Predictor, sc: StreamConfig,
                    h: np.ndarray | None = None) -> torch.Tensor:
    """Classify every subband frame of a wideband stream at once (the batch
    reference for the streamed path). x: (2, T). Returns (M, F) labels."""
    h = h if h is not None else design_prototype(sc.num_subbands, sc.taps_per_branch)
    iq = subband_frames(x, h, sc)                             # (M, F, 2, f)
    m, f = iq.shape[0], iq.shape[1]
    labels = predict_fn(iq.reshape(m * f, 2, iq.shape[-1]))
    return labels.reshape(m, f)


def classify_stream_blocked(x: torch.Tensor, predict_fn: Predictor,
                            sc: StreamConfig,
                            h: np.ndarray | None = None) -> torch.Tensor:
    """Streamed classification via overlap-save blocks; label-exact against
    ``classify_stream``. x: (2, T) I/Q planes. Returns (M, F) labels. Under
    a profiler the call is the root span ``amc.stream``."""
    with span("amc.stream"):
        h = h if h is not None else design_prototype(sc.num_subbands, sc.taps_per_branch)
        plan = plan_frontend(sc)
        m = sc.num_subbands
        # The block floor between hosts is enforced here, not only documented.
        block = effective_block_len(sc, n_hosts())
        check_block_alignment(sc, block)
        hr = design_resampler(sc) if (plan.up, plan.down) != (1, 1) else None
        # (2, nb, halo+block) -> (nb, 2, halo+block)
        blocks = framer.overlap_save_blocks(x, block, plan.halo_in).transpose(0, 1)
        fr = block_frontend(blocks, h, hr, sc, plan)       # (nb, M, F_b, 2, f)
        nb, _, fb = fr.shape[:3]
        labels = predict_fn(fr.reshape(nb * m * fb, 2, fr.shape[-1]))
        # (nb, M, F_b) -> (M, nb*F_b); drop the zero-history lead-in frames and
        # any tail frames past the true stream end.
        labels = labels.reshape(nb, m, fb).transpose(0, 1).reshape(m, nb * fb)
        n_total = total_frames(sc, x.shape[-1])
        return labels[:, plan.n_lead_frames:plan.n_lead_frames + n_total]


# ------------------------------------------------------------------ demo

DEMO_OCCUPIED = {1: "BPSK", 5: "QPSK", 11: "GFSK"}


def make_demo_signal(cfg: AmcConfig) -> tuple[np.ndarray, dict[int, str]]:
    """The demo's wideband stream (complex64, 4 blocks long): BPSK/QPSK/GFSK
    carriers at the centres of subbands 1/5/11 over a noise floor. The same
    seed and draws as the JAX package's demo, so the same signal."""
    from modulationdetectioncnn_torch.data import synthetic

    sc = cfg.stream
    m = sc.num_subbands
    rng = np.random.default_rng(0)
    t_len = sc.block_len * 4
    n_sub_samples = t_len // m
    # GFSK rather than QAM16: the QAM16<->QAM64 twin collapse at 128-sample
    # frames is a known limit of the VT-CNN2 family, not a pipeline defect.
    occupied = DEMO_OCCUPIED if m >= 12 else {1: "BPSK"}
    wide = 0.02 * (rng.standard_normal(t_len) + 1j * rng.standard_normal(t_len))
    n = np.arange(t_len)
    h = design_prototype(m, sc.taps_per_branch)
    for k, mod in occupied.items():
        frames = synthetic.generate_frames(
            rng, mod, 1, snr_db=30.0, cfg=DataConfig(frame_len=n_sub_samples),
        )[0]
        up = np.zeros(t_len, dtype=np.complex128)
        up[::m] = frames  # sparse upsample: subband-rate signal
        up = np.convolve(up, h * m)[:t_len]
        wide = wide + up * np.exp(2j * np.pi * (k / m) * n)
    return wide.astype(np.complex64), occupied


FLOAT_FALLBACK_WARNING = (
    "WARNING: no int8 artifact (eval.int8_artifact or <checkpoint_dir>_int8) "
    "-- streaming with the FLOAT model, not the int8 kernels; run "
    "`quantize` to deploy.")


def int8_artifact_for(cfg: AmcConfig) -> str | None:
    """The int8 artifact the stream path deploys: ``eval.int8_artifact``
    when given, else ``<train.checkpoint_dir>_int8`` when it exists (what
    ``quantize`` writes), else None."""
    if cfg.eval.int8_artifact:
        return cfg.eval.int8_artifact
    if cfg.train.checkpoint_dir:
        cand = cfg.train.checkpoint_dir.rstrip("/") + "_int8"
        if os.path.isdir(cand):
            return cand
    return None


def resnet_route(model, dev: torch.device) -> str:
    """The route of a restored ``ResNetRML18`` on ``dev``:
    ``"resnet_chain_bf16"`` (``ops/residual_chain_bf16.py``: the fused
    chain on the card, then the head) for a model that computes in bf16 at
    the kernel's widths on a card; ``"module"`` (its own forward) for any
    other, on the CPU, in float32 or at other widths."""
    from modulationdetectioncnn_torch.ops.residual_chain_bf16 import fits_kernel

    if dev.type == "cuda" and model.dtype == torch.bfloat16 and fits_kernel(model.state_dict()):
        return "resnet_chain_bf16"
    return "module"


def _make_predictor(cfg: AmcConfig) -> Predictor:
    """The product stream classifier, chosen as the JAX package chooses it:

    1. the int8 artifact ``eval.int8_artifact``, else
       ``<train.checkpoint_dir>_int8`` when it exists, through the kernels
       that ``eval.int8_kernel`` names (default v7);
    2. else, with ``train.checkpoint_dir`` set, the float model of
       ``model.arch`` restored from it, with the JAX package's warning: a
       VT-CNN2 that computes in bf16 at widths the bf16 kernels fit
       (``fits_kernels``) through the fused bf16 classifier
       (``make_bf16_classifier_v4``; route ``"bf16_v4"``), a residual model
       as ``resnet_route`` picks (route ``"resnet_chain_bf16"``, the fused
       chain and the head, or ``"module"``), any other through the module's
       forward (route ``"module"``), which keeps a float32 model's precision
       and a wider model's widths;
    3. else the committed int8 artifact (``assets/rml11_int8.npz``).

    A named artifact or checkpoint that is missing raises. Under a profiler
    each call is the span ``amc.classifier.predict``. The float predictor
    names its route in its ``route`` attribute."""
    from modulationdetectioncnn_torch.ops.infer import make_int8_predict
    from modulationdetectioncnn_torch.ops.infer_bf16 import (
        fits_kernels, make_bf16_classifier_v4)
    from modulationdetectioncnn_torch.quant import load_int8

    art = int8_artifact_for(cfg)
    if art is None and cfg.train.checkpoint_dir:
        from modulationdetectioncnn_torch.utils.checkpoint import restore_model

        print(FLOAT_FALLBACK_WARNING, flush=True)
        dev = resolve_device(cfg.device)
        restored = restore_model(cfg.train.checkpoint_dir, cfg.model,
                                 cfg.data.frame_len, dev)
        if restored is None:
            raise FileNotFoundError(
                f"no checkpoint found in {cfg.train.checkpoint_dir!r}")
        model = restored[0]
        state = model.state_dict()
        classify, route = None, "module"
        if cfg.model.arch != "vtcnn2":
            route = resnet_route(model, dev)
            if route == "resnet_chain_bf16":
                from modulationdetectioncnn_torch.ops.residual_chain_bf16 import (
                    make_resnet_classifier)

                classify = make_resnet_classifier(state, dev)
        elif model.dtype == torch.bfloat16 and fits_kernels(state):
            classify, route = make_bf16_classifier_v4(state, dev), "bf16_v4"
        if classify is not None:
            def predict(x: torch.Tensor) -> torch.Tensor:
                with span("amc.classifier.predict"):
                    return classify(x)

            predict.route = route
            return predict

        @torch.no_grad()
        def predict(x: torch.Tensor) -> torch.Tensor:
            with span("amc.classifier.predict"):
                return model(x.to(dev)).argmax(-1).to(torch.int32)

        predict.route = "module"
        return predict
    qw = load_int8(art, cfg.device)
    classify = make_int8_predict(qw, cfg.eval.int8_kernel)

    def predict_int8(x: torch.Tensor) -> torch.Tensor:
        with span("amc.classifier.predict"):
            return classify(x)

    return predict_int8


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_stream_demo(cfg: AmcConfig) -> np.ndarray:
    """``stream``: synthesize a wideband signal carrying modulated carriers
    in a few subbands, classify every subband frame on ``cfg.device``,
    report occupancy and time. Returns the (M, F) labels."""
    dev = resolve_device(cfg.device)
    sc = cfg.stream
    m = sc.num_subbands
    wide, occupied = make_demo_signal(cfg)
    predict = _make_predictor(cfg)
    wide_iq = framer.to_planes(wide, dev)
    _sync(dev)
    t0 = time.perf_counter()
    labels = classify_stream_blocked(wide_iq, predict, sc)
    _sync(dev)
    dt = time.perf_counter() - t0
    labels = labels.cpu().numpy()
    sub = channelizer.channelize(wide_iq, design_prototype(m, sc.taps_per_branch), m)
    power = (sub[0] ** 2 + sub[1] ** 2).mean(dim=0).cpu().numpy()
    print("subband  power     top-label")
    for k in range(m):
        top = Counter(labels[k].tolist()).most_common(1)[0][0]
        mark = "*" if k in occupied else " "
        name = RML_CLASSES[top] if top < len(RML_CLASSES) else f"class {top}"
        print(f"  {k:3d}{mark}   {power[k]:8.4f}  {top} ({name})")
    print(f"classified {labels.size} frames ({wide.size} wideband samples) "
          f"in {dt:.3f}s wall on {dev.type} (a first run on cuda includes "
          "building the kernels)")
    return labels
