"""Frozen-dataclass configuration for the port, with ``key=value`` overrides.

The port's own copy of the fields of ``modulationdetectioncnn_tpu/config.py``
that its ported paths read, with the same names and defaults, so that an
override such as ``stream.num_subbands=8`` or ``bench.backend=pallas_int8_v10``
means the same thing to both packages. Every field of the JAX package's
``AmcConfig`` is here; ``device`` is the port's own.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Tuple

# The 11 RadioML-2016.10a classes, alphabetical (the dataset's own key order).
RML_CLASSES: Tuple[str, ...] = (
    "8PSK", "AM-DSB", "AM-SSB", "BPSK", "CPFSK", "GFSK",
    "PAM4", "QAM16", "QAM64", "QPSK", "WBFM",
)


@dataclass(frozen=True)
class ChannelConfig:
    """Channel impairments of the synthetic generator (RML2016.10a recipe:
    GNU Radio dynamic channel model at 200 kS/s)."""
    snr_db: float = 18.0
    max_cfo: float = 2.5e-3           # cycles/sample, clip of the CFO draw
    cfo_sigma: float = 2e-5           # CFO ~ N(0, cfo_sigma) clipped
    cfo_walk_std: float = 1e-5        # within-frame oscillator drift
    max_sro: float = 2.5e-4
    sro_sigma: float = 2e-5
    random_phase: bool = True
    random_timing: bool = True
    multipath: bool = True            # Rician K=4 3-tap multipath
    multipath_taps: int = 3
    multipath_delay_spread: float = 0.5
    rician_k: float = 4.0


@dataclass(frozen=True)
class DataConfig:
    """The dataset: ``data/synthetic.py::make_dataset`` (or a RadioML pickle,
    ``data/radioml.py``); the bench reads ``frame_len`` (the classifier's
    input length)."""
    classes: Tuple[str, ...] = RML_CLASSES
    frame_len: int = 128
    sps: int = 8                      # samples per symbol
    rrc_beta: float = 0.35            # RRC excess bandwidth
    rrc_span: int = 8                 # RRC filter span in symbols
    frames_per_class_per_snr: int = 1000
    snr_db_min: int = -20
    snr_db_max: int = 18
    snr_db_step: int = 2
    seed: int = 0
    channel: ChannelConfig = field(default_factory=ChannelConfig)
    # Optional path to a real RML2016.10a.pkl; synthetic data when None.
    radioml_pickle: str | None = None


@dataclass(frozen=True)
class ModelConfig:
    """The classifier: ``arch`` names the architecture, ``"vtcnn2"`` (the
    VT-CNN2-family conv-conv-dense topology, ``models/vtcnn2.py``) or
    ``"resnet_rml18"`` (the residual classifier of O'Shea, Roy and Clancy
    2018, ``models/resnet_rml18.py``). The widths below are VT-CNN2's; the
    residual classifier takes its published widths from its constructor."""
    arch: str = "vtcnn2"
    num_classes: int = 11
    conv1_filters: int = 256
    conv2_filters: int = 80
    dense_units: int = 256
    dropout_rate: float = 0.5
    # Compute dtype for activations; params stay fp32.
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class TrainConfig:
    """``train`` (``train/loop.py``) and ``qat`` (``train/qat.py``);
    ``eval``, ``quantize`` and the stream predictor restore from
    ``checkpoint_dir``."""
    batch_size: int = 1024
    num_steps: int = 3000
    learning_rate: float = 1e-3
    warmup_steps: int = 100
    weight_decay: float = 0.0
    seed: int = 42
    eval_every: int = 500
    # In-training eval runs on at most this many held-out frames (a fixed
    # seeded subsample, the JAX package's); 0 = the whole held-out split.
    eval_max_frames: int = 16384
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1000
    log_jsonl: str | None = None


@dataclass(frozen=True)
class QuantConfig:
    """Post-training int8 quantization (``quantize`` and the bench's PTQ)."""
    # Per-output-channel weight scales, the only scheme of either package's
    # quantizer (the JAX package's field, which it does not read either);
    # False is refused rather than ignored.
    weight_per_channel: bool = True
    act_percentile: float = 99.99     # calibration clip percentile
    calib_frames: int = 4096

    def __post_init__(self):
        if not self.weight_per_channel:
            raise ValueError("quant.weight_per_channel=false: the quantizer has "
                             "per-channel weight scales only")


@dataclass(frozen=True)
class StreamConfig:
    """Streaming front end. ``dsp/pipeline.py::plan_frontend`` and
    ``check_block_alignment`` validate these fields and raise ``ValueError``,
    as the JAX package's do."""
    num_subbands: int = 16            # polyphase channelizer branches
    taps_per_branch: int = 8          # prototype filter taps per branch
    # Rational up/down resampling of the wideband stream before the
    # channelizer; 1/1 = off. fir_taps sizes the anti-alias lowpass.
    resample_up: int = 1
    resample_down: int = 1
    fir_taps: int = 33
    frame_len: int = 128              # classification frame length
    frame_hop: int = 128              # must divide frame_len
    block_len: int = 1 << 15          # overlap-save block length (per rank)
    # Per-rank block length floor once the time axis spans hosts
    # (``dsp/pipeline.py::effective_block_len``): the halo is ~112 samples,
    # so large blocks cost nothing locally and amortize each hop's latency.
    block_len_dcn_floor: int = 1 << 20
    normalize_cfo: bool = True
    cfo_pad_factor: int = 4           # DFT size = frame_len * pad_factor
    # Per-frame Oerder & Meyr timing estimate and polyphase fractional-delay
    # correction (the 17-tap FIR is a CUDA kernel on the card); off by
    # default, as in the JAX package.
    normalize_timing: bool = False
    timing_phases: int = 32
    sps: int = 8                      # samples per symbol at the frame rate


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh of ranks (``parallel/mesh.py``): data x model x time."""
    data: int = 1                     # data parallelism over frames/batch
    model: int = 1                    # channel sharding (tensor parallelism)
    time: int = 1                     # time-block sharding of the stream


@dataclass(frozen=True)
class EvalConfig:
    # 'flax' (the torch float model, under the JAX package's name), 'int8'
    # (the CUDA kernels) or 'golden' (the NumPy float forward).
    backend: str = "flax"
    results_path: str = "results.json"
    # int8 artifact: an .npz, or a directory written by ``quantize``; None =
    # the committed assets/rml11_int8.npz.
    int8_artifact: str | None = None
    # Which int8 classifier eval and the stream path run (ops/infer.py
    # make_int8_predict): "v2", "v3", "v4", "v5", "v6", "v7", "v9" or "v10".
    int8_kernel: str = "v7"
    batch_size: int = 2048
    # 0 sweeps the whole dataset; f > 0 only the held-out part of
    # train_test_split(..., test_frac=f), the split the JAX package's
    # accuracy artifacts were made on (its scripts/train_eval_full.py).
    test_split: float = 0.0


@dataclass(frozen=True)
class BenchConfig:
    batch_size: int = 4096
    warmup_iters: int = 5
    timed_iters: int = 20
    # Measured code path (bench.py BACKENDS).
    backend: str = "pallas_int8_v7"
    # 'cnn' = classifier only (frames in device memory); 'stream' = the full
    # DSP chain (channelize + normalize + frame + classify) on wideband I/Q.
    mode: str = "cnn"
    # In cnn mode, also measure the stream chain and print its JSON line to
    # stderr.
    stream_extra: bool = True
    # Per-session calibration: every candidate is measured and the fastest
    # becomes the headline, with all medians on stderr.
    calibrate: bool = True
    calibration_candidates: Tuple[str, ...] = (
        "pallas_int8_v7", "pallas_int8_v10")


@dataclass(frozen=True)
class AmcConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    bench: BenchConfig = field(default_factory=BenchConfig)
    device: str = "cuda"              # "cpu" runs the plain PyTorch versions


def _set_nested(cfg: Any, dotted: str, value: str) -> Any:
    """Return a copy of ``cfg`` with ``a.b.c`` replaced by parsed ``value``."""
    head, _, rest = dotted.partition(".")
    if not hasattr(cfg, head):
        raise KeyError(f"unknown config field {head!r} on {type(cfg).__name__}")
    if rest:
        sub = _set_nested(getattr(cfg, head), rest, value)
        return dataclasses.replace(cfg, **{head: sub})
    current = getattr(cfg, head)
    return dataclasses.replace(cfg, **{head: _parse_like(current, value)})


def _parse_like(current: Any, value: str) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        return tuple(v.strip() for v in value.split(","))
    if current is None or isinstance(current, str):
        return None if value.lower() == "none" else value
    raise TypeError(f"cannot parse override for field of type {type(current)}")


def apply_overrides(cfg: AmcConfig, overrides: list[str]) -> AmcConfig:
    """Apply ``a.b=c`` style CLI overrides to a frozen config tree."""
    for item in overrides:
        key, eq, value = item.partition("=")
        if not eq:
            raise ValueError(f"override {item!r} is not of the form key=value")
        cfg = _set_nested(cfg, key, value)
    return cfg
