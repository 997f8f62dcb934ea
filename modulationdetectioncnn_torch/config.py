"""Frozen-dataclass configuration for the port, with ``key=value`` overrides.

The port's own copy of the fields of ``modulationdetectioncnn_tpu/config.py``
that its ported paths read, with the same names and defaults, so that an
override such as ``stream.num_subbands=8`` means the same thing to both
packages. Fields of paths not ported yet (training, bench, mesh) are absent;
``DataConfig`` is built by the demo itself, as in the JAX package.
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
    """The fields ``data/synthetic.py::generate_frames`` reads."""
    frame_len: int = 128
    sps: int = 8                      # samples per symbol
    rrc_beta: float = 0.35            # RRC excess bandwidth
    rrc_span: int = 8                 # RRC filter span in symbols
    channel: ChannelConfig = field(default_factory=ChannelConfig)


@dataclass(frozen=True)
class StreamConfig:
    """Streaming front end. The JAX package's resampler and timing-correction
    fields are absent: those stages are not ported yet."""
    num_subbands: int = 16            # polyphase channelizer branches
    taps_per_branch: int = 8          # prototype filter taps per branch
    frame_len: int = 128              # classification frame length
    frame_hop: int = 128              # must divide frame_len
    block_len: int = 1 << 15          # overlap-save block length
    normalize_cfo: bool = True
    cfo_pad_factor: int = 4           # DFT size = frame_len * pad_factor


@dataclass(frozen=True)
class EvalConfig:
    # .npz int8 artifact; None = the committed assets/rml11_int8.npz.
    int8_artifact: str | None = None


@dataclass(frozen=True)
class AmcConfig:
    eval: EvalConfig = field(default_factory=EvalConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
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
