"""Synthetic RadioML-2016.10a-style IQ frames (NumPy + SciPy).

The port's own copy of ``generate_frames``, ``make_dataset`` and
``train_test_split``, with their helpers, from the JAX
package's ``data/synthetic.py`` (which is NumPy-only, but the port imports
nothing of that package): the 11 modulation classes, 2x128 complex frames at
8 samples/symbol, RRC pulse shaping (beta=0.35) and the channel impairments
of the RML2016.10a recipe (AWGN, carrier/sample-rate offset with drift,
random phase/timing, Rician multipath). Same seed, same frames as the JAX
package's generator.
"""
from __future__ import annotations

import numpy as np
from scipy import signal as sp_signal

from modulationdetectioncnn_torch.config import ChannelConfig, DataConfig, RML_CLASSES

MODULATIONS = RML_CLASSES

# The JAX package's generator version, which this copy reproduces frame for
# frame; a dataset cache keyed on it is invalidated when the generated
# statistics change. v3: CFO/SRO drawn from the bounded random walk's
# equilibrium (N(0, sigma) clipped) and Rician K=4 multipath.
GENERATOR_VERSION = 3


# Constellations for the linear digital modulations (unit average power).
def _psk(m: int, rot: float = 0.0) -> np.ndarray:
    k = np.arange(m)
    return np.exp(1j * (2 * np.pi * k / m + rot)).astype(np.complex128)


def _qam(m: int) -> np.ndarray:
    side = int(np.sqrt(m))
    re, im = np.meshgrid(np.arange(side), np.arange(side))
    pts = (2 * re - side + 1) + 1j * (2 * im - side + 1)
    pts = pts.reshape(-1)
    return (pts / np.sqrt((np.abs(pts) ** 2).mean())).astype(np.complex128)


def _pam(m: int) -> np.ndarray:
    pts = (2 * np.arange(m) - m + 1).astype(np.complex128)
    return pts / np.sqrt((np.abs(pts) ** 2).mean())


_CONSTELLATIONS = {
    "BPSK": _psk(2),
    "QPSK": _psk(4, rot=np.pi / 4),
    "8PSK": _psk(8),
    "PAM4": _pam(4),
    "QAM16": _qam(16),
    "QAM64": _qam(64),
}

_ANALOG = ("AM-DSB", "AM-SSB", "WBFM")


def rrc_filter(beta: float, sps: int, span: int) -> np.ndarray:
    """Root-raised-cosine impulse response, unit energy."""
    n = np.arange(-span * sps, span * sps + 1, dtype=np.float64)
    t = n / sps
    h = np.zeros_like(t)
    # Handle singular points explicitly.
    eps = 1e-10
    t0 = np.abs(t) < eps
    ts = np.abs(np.abs(4 * beta * t) - 1.0) < eps
    tn = ~(t0 | ts)
    h[t0] = 1.0 - beta + 4 * beta / np.pi
    if beta > 0:
        h[ts] = (beta / np.sqrt(2)) * (
            (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
            + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta))
        )
    tt = t[tn]
    num = np.sin(np.pi * tt * (1 - beta)) + 4 * beta * tt * np.cos(
        np.pi * tt * (1 + beta)
    )
    den = np.pi * tt * (1 - (4 * beta * tt) ** 2)
    h[tn] = num / den
    return h / np.sqrt(np.sum(h**2))


def _gaussian_pulse(bt: float, sps: int, span: int = 3) -> np.ndarray:
    """Gaussian frequency pulse for GFSK (BT product ``bt``)."""
    t = np.arange(-span * sps, span * sps + 1, dtype=np.float64) / sps
    alpha = np.sqrt(np.log(2) / 2) / bt
    h = (np.sqrt(np.pi) / alpha) * np.exp(-((np.pi * t / alpha) ** 2))
    return h / h.sum()


SILENCE_PROB = 0.25     # fraction of frames inside a speech pause
SILENCE_LEVEL = 0.02    # residual (breath/background) amplitude in pauses


def _audio_source(rng: np.random.Generator, n_frames: int, n: int) -> np.ndarray:
    """Synthetic 'voice-like' source: low-pass filtered noise + tones, with
    speech pauses and syllabic amplitude variation.

    Stands in for the analog-modulation source audio the dataset used (a
    continuous voice recording). The pauses are the property that creates
    the literature's WBFM<->AM-DSB confusion: during silence both are a bare
    carrier, so no classifier can separate them (an always-on source makes
    the analog classes unrealistically easy).
    Speech pauses (~100 ms) dwarf the 0.64 ms frame, so silence is modeled
    per-frame; the syllabic envelope (~4 Hz) likewise appears as a per-frame
    log-normal amplitude.
    """
    noise = rng.standard_normal((n_frames, n))
    # 4th-order butterworth low-pass at ~0.06 fs (voice-band at 200 kHz fs).
    b, a = sp_signal.butter(4, 0.12)
    src = sp_signal.lfilter(b, a, noise, axis=-1)
    t = np.arange(n)[None, :]
    f0 = rng.uniform(0.002, 0.03, size=(n_frames, 1))
    ph = rng.uniform(0, 2 * np.pi, size=(n_frames, 1))
    src = src + 0.5 * np.sin(2 * np.pi * f0 * t + ph)
    rms = np.sqrt((src**2).mean(axis=-1, keepdims=True)) + 1e-12
    src = src / rms
    amp = np.exp(rng.normal(0.0, 0.6, size=(n_frames, 1)))
    amp = np.minimum(amp, 3.0)
    silent = rng.random((n_frames, 1)) < SILENCE_PROB
    return src * np.where(silent, SILENCE_LEVEL, amp)


def _linear_mod(
    rng: np.random.Generator, name: str, n_frames: int, n_out: int, cfg: DataConfig
) -> np.ndarray:
    const = _CONSTELLATIONS[name]
    sps = cfg.sps
    n_sym = int(np.ceil(n_out / sps)) + 2 * cfg.rrc_span + 2
    sym_idx = rng.integers(0, len(const), size=(n_frames, n_sym))
    syms = const[sym_idx]
    up = np.zeros((n_frames, n_sym * sps), dtype=np.complex128)
    up[:, ::sps] = syms
    h = rrc_filter(cfg.rrc_beta, sps, cfg.rrc_span)
    x = sp_signal.fftconvolve(up, h[None, :], mode="full", axes=-1)
    # Discard the filter ramp-up, keep n_out samples.
    start = cfg.rrc_span * sps
    return x[:, start : start + n_out]


def _cpfsk(
    rng: np.random.Generator, n_frames: int, n_out: int, sps: int, h_idx: float = 0.5
) -> np.ndarray:
    n_sym = int(np.ceil(n_out / sps)) + 2
    bits = rng.integers(0, 2, size=(n_frames, n_sym)) * 2 - 1
    freq = np.repeat(bits, sps, axis=-1).astype(np.float64)
    phase = np.pi * h_idx * np.cumsum(freq, axis=-1) / sps
    return np.exp(1j * phase)[:, :n_out]


def _gfsk(
    rng: np.random.Generator,
    n_frames: int,
    n_out: int,
    sps: int,
    h_idx: float = 0.5,
    bt: float = 0.3,
) -> np.ndarray:
    span = 3
    n_sym = int(np.ceil(n_out / sps)) + 2 * span + 2
    bits = rng.integers(0, 2, size=(n_frames, n_sym)) * 2 - 1
    freq = np.repeat(bits, sps, axis=-1).astype(np.float64)
    g = _gaussian_pulse(bt, sps, span)
    freq = sp_signal.fftconvolve(freq, g[None, :], mode="full", axes=-1)
    phase = np.pi * h_idx * np.cumsum(freq, axis=-1) / sps
    start = span * sps
    return np.exp(1j * phase)[:, start : start + n_out]


def _analog_mod(
    rng: np.random.Generator, name: str, n_frames: int, n_out: int
) -> np.ndarray:
    audio = _audio_source(rng, n_frames, n_out)
    if name == "AM-DSB":
        return (1.0 + 0.5 * audio).astype(np.complex128)
    if name == "AM-SSB":
        analytic = sp_signal.hilbert(audio, axis=-1)
        return analytic.astype(np.complex128)
    if name == "WBFM":
        kf = 0.15  # peak deviation in cycles/sample for unit-RMS audio
        phase = 2 * np.pi * kf * np.cumsum(audio, axis=-1)
        return np.exp(1j * phase)
    raise ValueError(name)


def _apply_channel(
    rng: np.random.Generator, x: np.ndarray, frame_len: int, ch: ChannelConfig
) -> np.ndarray:
    """Impairments: SRO -> multipath -> CFO/phase -> slice -> AWGN."""
    n_frames, n = x.shape

    # Sample-rate offset: resample by (1+eps) with linear interpolation.
    if ch.max_sro > 0:
        eps = np.clip(
            rng.normal(0.0, ch.sro_sigma, size=(n_frames, 1)),
            -ch.max_sro, ch.max_sro,
        )
        t = np.arange(n)[None, :] * (1.0 + eps)
        t = np.clip(t, 0, n - 1 - 1e-9)
        i0 = t.astype(np.int64)
        frac = t - i0
        rows = np.arange(n_frames)[:, None]
        x = x[rows, i0] * (1 - frac) + x[rows, np.minimum(i0 + 1, n - 1)] * frac

    # Multipath: per-frame Rician FIR — a unit LOS tap carrying K/(K+1) of
    # the power plus complex-Gaussian scattered taps with exponential decay
    # (the dataset's dynamic_channel_model: LOS_model=True, K=4).
    if ch.multipath and ch.multipath_taps > 1:
        k = ch.multipath_taps
        decay = np.exp(-np.arange(k) / max(ch.multipath_delay_spread * k, 1e-6))
        scat = (
            rng.standard_normal((n_frames, k)) + 1j * rng.standard_normal((n_frames, k))
        ) * decay[None, :] / np.sqrt(2.0)
        scat /= np.sqrt((np.abs(scat) ** 2).sum(axis=-1, keepdims=True))
        kf = max(ch.rician_k, 0.0)
        taps = np.sqrt(1.0 / (kf + 1.0)) * scat
        taps[:, 0] += np.sqrt(kf / (kf + 1.0))
        x = sp_signal.fftconvolve(x, taps, mode="full", axes=-1)[:, :n]

    # Carrier frequency + phase offset; the oscillator drifts within the
    # frame as a random walk on the instantaneous frequency (the dataset's
    # dynamic channel model, ChannelConfig docstring).
    f = (
        np.clip(rng.normal(0.0, ch.cfo_sigma, size=(n_frames, 1)),
                -ch.max_cfo, ch.max_cfo)
        if ch.max_cfo > 0
        else np.zeros((n_frames, 1))
    )
    phi = (
        rng.uniform(0, 2 * np.pi, size=(n_frames, 1))
        if ch.random_phase
        else np.zeros((n_frames, 1))
    )
    f_inst = f + (
        np.cumsum(rng.normal(0.0, ch.cfo_walk_std, size=(n_frames, n)), axis=-1)
        if ch.cfo_walk_std > 0
        else 0.0
    )
    x = x * np.exp(1j * (2 * np.pi * np.cumsum(f_inst, axis=-1) + phi))

    # Random timing offset: slice frame_len samples at a random start.
    max_start = n - frame_len
    starts = (
        rng.integers(0, max(max_start, 1), size=n_frames)
        if ch.random_timing and max_start > 0
        else np.zeros(n_frames, dtype=np.int64)
    )
    idx = starts[:, None] + np.arange(frame_len)[None, :]
    x = x[np.arange(n_frames)[:, None], idx]

    # Normalize to unit average power, then AWGN at the requested SNR.
    p = (np.abs(x) ** 2).mean(axis=-1, keepdims=True) + 1e-30
    x = x / np.sqrt(p)
    noise_var = 10.0 ** (-ch.snr_db / 10.0)
    noise = (
        rng.standard_normal((n_frames, frame_len))
        + 1j * rng.standard_normal((n_frames, frame_len))
    ) * np.sqrt(noise_var / 2.0)
    return x + noise


def generate_frames(
    rng: np.random.Generator,
    modulation: str,
    n_frames: int,
    snr_db: float,
    cfg: DataConfig | None = None,
) -> np.ndarray:
    """Generate ``(n_frames, frame_len)`` complex64 frames of one modulation."""
    import dataclasses

    cfg = cfg or DataConfig()
    ch = dataclasses.replace(cfg.channel, snr_db=snr_db)
    # Generate extra samples so the timing-offset slice stays valid.
    n_gen = cfg.frame_len + 4 * cfg.sps + 16
    if modulation in _CONSTELLATIONS:
        x = _linear_mod(rng, modulation, n_frames, n_gen, cfg)
    elif modulation == "CPFSK":
        x = _cpfsk(rng, n_frames, n_gen, cfg.sps)
    elif modulation == "GFSK":
        x = _gfsk(rng, n_frames, n_gen, cfg.sps)
    elif modulation in _ANALOG:
        x = _analog_mod(rng, modulation, n_frames, n_gen)
    else:
        raise ValueError(f"unknown modulation {modulation!r}")
    x = _apply_channel(rng, x, cfg.frame_len, ch)
    return x.astype(np.complex64)


def complex_to_iq(x: np.ndarray) -> np.ndarray:
    """(N, T) complex -> (N, 2, T) float32, I on row 0, Q on row 1 (the
    classifier's 2x128 input layout)."""
    return np.stack([x.real, x.imag], axis=1).astype(np.float32)


def make_dataset(
    cfg: DataConfig,
    snrs: list[int] | None = None,
    classes: tuple[str, ...] | None = None,
    frames_per_class_per_snr: int | None = None,
    seed: int | None = None,
):
    """Full synthetic RadioML-style dataset.

    Returns ``(x, y, snr)`` with x float32 (N, 2, frame_len), y int32 labels
    indexing ``classes``, snr int32 per-frame SNR in dB, shuffled. Every
    draw comes from one ``default_rng(seed)`` in class, then SNR order, so
    the same config gives the JAX package's frames."""
    classes = classes or cfg.classes
    snrs = (snrs if snrs is not None
            else list(range(cfg.snr_db_min, cfg.snr_db_max + 1, cfg.snr_db_step)))
    n_per = frames_per_class_per_snr or cfg.frames_per_class_per_snr
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    xs, ys, ss = [], [], []
    for ci, cls in enumerate(classes):
        for snr in snrs:
            fr = generate_frames(rng, cls, n_per, float(snr), cfg)
            xs.append(complex_to_iq(fr))
            ys.append(np.full(n_per, ci, dtype=np.int32))
            ss.append(np.full(n_per, snr, dtype=np.int32))
    x = np.concatenate(xs, axis=0)
    y = np.concatenate(ys, axis=0)
    s = np.concatenate(ss, axis=0)
    perm = rng.permutation(len(x))
    return x[perm], y[perm], s[perm]


def train_test_split(x, y, s, test_frac: float = 0.2, seed: int = 1):
    """``((x, y, s) train, (x, y, s) test)``: a seeded permutation, its
    first ``int(n * test_frac)`` frames held out."""
    rng = np.random.default_rng(seed)
    n = len(x)
    perm = rng.permutation(n)
    n_test = int(n * test_frac)
    te, tr = perm[:n_test], perm[n_test:]
    return (x[tr], y[tr], s[tr]), (x[te], y[te], s[te])
