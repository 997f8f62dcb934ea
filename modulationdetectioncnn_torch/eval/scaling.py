"""Scaling-efficiency report: the measured one-card rate and a projection
of multi-card efficiency from stated link constants.

The port's own copy of ``modulationdetectioncnn_tpu/eval/scaling.py``, with
the H100's links in place of the v5e's. The report has three parts:

1. **measured_1chip** -- samples/s of the port's bench on one card (the
   ``scaling`` command runs it), with the device it ran on.
2. **verified correctness** -- the halo exchange of the time-sharded stream
   gives the single-process labels across ranks (``tests/test_torch_parallel.py``
   on the CPU; the ``parallel`` phases of ``chip_smoke.py`` on the card).
3. **projected** -- after the one-hop halo exchange each rank classifies
   its own time block, so efficiency is bounded by the halo and label bytes
   over the link:

       eff(n) = t_comp / (t_comp + t_halo + t_gather)
       t_comp   = block_samples / chip_rate            (measured rate)
       t_halo   = halo_bytes / link_bw + link_latency  (one neighbour hop)
       t_gather = label_bytes / link_bw                (4 bytes per frame)

   and data-parallel training by one ring all-reduce of the float32
   gradients per step, from the measured training rate on the card.

The link names keep the JAX report's (``ici`` within a host, ``dcn``
between hosts), so a reader of either report finds the same fields;
``assumptions.links`` says which physical link each stands for here. No
rate over two or more cards is measured.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

from modulationdetectioncnn_torch.config import AmcConfig

# Within a host: NVLink 4, 900 GB/s per H100 SXM to the other cards of an
# HGX/DGX H100, all to all, i.e. 450 GB/s each way (NVIDIA's H100 data
# sheet).
ICI_BW = 4.5e11        # B/s
# Between hosts: InfiniBand NDR, 400 Gb/s through each card's own
# ConnectX-7 adapter in a DGX H100 (NVIDIA's DGX H100 data sheet), 50 GB/s.
DCN_BW = 5.0e10        # B/s
# Latencies are of one small message end to end through NCCL (launch and
# protocol included, the wire's share is small). Within a host, NVIDIA's
# nccl-tests report point-to-point latencies of a few microseconds over
# NVLink: 5e-6 s. Between hosts NCCL adds its network proxy and the
# InfiniBand adapters and switch; its published multi-node small-message
# latencies are tens of microseconds: 5e-5 s, the JAX report's own DCN
# figure, kept as the conservative end.
ICI_LAT = 5e-6         # s
DCN_LAT = 5e-5         # s
LINKS = {
    "ici": "NVLink 4 within a host: 900 GB/s per H100 SXM, 450 GB/s each way",
    "dcn": "InfiniBand NDR between hosts: 400 Gb/s per card's ConnectX-7 (DGX H100)",
}
BYTES_PER_SAMPLE = 8   # complex64 wideband sample (2 x f32 planes)

# The port's training rate on the card: ``train`` at full width, batch 1024,
# in bf16, on an NVIDIA H100 80GB HBM3 at a 700 W power limit (the record
# in assets/train_rate_h100.json). Used only if that file is missing.
MEASURED_TRAIN_SAMPLES_PER_SEC = 214_643.0
MEASURED_TRAIN_DEVICE = "NVIDIA H100 80GB HBM3, 700.00 W"
TRAIN_RATE_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                               "assets", "train_rate_h100.json")


def _train_rate_record(path: str = TRAIN_RATE_PATH) -> tuple[float, str]:
    """(samples/s, the device it was measured on) from the record at
    ``path``, else the fallback constant's."""
    try:
        with open(path) as f:
            rec = json.load(f)
        return (float(rec["samples_per_sec"]),
                f"{rec['device']}, {float(rec['power_limit_w']):.2f} W")
    except (OSError, KeyError, TypeError, ValueError):
        return MEASURED_TRAIN_SAMPLES_PER_SEC, MEASURED_TRAIN_DEVICE


def _measured_train_rate(path: str = TRAIN_RATE_PATH) -> float:
    """Measured steady-state training samples/s on the card: the record at
    ``path``, falling back to ``MEASURED_TRAIN_SAMPLES_PER_SEC``."""
    return _train_rate_record(path)[0]


@dataclass
class LinkModel:
    bw: float
    lat: float
    name: str


def stream_efficiency(
    chip_rate: float, block_samples: int, halo_samples: int, link: LinkModel
) -> float:
    """Streaming-classification scaling efficiency for one more device."""
    t_comp = block_samples / chip_rate
    halo_bytes = halo_samples * BYTES_PER_SAMPLE
    label_bytes = block_samples // 128 * 4
    t_comm = (halo_bytes + label_bytes) / link.bw + link.lat
    return t_comp / (t_comp + t_comm)


def train_dp_efficiency(
    step_time: float, param_bytes: float, n_devices: int, link: LinkModel
) -> float:
    """DP training efficiency: ring all-reduce of gradients each step."""
    # a ring all-reduce moves 2*(n-1)/n * param_bytes per device
    t_ar = 2 * (n_devices - 1) / n_devices * param_bytes / link.bw + link.lat
    return step_time / (step_time + t_ar)


def scaling_report(cfg: AmcConfig | None = None,
                   measured_chip_rate: float | None = None) -> dict:
    """The JAX report's fields for the port's config. ``measured_chip_rate``
    is samples/s measured on ``cfg.device``, which ``measured_inputs.device``
    names (the card's name and power limit, or ``cpu``); without a rate the
    projection assumes 1e9 samples/s and names no device."""
    from modulationdetectioncnn_torch.device import describe, resolve_device
    from modulationdetectioncnn_torch.dsp.pipeline import (
        effective_block_len, halo_wideband)
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2

    cfg = cfg or AmcConfig()
    sc = cfg.stream
    halo = halo_wideband(sc)
    block = sc.block_len
    # Exact parameter count of the configured model, float32 gradients
    # (2,666,587 at the flagship widths), built on the CPU.
    model = VTCNN2.from_config(cfg.model, cfg.data.frame_len)
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = n_params * 4
    train_rate, train_device = _train_rate_record()
    step_time = cfg.train.batch_size / train_rate
    device = (describe(resolve_device(cfg.device))
              if measured_chip_rate is not None else None)
    report: dict = {
        "measured_1chip_samples_per_sec": measured_chip_rate,
        "measured_inputs": {
            "device": device,
            "train_samples_per_sec": train_rate,
            "train_rate_device": train_device,
            "train_batch": cfg.train.batch_size,
            "train_step_time_s": step_time,
            "param_count": int(n_params),
        },
        "assumptions": {
            "ici_bw_Bps": ICI_BW, "dcn_bw_Bps": DCN_BW,
            "ici_lat_s": ICI_LAT, "dcn_lat_s": DCN_LAT,
            "links": dict(LINKS),
            "block_samples_per_device": block,
            "halo_samples": halo,
            "grad_bytes": param_bytes,
        },
        "projected": {},
    }
    rate = measured_chip_rate or 1.0e9
    ici = LinkModel(ICI_BW, ICI_LAT, "ici")
    dcn = LinkModel(DCN_BW, DCN_LAT, "dcn")
    # Efficiency is latency-bound at small blocks: sweep from the default
    # block up to production streaming blocks (>= 1M samples per device).
    for b in sorted({block, 1 << 20, 1 << 22}):
        tag = f"block_{b}"
        report["projected"][f"stream_eff_2chip_ici_{tag}"] = stream_efficiency(
            rate, b, halo, ici)
        report["projected"][f"stream_eff_2host_dcn_{tag}"] = stream_efficiency(
            rate, b, halo, dcn)
    # The default config across hosts: effective_block_len floors per-rank
    # blocks at stream.block_len_dcn_floor once the time axis spans hosts.
    b_dcn = effective_block_len(sc, n_processes=2)
    report["assumptions"]["block_samples_per_device_dcn_policy"] = b_dcn
    report["projected"]["stream_eff_2host_dcn_at_default_policy"] = (
        stream_efficiency(rate, b_dcn, halo, dcn))
    report["projected"]["train_dp_eff_8chip_ici"] = train_dp_efficiency(
        step_time, param_bytes, 8, ici)
    report["projected"]["train_dp_eff_2host_dcn"] = train_dp_efficiency(
        step_time, param_bytes, 2, dcn)
    report["projected"]["_note"] = (
        "projected from the stated link constants (NVLink 4 within a host, "
        "InfiniBand NDR between hosts) and the measured one-card rates; the "
        "halo exchange's correctness is checked across ranks "
        "(tests/test_torch_parallel.py, the parallel phases of chip_smoke.py); "
        "no rate over two or more cards is measured")
    return report


if __name__ == "__main__":
    print(json.dumps(scaling_report(), indent=1))
