"""Time the residual classifier's fused chain (``csrc/residual_chain_bf16.cu``)
on a CUDA card, beyond what ``chip_smoke.py`` times (row 25 at B = 4096).

    python3 -m modulationdetectioncnn_torch.scripts.resnet_chain_check

One JSON line a case, for a seeded model at the published widths on seeded
frames: the kernel (CUDA events around 20 back-to-back launches, median of
5) at B = 4096 and 16,384 beside its bound, its plain version and the head;
then the two predictor routes (``resnet_chain_bf16``, ``module``) on the
same model at B = 4096, and their labels' agreement. The kernel's checks
against its plain version are ``chip_smoke.py``'s (phase resnet_chain).
Exits 2 without a card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from modulationdetectioncnn_torch.models.resnet_rml18 import ResNetRML18, macs_per_frame
from modulationdetectioncnn_torch.ops import residual_chain_bf16 as rc


def seeded(seed: int, device) -> tuple[dict, torch.Tensor]:
    model = ResNetRML18(generator=torch.Generator().manual_seed(seed))
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((16384, 2, rc.FRAME_LEN), generator=g, device=device)
    return model.state_dict(), x


def _events_ms(fn, iters: int = 20, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def timing(device="cuda") -> list[dict]:
    from modulationdetectioncnn_torch.dsp.pipeline import resnet_route

    state, x = seeded(0, device)
    cw, hw = rc.make_chain_weights(state, device), rc.make_head_weights(state, device)
    out = []
    for b in (4096, 16384):
        xb = x[:b]
        ms = _events_ms(lambda: rc.residual_chain_bf16(xb, cw))
        ops = 2 * macs_per_frame()["stacks"] * b
        bound = max(ops / 989e12, (b * (8192 + 1024) + 6 * rc.STACK_BYTES) / 3.35e12) * 1e3
        out.append({"phase": "time", "kernel": "residual_chain_bf16", "frames": b, "ms": ms,
                    "bound_ms": bound, "roofline_pct": 100 * bound / ms,
                    "plain_ms": _events_ms(lambda: rc.residual_chain_bf16_plain(xb, cw), 3, 3),
                    "head_ms": _events_ms(lambda: rc.head_labels(
                        rc.residual_chain_bf16(xb, cw), hw)) - ms})
    model = ResNetRML18()
    model.load_state_dict(state)
    model = model.to(device).eval()
    classify = rc.make_resnet_classifier(state, device)
    assert resnet_route(model, torch.device(device)) == "resnet_chain_bf16"
    with torch.no_grad():
        for name, fn in (("resnet_chain_bf16", classify),
                         ("module", lambda xb: model(xb).argmax(-1).to(torch.int32))):
            xb = x[:4096]
            out.append({"phase": "route", "route": name, "frames": 4096,
                        "ms": _events_ms(lambda: fn(xb), 10, 3)})
        agree = int((classify(x[:4096]) == model(x[:4096]).argmax(-1).to(torch.int32)).sum())
    out.append({"phase": "route", "labels_equal_kernel_vs_module": agree, "frames": 4096})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("resnet_chain_check needs a CUDA card", file=sys.stderr)
        return 2
    from modulationdetectioncnn_torch.ops import _build

    info = _build.build()
    lines = info["log"].splitlines()
    log = [lines[i + j] for i, line in enumerate(lines) if "residual_chain" in line
           for j in range(3) if i + j < len(lines)]
    print(json.dumps({"phase": "build", "seconds": info["seconds"], "ptxas": log}))
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "not read"
    print(json.dumps({"phase": "device", "card": limit, "torch": torch.__version__}))
    for rec in timing():
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
