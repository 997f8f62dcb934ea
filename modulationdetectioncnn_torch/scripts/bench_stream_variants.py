"""The stream chain's rate under six front-end variants, each against the
same run's CNN-only rate.

Counterpart of the JAX package's ``scripts/bench_stream_variants.py``: the
CNN-only rate first (``bench.run`` in cnn mode with ``backend`` named, so no
calibration), then ``bench.run_stream_bench`` with each variant's overrides,
in the JAX script's order:

- ``default``: the ``StreamConfig`` defaults (CFO on, timing off);
- ``timing_on``: ``stream.normalize_timing=true`` (the timing FIR);
- ``resample_2_3``: the 2/3 resampler in front (``stream.block_len=49152``);
- ``cfo_off_timing_off``: neither correction;
- ``cfo_pad2``: the half-size CFO search;
- ``default_rerun``: the defaults again, the same run's measure of its
  own spread (stream mode is host-bound and noisy).

Each variant's ``pct_of_cnn_only`` is ``round(100 * rate / cnn, 1)``. A
variant that raises records ``{"error": repr(e)[:200]}`` and the others
still run, as in the JAX script. One line is printed per variant, and the
JSON is written to ``out`` (default ``chiprun_out/bench_stream_variants.json``,
never into ``artifacts/``, which holds the JAX package's records).

    python -m modulationdetectioncnn_torch.scripts.bench_stream_variants \\
        [backend] [key=value ...] [out=PATH]
    python -m modulationdetectioncnn_torch.scripts.bench_stream_variants device=cpu \\
        bench.batch_size=32 bench.warmup_iters=1 bench.timed_iters=2 \\
        stream.num_subbands=4 out=/tmp/variants.json

It runs on the card unless ``device=cpu`` is given (the CPU's rates are
the CPU's). The JAX script's TPU warm-up is not ported.
"""
from __future__ import annotations

import json
import os
import sys

from modulationdetectioncnn_torch import bench
from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
from modulationdetectioncnn_torch.device import resolve_device
from modulationdetectioncnn_torch.scripts import refuse_artifacts

DEFAULT_OUT = os.path.join("chiprun_out", "bench_stream_variants.json")
# (name, overrides), in the JAX script's order.
VARIANTS = (
    ("default", ()),
    ("timing_on", ("stream.normalize_timing=true",)),
    ("resample_2_3", ("stream.resample_up=2", "stream.resample_down=3",
                      "stream.block_len=49152")),
    ("cfo_off_timing_off", ("stream.normalize_cfo=false", "stream.normalize_timing=false")),
    ("cfo_pad2", ("stream.cfo_pad_factor=2",)),
    ("default_rerun", ()),
)


def run(cfg: AmcConfig, backend: str | None = None) -> dict:
    """The CNN-only rate, then each variant's stream rate, on ``cfg.device``;
    returns the JAX script's dict."""
    resolve_device(cfg.device)
    backend = backend or cfg.bench.backend
    cnn = bench.run(apply_overrides(cfg, ["bench.stream_extra=false"]), quiet=True,
                    backend=backend)
    print("cnn-only:", json.dumps(cnn), flush=True)
    out = {"backend": backend, "cnn_only_samples_per_sec": cnn["value"], "variants": {}}
    for name, overrides in VARIANTS:
        try:
            res = bench.run_stream_bench(apply_overrides(cfg, list(overrides)), quiet=True,
                                         backend=backend)
            out["variants"][name] = {
                "samples_per_sec": res["value"],
                "vs_baseline": res["vs_baseline"],
                "pct_of_cnn_only": round(100 * res["value"] / cnn["value"], 1),
            }
        except Exception as e:  # noqa: BLE001 -- recorded; the other variants still run
            out["variants"][name] = {"error": repr(e)[:200]}
        print(name, json.dumps(out["variants"][name]), flush=True)
    return out


def main(argv: list[str] | None = None) -> dict:
    """``[backend] [key=value ...] [out=PATH]``: run, write ``out``, return
    the dict."""
    argv = sys.argv[1:] if argv is None else argv
    out_path, backend, overrides = DEFAULT_OUT, None, []
    for arg in argv:
        if arg.startswith("out="):
            out_path = arg[len("out="):]
        elif "=" in arg:
            overrides.append(arg)
        else:
            backend = arg
    refuse_artifacts(out_path)
    result = run(apply_overrides(AmcConfig(), overrides), backend)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", out_path, flush=True)
    return result


if __name__ == "__main__":
    main()
