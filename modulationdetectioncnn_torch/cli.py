"""CLI of the port: ``python -m modulationdetectioncnn_torch <cmd> [key=value ...]``.

Commands ported so far:

- ``stream``: the streaming demo through the int8 CUDA kernels;
- ``bench``: the port's benchmark (``bench.py``: one JSON contract line on
  stdout, calibration and the stream chain's rate on stderr).

Overrides use the JAX package's names, plus ``device=``:

    python -m modulationdetectioncnn_torch stream
    python -m modulationdetectioncnn_torch stream device=cpu
    python -m modulationdetectioncnn_torch stream eval.int8_kernel=v10
    python -m modulationdetectioncnn_torch stream eval.int8_artifact=model.npz
    python -m modulationdetectioncnn_torch bench
    python -m modulationdetectioncnn_torch bench stream
    python -m modulationdetectioncnn_torch bench pallas_int8_v9
    python -m modulationdetectioncnn_torch bench device=cpu bench.batch_size=64

The other commands of the JAX package (train, eval, quantize, qat,
scaling) are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import sys

from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides

COMMANDS = ("stream", "bench")


def cmd_stream(cfg: AmcConfig):
    from modulationdetectioncnn_torch.dsp import pipeline

    return pipeline.run_stream_demo(cfg)


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
    try:
        cfg = apply_overrides(AmcConfig(), overrides)
    except (KeyError, ValueError, TypeError) as e:
        raise SystemExit(f"bad override: {e}") from e
    cmd_stream(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
