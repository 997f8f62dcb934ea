"""Readings for the limits: the program's numbers on many seeds, and the
controls' and the faults' (``controls.py``), in one process.

    python3 -m amc_bench.calibrate --workload <cell> --seeds 1,2,3 \\
        --seconds 2 --modes sound,int4,half,alter [--out file.jsonl]

For each seed the traffic is made anew; for each mode a short closed-loop
window at the cell's own sizes and load runs, then the same check as a
benchmark run. One JSON line per (seed, mode): the numbers compared, the
captures or batches judged. Needs the card, as a benchmark run does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def readings(cell, seeds, seconds: float, modes, device: str = "cuda", out=None):
    import torch

    from amc_bench import check, controls, gen
    from amc_bench.system import System, Tally

    torch.set_grad_enabled(False)
    system = System(cell, device)
    for seed in seeds:
        items = gen.make(cell.traffic, seed, device)
        system.warm_up(items)
        for mode in modes:
            if not controls.applies(cell, mode):
                continue
            restore = []
            controls.apply(system, cell, mode, restore)
            try:
                system.warm_up(items, times=1)
                system.tally = Tally()
                t0 = time.perf_counter()
                system.window(items, seconds, keep_first=cell.traffic["kind"] == "stream")
                values = check.numbers(cell, system.cfg.stream, items, system.tally, device)
            finally:
                for undo in reversed(restore):
                    undo()
            rec = {"cell": cell.name, "seed": seed, "mode": mode, "numbers": values,
                   "judged": len(system.tally.labels), "failed": system.tally.failed,
                   "seconds": time.perf_counter() - t0}
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del items


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m amc_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--modes", default="sound")
    p.add_argument("--out")
    a = p.parse_args(argv)
    from amc_bench import spec

    import torch

    if not torch.cuda.is_available():
        print("amc_bench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load(a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    out = open(a.out, "a") if a.out else None
    try:
        readings(cell, seeds, a.seconds, a.modes.split(","), "cuda", out)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
