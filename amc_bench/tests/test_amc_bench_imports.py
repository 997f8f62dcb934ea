"""Nothing the harness or the reference loads is JAX or the JAX package,
and the reference loads nothing of the program: checked in fresh
processes, by whole top-level module names."""
import json
import os
import subprocess
import sys

from amc_bench import spec


def _modules(sub: str) -> tuple:
    """Every module under ``amc_bench/<sub>/``, found by listing it."""
    return tuple(sorted(f"amc_bench.{sub}.{f[:-3]}" for f in os.listdir(os.path.join(spec.HERE, sub))
                        if f.endswith(".py") and f != "__init__.py"))


HARNESS = ("amc_bench.run", "amc_bench.system", "amc_bench.check", "amc_bench.gen",
           "amc_bench.trace", "amc_bench.counts", "amc_bench.shares", "amc_bench.controls",
           "amc_bench.calibrate", "amc_bench.spec") + _modules("arch")
REFERENCE = _modules("reference")

TOP = "import json, sys; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\n" + TOP], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    assert {"amc_bench.reference.frontend", "amc_bench.reference.vtcnn2"} <= set(REFERENCE)
    top = _loaded("\n".join(f"import {m}" for m in REFERENCE))
    assert not top & {"jax", "jaxlib", "flax", "modulationdetectioncnn_tpu",
                      "modulationdetectioncnn_torch"}


def test_a_run_loads_no_jax():
    code = "\n".join(f"import {m}" for m in HARNESS) + """
import time
from amc_bench.tests.conftest import small_cell
from amc_bench import run
line = run.run(small_cell("int8_stream"), 3, 0.5, True, "cpu", time.perf_counter())
assert line["correct"], line
line = run.run(small_cell("bf16_frames"), 3, 0.5, False, "cpu", time.perf_counter())
assert line["correct"], line
assert not run.forbidden_modules()
"""
    top = _loaded(code)
    assert "modulationdetectioncnn_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "modulationdetectioncnn_tpu"}
