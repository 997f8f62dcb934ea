"""The residual classifier's cell, ``resnet_frames``, on the CPU at the
small size (``small_cell``: 384 frames of 1024 samples, batches of 128),
in a window of one call a pool batch: the sound run is correct, and the
planted faults (``half``, ``alter``) and the ``fp8_e4m3`` control (the
reference with its weights and layer inputs in float8 e4m3) are not. On
the CPU the program serves the checkpoint on the module's forward (route
``module``); the card's route is the fused chain."""
import math
import time

import pytest

from amc_bench import controls, run
from amc_bench.system import System
from amc_bench.tests.conftest import small_cell

CELL = "resnet_frames"


def _run(mode: str) -> dict:
    cell = small_cell(CELL)
    restore = []
    routes = []

    def factory(c, device):
        system = System(c, device)
        routes.append(system.predict.route)
        controls.apply(system, c, mode, restore)
        return system

    try:
        line = run.run(cell, 2**32 + 23, math.inf, False, "cpu", time.perf_counter(),
                       system_factory=factory,
                       calls=cell.traffic["pool_frames"] // cell.traffic["batch"])
    finally:
        for undo in reversed(restore):
            undo()
    assert routes == ["module"]
    return line


def test_sound_run_is_correct():
    line = _run("sound")
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == 3 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "classify_msps"}


@pytest.mark.parametrize("mode", ["half", "alter", "fp8_e4m3"])
def test_fault_or_control_is_not_correct(mode):
    assert controls.applies(small_cell(CELL), mode)
    line = _run(mode)
    assert line["correct"] is False, line["checks"]
