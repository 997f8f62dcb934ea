"""A run with the timed path broken underneath, or the lower-precision
control in the program's place, comes out as not correct; the sound run
as correct. On the CPU at a small size, in a window of a fixed number of
calls, so that what is judged does not hang on the machine's speed; the
controls also on the card, at the cells' own sizes and load."""
import math
import time

import pytest
import torch

from amc_bench import controls, run, spec
from amc_bench.system import System
from amc_bench.tests.conftest import small_cell


def pool_items(cell) -> int:
    """The batches or captures of the cell's pool: a CPU window makes one
    call of each."""
    t = cell.traffic
    return t["pool"] if t["kind"] == "stream" else t["pool_frames"] // t["batch"]


def _run(name, mode, device="cpu", seconds=1.0):
    cell = small_cell(name) if device == "cpu" else spec.load(name)
    restore = []

    def factory(c, device):
        system = System(c, device)
        controls.apply(system, c, mode, restore)
        return system

    cpu = device == "cpu"
    try:
        return run.run(cell, 2**32 + 17, math.inf if cpu else seconds, False, device,
                       time.perf_counter(), system_factory=factory,
                       calls=pool_items(cell) if cpu else None)
    finally:
        for undo in reversed(restore):
            undo()


@pytest.mark.parametrize("name,mode", [
    ("int8_stream", "half"), ("int8_stream", "alter"), ("int8_stream", "no_cfo"),
    ("int8_stream", "int4"), ("int8_frames", "half"), ("int8_frames", "alter"),
    ("int8_frames", "int4"), ("bf16_frames", "half"), ("bf16_frames", "alter"),
    ("bf16_stream_timing", "alter"), ("bf16_stream_timing", "no_cfo"),
])
def test_fault_or_control_is_not_correct(name, mode):
    line = _run(name, mode)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("name", ["int8_frames", "bf16_stream_timing"])
def test_sound_run_is_correct(name):
    line = _run(name, "sound")
    assert torch.is_grad_enabled()          # the run leaves the caller's grad mode as it was
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == pool_items(small_cell(name))
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name,mode", [
    ("int8_stream", "int4"), ("int8_stream", "tf32"), ("int8_frames", "int4"),
    ("bf16_frames", "int8_path"), ("bf16_stream_timing", "int8_path"),
    ("bf16_stream_timing", "tf32"),
])
def test_control_at_the_cells_size_is_not_correct(cuda, name, mode):
    """On the card, at the cell's own size: the TF32 front end has no CPU
    form, and the int8 path's widest gap grows with the frames judged."""
    line = _run(name, mode, device="cuda")
    assert line["correct"] is False, line["checks"]
