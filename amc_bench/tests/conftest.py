"""Shared helpers of the benchmark's tests: cells cut to a CPU-sized
traffic (the same generator, configuration and checks)."""
import dataclasses

import pytest

from amc_bench import spec


def small_cell(name: str):
    cell = spec.load(name)
    t = dict(cell.traffic)
    if t["kind"] == "stream":
        t.update(capture_samples=1 << 16, pool=2)
    else:
        t.update(pool_frames=384, batch=128)
    return dataclasses.replace(cell, traffic=t)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the TF32 control exists only there")
    return torch.device("cuda")
