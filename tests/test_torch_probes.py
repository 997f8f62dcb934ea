"""The port's per-stage breakdown (``scripts/bench_breakdown.py``) and probe
suite (``scripts/probe.py``) on the CPU: their operation and byte counts
and the shares are pure functions, held to hand-computed values, and every
entry point raises without a card (a measurement of the card has no CPU
version)."""
import functools
import os
import subprocess
import sys

import pytest
import torch

from modulationdetectioncnn_torch.device import describe
from modulationdetectioncnn_torch.scripts import bench_breakdown as bb
from modulationdetectioncnn_torch.scripts import probe
from modulationdetectioncnn_torch.utils import profiler, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the entry points would run on it")


def test_useful_macs_and_bytes_per_frame():
    assert bb.USEFUL_MACS == {"conv1": 193_536, "conv2": 15_237_120,
                              "dense1": 2_539_520, "dense2": 2_816}
    assert (bb.CONV_MACS, bb.DENSE_MACS, bb.FULL_MACS) == (15_430_656, 2_542_336, 17_972_992)
    # f32 (2, 128) frames in, (124, 80) int8 map, int32 label out.
    assert (bb.CONV_BYTES, bb.DENSE_BYTES, bb.FULL_BYTES) == (10_944, 9_924, 1_028)
    assert bb.ceiling_ops(8192) == 1_099_511_627_776 and bb.ceiling_ops(2) == 16


def test_stage_entry():
    e = bb.stage_entry(2.0, 1000, ceiling_ops_per_s=1e12, bytes_per_frame=100, batch=10)
    # 2 * 1000 MACs * 10 frames = 2e4 operations in 2 ms: 1e7 ops/s.
    assert e["ms"] == 2.0
    assert e["samples_per_sec"] == pytest.approx(10 * 128 / 2e-3)
    assert e["useful_ops_per_s"] == pytest.approx(1e7)
    assert e["pct_of_measured_int8_ceiling"] == pytest.approx(1e-3)
    assert e["pct_of_published_int8_peak"] == pytest.approx(100 * 1e7 / 1979e12)
    # bytes bound it: 1000 bytes over 3.35 TB/s.
    assert e["bound_ms"] == pytest.approx(1e3 * 1000 / 3.35e12)


def test_stage_entry_bound_by_operations():
    e = bb.stage_entry(1.0, bb.CONV_MACS, 1e15, bb.CONV_BYTES)
    ops = 2 * bb.CONV_MACS * bb.BATCH
    assert e["bound_ms"] == pytest.approx(1e3 * ops / 1979e12)
    assert e["bound_ms"] > 1e3 * bb.CONV_BYTES * bb.BATCH / 3.35e12


@pytest.mark.parametrize("full,conv,dense,want", [
    (1.0, 0.5, 0.4, {"conv": 0.5, "dense": 0.4, "glue": 0.1}),
    (0.8, 0.5, 0.3, {"conv": 0.625, "dense": 0.375, "glue": 0.0}),
    (1.0, 0.6, 0.5, {"conv": 0.6, "dense": 0.5, "glue": 0.0}),    # glue never below 0
])
def test_stage_shares(full, conv, dense, want):
    got = bb.stage_shares(full, conv, dense)
    assert got == pytest.approx(want)


def test_breakdown_refuses_artifacts(tmp_path):
    with pytest.raises(SystemExit, match="artifacts"):
        bb.main([os.path.join(REPO, "artifacts", "bench_breakdown.json")])


def test_breakdown_raises_without_a_card(no_card, tmp_path):
    out = tmp_path / "b.json"
    with pytest.raises(RuntimeError, match="device=cpu"):
        bb.main([str(out)])
    assert not out.exists()


@pytest.mark.parametrize("name", sorted(probe.PROBES))
def test_probes_raise_without_a_card(no_card, name, capsys):
    with pytest.raises(RuntimeError, match="device=cpu"):
        probe.main([name])
    assert capsys.readouterr().out == ""


def test_probe_names():
    assert set(probe.PROBES) == {"ceil", "stage", "dense", "dense_old", "dense_bf16_old",
                                 "conv2_old", "conv2_maps", "conv_v7_old", "conv_fold_old",
                                 "conv_v5_old",
                                 "conv_v6_old", "conv_v3_old", "conv1_int8_old",
                                 "timing_old", "batch", "r3stream", "r5cfo"}
    with pytest.raises(SystemExit, match="unknown probe"):
        probe.main(["r4"])


def test_probe_command_exits_nonzero_without_a_card(no_card):
    proc = subprocess.run([sys.executable, "-m", "modulationdetectioncnn_torch.scripts.probe",
                           "ceil"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0 and "device=cpu" in proc.stderr
    assert proc.stdout == ""


def test_timing_helpers_need_the_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.launch_ms_samples(lambda: None)
    assert describe(torch.device("cpu")) == "cpu"


def test_device_events_leave_out_operators():
    """An operator's entry is not device work: a CPU-only profile has none."""
    x = torch.ones(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        x @ x
    assert profiler.device_events(prof) == []


# The probe kernels without a product counterpart (``ops/probe_kernels.py``),
# held on the CPU to the Pallas bodies of scripts/probe.py in interpret mode:
# probe_r3's ``_copy_kernel`` (:1044) and probe_r3f's ``_pro_kernel`` (:2061),
# copied here as the probes define them inside their functions.

def _pallas_copy(h):
    import jax
    from jax.experimental import pallas as pl

    def _copy_kernel(i_ref, o_ref):
        o_ref[:] = i_ref[:]

    bb = 4
    return pl.pallas_call(
        _copy_kernel, grid=(h.shape[0] // bb,),
        in_specs=[pl.BlockSpec((bb, h.shape[1]), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((bb, h.shape[1]), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(h.shape, h.dtype), interpret=True)(h)


def _pallas_tap_planes(x, inv):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    def _pro_kernel(x_ref, o_ref, *, inv):
        xq = jnp.clip(jnp.round(x_ref[:] * inv), -127.0, 127.0).astype(jnp.int8)
        t_len = x_ref.shape[2]
        t1 = t_len - 2
        for h in range(2):
            for k in range(3):
                plane = xq[:, h, k: k + t1]
                o_ref[:, h * 3 + k, :] = jnp.pad(plane, ((0, 0), (0, 2)))
        o_ref[:, 6, :] = jnp.zeros_like(xq[:, 0, :])
        o_ref[:, 7, :] = jnp.zeros_like(xq[:, 0, :])

    b, _, t = x.shape
    bb = 4
    return pl.pallas_call(
        functools.partial(_pro_kernel, inv=inv), grid=(b // bb,),
        in_specs=[pl.BlockSpec((bb, 2, t), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((bb, 8, t), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, 8, t), jnp.int8), interpret=True)(x)


def test_copy_bytes_equals_the_pallas_copy():
    import numpy as np

    from modulationdetectioncnn_torch.ops import probe_kernels as pk

    h = np.random.default_rng(0).integers(-128, 128, (8, 1024)).astype(np.int8)
    got = pk.copy_bytes(torch.from_numpy(h))
    np.testing.assert_array_equal(got.numpy(), np.asarray(_pallas_copy(h)))
    assert got.data_ptr() != torch.from_numpy(h).data_ptr()


@pytest.mark.parametrize("t,inv", [(128, 37.3), (128, 2.0), (40, 11.0)])
def test_quantize_tap_planes_equals_the_pallas_prologue(t, inv):
    """Seeded frames with ties (x * inv on a half, exact at scale 2) and
    values past the clip; the port's prologue and the v4/v6 plain prologue
    are one function."""
    import numpy as np

    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.ops import probe_kernels as pk

    r = np.random.default_rng(t)
    x = (r.standard_normal((8, 2, t)) * 3).astype(np.float32)
    x[0] = ((np.arange(2 * t) - t) / 2.0 * 1.5).reshape(2, t)     # halves, and past 127
    got = pk.quantize_tap_planes(torch.from_numpy(x), inv)
    assert got.dtype == torch.int8 and tuple(got.shape) == (8, 8, t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_pallas_tap_planes(x, inv)))
    np.testing.assert_array_equal(got.numpy(), infer.tap_planes(torch.from_numpy(x), inv).numpy())


def test_probe_kernel_wrappers_reject_what_the_kernel_does_not_take():
    from modulationdetectioncnn_torch.ops import probe_kernels as pk

    pk.reset_launch_counts()
    meta = torch.zeros((4, 2, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pk.copy_bytes(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        pk.quantize_tap_planes(meta, 1.0)
    for bad in (torch.zeros((4, 3, 128), device="meta"),
                torch.zeros((4, 2, 128), dtype=torch.float16, device="meta"),
                torch.zeros((4, 2, 2), device="meta")):
        with pytest.raises(ValueError, match="expected"):
            pk.quantize_tap_planes(bad, 1.0)
    assert pk.launch_counts() == {"copy_bytes": 0, "quantize_tap_planes": 0}
