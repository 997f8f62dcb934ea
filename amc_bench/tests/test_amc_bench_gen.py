"""The traffic generator is deterministic in the seed, and every seed gets
the same sizes."""
import torch

from amc_bench import gen

STREAM = {"kind": "stream", "capture_samples": 1 << 14, "pool": 2, "subbands": 16,
          "synthesis_taps_per_branch": 8, "occupied": 8, "sps": 8, "snr_db": [-20, 18, 2],
          "cfo_sigma": 2e-5, "max_cfo": 2.5e-3}
FRAMES = {"kind": "frames", "pool_frames": 256, "batch": 64, "frame_len": 128, "sps": 8,
          "snr_db": [-20, 18, 2], "cfo_sigma": 2e-5, "max_cfo": 2.5e-3}


def test_stream_deterministic_in_seed():
    a = gen.make(STREAM, 2**33 + 5, "cpu")
    b = gen.make(STREAM, 2**33 + 5, "cpu")
    c = gen.make(STREAM, 6, "cpu")
    assert len(a) == 2 and all(x.shape == (2, 1 << 14) and x.dtype == torch.float32 for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    assert all(torch.isfinite(x).all() for x in a + c)


def test_frames_deterministic_in_seed():
    a = gen.make(FRAMES, 11, "cpu")
    b = gen.make(FRAMES, 11, "cpu")
    c = gen.make(FRAMES, 12, "cpu")
    assert len(a) == 4 and all(x.shape == (64, 2, 128) for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_every_class_generates_unit_power():
    g = torch.Generator().manual_seed(3)
    for name in gen.CLASSES:
        x = gen.baseband(name, 1024, 8, g, "cpu")
        assert x.shape == (1024,) and x.dtype == torch.complex64
        assert abs(float(x.abs().square().mean()) - 1.0) < 1e-4
