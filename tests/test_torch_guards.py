"""Guards for what breaks the port only on the GPU machine, caught here.

- No JAX: the port and chip_smoke.py import neither ``jax`` nor the JAX
  package, checked in a subprocess where both are blocked and by a scan of
  every import statement.
- Device: entry points default to cuda and raise without a card instead of
  running on the CPU; chip_smoke.py exits non-zero here and prints no result.
- Build: kernels are built with nvcc for sm_90a into a plain-C library, never
  through torch.utils.cpp_extension, and nothing builds at import time.
"""
import ast
import glob
import importlib
import json
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "modulationdetectioncnn_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "orbax",
             "modulationdetectioncnn_tpu")


def _port_files():
    return sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)) + [
        os.path.join(REPO, "chip_smoke.py")]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_statement(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


BLOCKED_RUN = r"""
import sys
for name in {forbidden!r}:
    sys.modules[name] = None          # any import of these now raises
sys.path.insert(0, {repo!r})
import runpy
import numpy as np
from modulationdetectioncnn_torch.config import StreamConfig
from modulationdetectioncnn_torch.dsp import framer, pipeline
from modulationdetectioncnn_torch.ops import infer
from modulationdetectioncnn_torch.quant import load_int8
import modulationdetectioncnn_torch.cli, modulationdetectioncnn_torch.__main__

sc = StreamConfig(num_subbands=8, block_len=8 * 128 * 2)
r = np.random.default_rng(0)
x = (r.standard_normal(sc.block_len * 2) + 1j * r.standard_normal(sc.block_len * 2))
labels = pipeline.classify_stream_blocked(
    framer.to_planes(x.astype(np.complex64)),
    infer.make_int8_predict(load_int8(device="cpu")), sc)
assert tuple(labels.shape) == (8, 4), labels.shape
runpy.run_path({smoke!r}, run_name="chip_smoke_module")   # module level only
print("NO_JAX_OK", sorted(m for m in sys.modules
                          if m.split(".")[0] in {forbidden!r} and sys.modules[m]))
"""


def test_port_runs_with_jax_blocked():
    code = BLOCKED_RUN.format(forbidden=FORBIDDEN, repo=REPO,
                              smoke=os.path.join(REPO, "chip_smoke.py"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK []" in proc.stdout


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the entry points would run on it")
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.device import resolve_device
    from modulationdetectioncnn_torch.dsp import pipeline
    from modulationdetectioncnn_torch.quant import QuantizedModel, load_int8
    from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, int8_weights_from_numpy

    for call in (lambda: resolve_device(),
                 lambda: load_int8(),
                 lambda: int8_weights_from_numpy(QuantizedModel.from_npz(DEFAULT_ARTIFACT)),
                 lambda: pipeline.run_stream_demo(AmcConfig())):
        with pytest.raises(RuntimeError, match="device=cpu"):
            call()


def test_cli_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "-m", "modulationdetectioncnn_torch", "stream"],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert "device=cpu" in proc.stderr
    assert "top-label" not in proc.stdout


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script_alone"])
def test_chip_smoke_fails_without_card_or_checkout(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present")
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    else:
        cwd = REPO
    proc = subprocess.run([sys.executable, script], capture_output=True, text=True,
                          timeout=300, cwd=cwd)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            assert json.loads(line).get("ok") is not True


def test_build_uses_nvcc_for_sm90a_without_cpp_extension():
    from modulationdetectioncnn_torch.ops import _build

    with open(_build.__file__) as f:
        src = f.read()
    assert "nvcc" in src and "arch=compute_90a,code=sm_90a" in src
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    for banned in ("cpp_extension", "ninja", "triton"):
        assert banned not in src
    sources = _build._sources()
    assert [os.path.basename(s) for s in sources] == [
        "cnn_kernels.cu", "conv_stage_bf16_v4.cu", "conv_stage_int8.cu", "conv_stage_int8_v10.cu",
        "conv_stage_int8_v3.cu", "conv_stage_int8_v5.cu", "conv_stage_int8_v6.cu",
        "correct_timing.cu", "dense_argmax_bf16.cu", "dense_argmax_int8.cu",
        "probe_kernels.cu", "residual_chain_bf16.cu"]
    assert [os.path.basename(s) for s in _build._headers()] == [
        "conv1_producer_s8.cuh", "conv2_wgmma.cuh", "tma_wgmma.cuh"]
    for s in sources:
        with open(s) as f:
            cu = f.read()
        assert "torch/extension.h" not in cu and 'extern "C"' in cu
        assert ("Replaces: modulationdetectioncnn_tpu/ops/infer.py::" in cu
                or "Replaces: modulationdetectioncnn_tpu/ops/cnn_kernels.py::" in cu
                or "Replaces: modulationdetectioncnn_tpu/dsp/normalize.py::" in cu
                or "Replaces: scripts/probe.py::" in cu
                # the residual classifier's chain, a kernel of the port's
                # own: this file alone, and it says why it was added
                or (os.path.basename(s) == "residual_chain_bf16.cu"
                    and "Replaces: no TPU kernel." in cu))
    # Every C entry point a wrapper calls is declared with its argument types.
    entries = set()
    for s in sources:
        with open(s) as f:
            entries |= set(re.findall(r'extern "C" int (amc_\w+)\(', f.read()))
    assert entries == set(_build._SIGNATURES)


@pytest.mark.parametrize("edited", ["conv_stage_int8.cu", "conv1_producer_s8.cuh"])
def test_library_path_tracks_sources(tmp_path, monkeypatch, edited):
    """The library is named by a hash of the sources and the headers they
    include: an edit to either rebuilds."""
    from modulationdetectioncnn_torch.ops import _build

    for s in _build._sources() + _build._headers():
        (tmp_path / os.path.basename(s)).write_bytes(open(s, "rb").read())
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = _build.library_path()
    assert os.path.dirname(before) == _build.BUILD_DIR
    with open(tmp_path / edited, "a") as f:
        f.write("\n// edit\n")
    assert _build.library_path() != before


def test_cuda_wrappers_reject_what_the_kernel_does_not_take():
    """Checks that run before any launch: wrong device type, shape, dtype."""
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.quant import load_int8

    qw = load_int8(device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        infer.conv_stage_int8_v7(torch.zeros((1, 2, 128), device="meta"), qw)
    with pytest.raises(ValueError, match="unsupported device"):
        infer.dense_argmax_int8(torch.zeros((1, 9920), dtype=torch.int8,
                                            device="meta"), qw)
    planes = torch.zeros((1, 8, 128), dtype=torch.int8, device="meta")
    frames = torch.zeros((1, 2, 128), device="meta")
    for stage in (infer.conv_stage_int8_v5, infer.conv_stage_int8_v6,
                  infer.conv_stage_int8_v4):
        good = frames if stage is infer.conv_stage_int8_v5 else planes
        with pytest.raises(ValueError, match="unsupported device"):
            stage(good, qw)
        bad = planes if stage is infer.conv_stage_int8_v5 else frames
        with pytest.raises(ValueError, match="expected"):
            stage(bad, qw)
    with pytest.raises(ValueError, match="expected"):
        infer.conv_stage_int8_v6(torch.zeros((1, 8, 64), dtype=torch.int8,
                                             device="meta"), qw)


BENCH_BLOCKED_RUN = r"""
import sys
for name in {forbidden!r}:
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
from modulationdetectioncnn_torch import bench
from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
import modulationdetectioncnn_torch.models, modulationdetectioncnn_torch.train.quant
import modulationdetectioncnn_torch.utils.timing, modulationdetectioncnn_torch.utils.profiler
cfg = apply_overrides(AmcConfig(), ["device=cpu", "bench.batch_size=8",
                                    "bench.warmup_iters=1", "bench.timed_iters=2"])
for backend in ("pallas_int8_v9", "pallas_int8_v10"):
    assert bench.run(cfg, quiet=True, backend=backend)["value"] > 0
print("NO_JAX_OK", sorted(m for m in sys.modules
                          if m.split(".")[0] in {forbidden!r} and sys.modules[m]))
"""


def test_bench_runs_with_jax_blocked():
    """Model, PTQ, the v9/v10 classifiers, timing and the bench run with
    every JAX module blocked."""
    code = BENCH_BLOCKED_RUN.format(forbidden=FORBIDDEN, repo=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK []" in proc.stdout


def test_bench_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the bench would run on it")
    from modulationdetectioncnn_torch import bench
    from modulationdetectioncnn_torch.config import AmcConfig

    with pytest.raises(RuntimeError, match="device=cpu"):
        bench.run(AmcConfig())
    proc = subprocess.run([sys.executable, "-m", "modulationdetectioncnn_torch", "bench"],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert "device=cpu" in proc.stderr
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo built > "$out"
"""


def test_build_compiles_each_source_in_its_own_nvcc_then_links(tmp_path, monkeypatch):
    """One nvcc -c per source of csrc/ (the new v9/v10 source included),
    then one nvcc -shared over the objects; the objects are removed."""
    from modulationdetectioncnn_torch.ops import _build

    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    res = _build.build()
    assert os.path.isfile(res["path"]) and res["path"] == _build.library_path()
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert sorted(c.split()[-1] for c in compiles) == _build._sources()
    assert all("arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert len(calls) == len(compiles) + 1 and calls[-1].startswith("-shared")
    assert sorted(os.listdir(tmp_path / "build")) == [os.path.basename(res["path"])]
    assert _build.build()["seconds"] == 0.0          # reused, not rebuilt
    assert len(log.read_text().splitlines()) == len(calls)


EVAL_BLOCKED_RUN = r"""
import sys
for name in {forbidden!r}:
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
from modulationdetectioncnn_torch import cli
import modulationdetectioncnn_torch.data.radioml, modulationdetectioncnn_torch.eval.harness
import modulationdetectioncnn_torch.golden.cnn, modulationdetectioncnn_torch.ops.infer_xla
tiny = ["device=cpu", "data.frames_per_class_per_snr=1", "data.snr_db_min=0",
        "data.snr_db_max=18", "data.snr_db_step=18", "eval.batch_size=16",
        "eval.results_path={tmp}/r.json", "train.checkpoint_dir={ckpt}"]
for backend in ("int8", "flax", "golden"):
    assert cli.main(["eval", "eval.backend=" + backend, "eval.int8_kernel=v5", *tiny]) == 0
assert cli.main(["quantize", "quant.calib_frames=33", *tiny]) == 0
print("NO_JAX_OK", sorted(m for m in sys.modules
                          if m.split(".")[0] in {forbidden!r} and sys.modules[m]))
"""


def test_eval_and_quantize_run_with_jax_blocked(tmp_path):
    """eval (int8, flax, golden), quantize and their modules run with every
    JAX module blocked; quantize writes <checkpoint_dir>_int8."""
    ckpt = tmp_path / "ck"
    os.makedirs(ckpt / "96000")
    os.symlink(os.path.join(PORT, "assets", "ckpt_rml11_r5", "96000", "params.npz"),
               ckpt / "96000" / "params.npz")
    code = EVAL_BLOCKED_RUN.format(forbidden=FORBIDDEN, repo=REPO, tmp=tmp_path, ckpt=ckpt)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK []" in proc.stdout
    assert os.path.isfile(tmp_path / "ck_int8" / "int8.npz")


@pytest.mark.parametrize("argv", [["eval", "eval.backend=int8", "eval.int8_kernel=v5"],
                                  ["quantize", "train.checkpoint_dir=modulationdetectioncnn_torch/assets/ckpt_rml11_r5"]],
                         ids=["eval", "quantize"])
def test_eval_and_quantize_raise_without_cuda(argv):
    """Neither command runs on the CPU unless device=cpu is given."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the command would run on it")
    from modulationdetectioncnn_torch import cli

    with pytest.raises(RuntimeError, match="device=cpu"):
        cli.main(argv)
    proc = subprocess.run([sys.executable, "-m", "modulationdetectioncnn_torch", *argv],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert "device=cpu" in proc.stderr
    assert not proc.stdout.strip()


def test_new_cuda_wrappers_reject_what_the_kernel_does_not_take():
    """The v3/v2 stages take (B, 126, 8) int8 tap rows, the logits stage
    the conv map, the timing FIR (B, 2, T) float32 frames with (B, taps)
    odd-tap filters: anything else raises before a launch."""
    from modulationdetectioncnn_torch.dsp import normalize
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.quant import load_int8

    qw = load_int8(device="cpu")
    rows = torch.zeros((1, 126, 8), dtype=torch.int8, device="meta")
    planes = torch.zeros((1, 8, 128), dtype=torch.int8, device="meta")
    for stage in (infer.conv_stage_int8_v3, infer.conv_stage_int8_v2):
        with pytest.raises(ValueError, match="unsupported device"):
            stage(rows, qw)
        with pytest.raises(ValueError, match="expected"):
            stage(planes, qw)
    with pytest.raises(ValueError, match="unsupported device"):
        infer.dense_int8(torch.zeros((1, 9920), dtype=torch.int8, device="meta"), qw)
    x = torch.zeros((3, 2, 128), device="meta")
    c = torch.zeros((3, 17), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        normalize.correct_timing_fir(x, c)
    assert normalize.correct_timing_fir.launches == 0


TIMING_BLOCKED_RUN = r"""
import sys
for name in {forbidden!r}:
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import numpy as np
from modulationdetectioncnn_torch import cli
from modulationdetectioncnn_torch.dsp import fir
for argv in (["stream", "device=cpu", "stream.normalize_timing=true", "eval.int8_kernel=v3"],
             ["stream", "device=cpu", "stream.resample_up=1", "stream.resample_down=2",
              "eval.int8_kernel=v2"],
             ["bench", "device=cpu", "pallas_int8", "bench.batch_size=8",
              "bench.warmup_iters=1", "bench.timed_iters=2", "bench.stream_extra=false"]):
    assert cli.main(argv) == 0, argv
print("NO_JAX_OK", sorted(m for m in sys.modules
                          if m.split(".")[0] in {forbidden!r} and sys.modules[m]))
"""


def test_timing_resampler_v3_v2_run_with_jax_blocked():
    """The stream with timing correction and v3, with the resampler and v2,
    and the pallas_int8 bench run with every JAX module blocked."""
    code = TIMING_BLOCKED_RUN.format(forbidden=FORBIDDEN, repo=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK []" in proc.stdout


@pytest.mark.parametrize("argv", [["stream", "stream.normalize_timing=true"],
                                  ["stream", "stream.resample_up=1", "stream.resample_down=2"],
                                  ["stream", "eval.int8_kernel=v3"],
                                  ["eval", "eval.backend=int8", "eval.int8_kernel=v2"],
                                  ["bench", "pallas_int8_v3"], ["bench", "pallas_int8"]],
                         ids=["timing", "resampler", "stream_v3", "eval_v2", "bench_v3",
                              "bench_v2"])
def test_new_paths_raise_without_cuda(argv):
    """This slice's paths run on the card unless device=cpu is given."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the command would run on it")
    from modulationdetectioncnn_torch import cli

    with pytest.raises(RuntimeError, match="device=cpu"):
        cli.main(argv)


TRAIN_BLOCKED_RUN = r"""
import os, sys
for name in {forbidden!r}:
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
from modulationdetectioncnn_torch import cli
import modulationdetectioncnn_torch.train.loop, modulationdetectioncnn_torch.train.qat
import modulationdetectioncnn_torch.ops.infer_bf16
ck = {ck!r}
tiny = ["device=cpu", "data.classes=BPSK,QPSK", "model.num_classes=2",
        "model.conv1_filters=16", "model.conv2_filters=8", "model.dense_units=16",
        "data.frames_per_class_per_snr=2", "data.snr_db_min=10", "data.snr_db_max=18",
        "data.snr_db_step=8", "train.batch_size=8", "quant.calib_frames=12",
        "eval.batch_size=16", "eval.results_path={tmp}/r.json", "train.checkpoint_dir=" + ck]
assert cli.main(["train", *tiny, "train.num_steps=4", "train.warmup_steps=1",
                 "train.eval_every=2", "train.checkpoint_every=2"]) == 0
assert cli.main(["quantize", *tiny]) == 0
assert cli.main(["eval", *tiny, "eval.backend=int8", "eval.int8_kernel=v1",
                 "eval.int8_artifact=" + ck + "_int8"]) == 0
assert cli.main(["qat", *tiny, "train.num_steps=2"]) == 0
assert os.path.isfile(os.path.join(ck + "_qat", "0", "params.npz"))
assert cli.main(["bench", "device=cpu", "pallas_bf16_v4", "bench.batch_size=8",
                 "bench.warmup_iters=1", "bench.timed_iters=2",
                 "bench.stream_extra=false"]) == 0
print("NO_JAX_OK", sorted(m for m in sys.modules
                          if m.split(".")[0] in {forbidden!r} and sys.modules[m]))
"""


def test_train_qat_v1_bf16_run_with_jax_blocked(tmp_path):
    """train, quantize of what it wrote, eval with v1, qat, and the
    pallas_bf16_v4 bench run with every JAX module blocked."""
    code = TRAIN_BLOCKED_RUN.format(forbidden=FORBIDDEN, repo=REPO, tmp=tmp_path,
                                    ck=str(tmp_path / "ck"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK []" in proc.stdout


@pytest.mark.parametrize("argv", [["train"],
                                  ["qat", "train.checkpoint_dir=modulationdetectioncnn_torch/assets/ckpt_rml11_r5"],
                                  ["eval", "eval.backend=int8", "eval.int8_kernel=v1"],
                                  ["bench", "pallas_bf16_v4"]],
                         ids=["train", "qat", "eval_v1", "bench_bf16_v4"])
def test_train_qat_and_bf16_raise_without_cuda(argv):
    """This slice's commands run on the card unless device=cpu is given."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the command would run on it")
    from modulationdetectioncnn_torch import cli

    with pytest.raises(RuntimeError, match="device=cpu"):
        cli.main(argv)


def test_v1_and_bf16_wrappers_reject_what_the_kernel_does_not_take():
    """v1 takes (B, 2, 128) float32 frames; the bf16 stages their own
    shapes and dtypes; anything else, or a non-CUDA device, raises before a
    launch."""
    from modulationdetectioncnn_torch.ops import infer, infer_bf16
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2
    from modulationdetectioncnn_torch.quant import load_int8

    qw = load_int8(device="cpu")
    frames = torch.zeros((1, 2, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        infer.conv_stage_int8_v1(frames, qw)
    with pytest.raises(ValueError, match="expected"):
        infer.conv_stage_int8_v1(torch.zeros((1, 8, 128), dtype=torch.int8, device="meta"), qw)
    bw = infer_bf16.make_bf16_weights(VTCNN2().state_dict(), "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        infer_bf16.conv_stage_bf16_v4(frames, bw)
    with pytest.raises(ValueError, match="expected"):
        infer_bf16.dense_argmax_bf16(torch.zeros((1, 9920), device="meta"), bw)
    assert infer.conv_stage_int8_v1.launches == 0
    assert infer_bf16.launch_counts() == dict.fromkeys(
        ("conv_stage_bf16_v4", "dense_argmax_bf16", "conv_stage_bf16_v2",
         "dense_logits_bf16", "conv_stage_bf16"), 0)


BF16_BLOCKED_RUN = r"""
import sys
for name in {forbidden!r}:
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import numpy as np, torch
from modulationdetectioncnn_torch import bench
from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2
from modulationdetectioncnn_torch.ops import infer_bf16
x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 2, 128)).astype(np.float32))
sd = VTCNN2().state_dict()
for make in (infer_bf16.make_bf16_forward_v2, infer_bf16.make_bf16_forward):
    assert tuple(make(sd, "cpu")(x).shape) == (3, 11)
classify, (xb,) = bench.make_classifier(
    apply_overrides(AmcConfig(), ["device=cpu"]), "pallas_bf16", 3)
assert tuple(classify(xb).shape) == (3,)
print("NO_JAX_OK", sorted(m for m in sys.modules
                          if m.split(".")[0] in {forbidden!r} and sys.modules[m]))
"""


def test_bf16_forwards_and_pallas_bf16_run_with_jax_blocked():
    """Both bf16 forwards and the pallas_bf16 bench classifier run with
    every JAX module blocked."""
    code = BF16_BLOCKED_RUN.format(forbidden=FORBIDDEN, repo=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK []" in proc.stdout


PARALLEL_BLOCKED_RUN = r"""
import sys
for name in {forbidden!r}:
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import numpy as np, torch
from modulationdetectioncnn_torch.ops import cnn_kernels
from modulationdetectioncnn_torch.parallel import dryrun, halo, mesh
x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 2, 40)).astype(np.float32))
assert tuple(cnn_kernels.conv1_stacked(x, torch.ones(3, 5), torch.zeros(5)).shape) == (2, 38, 10)
assert dryrun.main(["device=cpu"]) == 0         # one rank, gloo
print("NO_JAX_OK", sorted(m for m in sys.modules
                          if m.split(".")[0] in {forbidden!r} and sys.modules[m]))
"""


def test_parallel_and_cnn_kernels_run_with_jax_blocked():
    """ops/cnn_kernels.py and parallel/ (the dryrun on one gloo rank: a
    training step on a 1x1 mesh, then the sharded float and int8 streams)
    run with every JAX module blocked."""
    code = PARALLEL_BLOCKED_RUN.format(forbidden=FORBIDDEN, repo=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO, stdin=subprocess.DEVNULL)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK []" in proc.stdout
    assert '"dryrun_multichip": "ok"' in proc.stdout


def test_parallel_paths_raise_without_cuda():
    """The sharded stream, its meshes and the dryrun run on the card unless
    given device=cpu; nothing initializes a process group first."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the paths would run on it")
    import torch.distributed as dist

    from modulationdetectioncnn_torch.config import MeshConfig
    from modulationdetectioncnn_torch.parallel import dryrun, halo, mesh

    for call in (lambda: mesh.make_mesh(MeshConfig()), lambda: halo.time_mesh(),
                 lambda: halo.dryrun(), lambda: dryrun.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="device=cpu"):
            call()
    assert not dist.is_initialized()


def test_cnn_kernel_wrappers_reject_what_the_kernel_does_not_take():
    """Rows 17-20 take float32 frames and conv1 weights, a bf16 or float32
    conv2 input with a weight of its type, int8 activations with int32
    shifts and offsets, of consistent shapes; anything else, or a non-CUDA
    device, raises before a launch and counts nothing."""
    from modulationdetectioncnn_torch.ops import cnn_kernels as ck

    ck.reset_launch_counts()

    def meta(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    i8, i32, bf = torch.int8, torch.int32, torch.bfloat16
    with pytest.raises(ValueError, match="unsupported device"):
        ck.conv1_stacked(meta((2, 2, 40)), meta((3, 5)), meta((5,)))
    with pytest.raises(ValueError, match="expected"):
        ck.conv1_stacked(meta((2, 2, 40), bf), meta((3, 5)), meta((5,)))
    with pytest.raises(ValueError, match="unsupported device"):
        ck.conv2_stacked(meta((2, 38, 10), bf), meta((10, 21), bf), meta((7,)))
    with pytest.raises(ValueError, match="expected"):
        ck.conv2_stacked(meta((2, 38, 10), bf), meta((10, 21)), meta((7,)))
    with pytest.raises(ValueError, match="unsupported device"):
        ck.conv1_stacked_int8(meta((2, 2, 40), i8), meta((3, 5), i8), meta((10,), i32),
                              meta((10,), i32))
    with pytest.raises(ValueError, match="expected"):
        ck.conv1_stacked_int8(meta((2, 2, 40), i8), meta((3, 5), i8), meta((10,)),
                              meta((10,), i32))
    with pytest.raises(ValueError, match="unsupported device"):
        ck.conv2_stacked_int8(meta((2, 38, 10), i8), meta((10, 21), i8), meta((7,), i32),
                              meta((7,), i32))
    with pytest.raises(ValueError, match="expected"):
        ck.conv2_stacked_int8(meta((2, 38), i8), meta((10, 21), i8), meta((7,), i32),
                              meta((7,), i32))
    assert ck.launch_counts() == dict.fromkeys(
        ("conv1_stacked", "conv2_stacked", "conv1_stacked_int8", "conv2_stacked_int8"), 0)


SCALING_BLOCKED_RUN = r"""
import sys
for name in {forbidden!r}:
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import torch
import modulationdetectioncnn_torch as pkg
assert not torch.cuda.is_initialized()
assert pkg.MODULATIONS and pkg.VTCNN2 and pkg.make_dataset and pkg.AmcConfig
from modulationdetectioncnn_torch import cli
from modulationdetectioncnn_torch.scripts import bench_breakdown, probe
assert cli.main(["scaling", "device=cpu", "bench.batch_size=64",
                 "bench.warmup_iters=1", "bench.timed_iters=2"]) == 0
print("NO_JAX_OK", sorted(m for m in sys.modules
                          if m.split(".")[0] in {forbidden!r} and sys.modules[m]))
"""


def test_package_scaling_and_probes_run_with_jax_blocked():
    """``import modulationdetectioncnn_torch`` (its public names, no CUDA
    touched), the ``scaling`` command on the CPU, the breakdown and the
    probes import with every JAX module blocked."""
    code = SCALING_BLOCKED_RUN.format(forbidden=FORBIDDEN, repo=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK []" in proc.stdout
    assert '"halo_samples": 112' in proc.stdout


def test_scaling_raises_without_cuda():
    """``scaling`` measures on the card unless given device=cpu, and names
    no device it did not measure on."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the command would run on it")
    from modulationdetectioncnn_torch import cli
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.eval.scaling import scaling_report

    with pytest.raises(RuntimeError, match="device=cpu"):
        cli.main(["scaling"])
    with pytest.raises(RuntimeError, match="device=cpu"):
        scaling_report(AmcConfig(), measured_chip_rate=7e8)
    proc = subprocess.run([sys.executable, "-m", "modulationdetectioncnn_torch", "scaling"],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert "device=cpu" in proc.stderr
    assert not proc.stdout.strip()


SCRIPT_BLOCKED_RUN = r"""
import os, sys
for name in {forbidden!r}:
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
from modulationdetectioncnn_torch.scripts import {script}
from modulationdetectioncnn_torch.utils.profiler import trace
with trace({trace_dir!r}):
    {script}.main(["device=cpu", *{tiny!r}, "out=" + {out!r}])
assert os.path.exists({out!r})
assert len([f for f in os.listdir({trace_dir!r}) if f.endswith(".pt.trace.json")]) == 1
print("NO_JAX_OK", sorted(m for m in sys.modules
                          if m.split(".")[0] in {forbidden!r} and sys.modules[m]))
"""
SCRIPT_TINY = {
    "bench_stream_variants": [
        "bench.batch_size=16", "bench.warmup_iters=1", "bench.timed_iters=1",
        "stream.num_subbands=4", "stream.taps_per_branch=4", "model.conv1_filters=32",
        "model.conv2_filters=16", "model.dense_units=32"],
    "train_eval_full": [
        "data.classes=BPSK,QPSK", "model.num_classes=2", "model.conv1_filters=16",
        "model.conv2_filters=8", "model.dense_units=16", "model.dtype=float32",
        "data.frames_per_class_per_snr=4", "data.snr_db_min=10", "data.snr_db_step=8",
        "train.batch_size=8", "train.num_steps=4", "train.warmup_steps=1",
        "train.eval_every=2", "quant.calib_frames=12", "eval.batch_size=16"],
}


@pytest.mark.parametrize("script", sorted(SCRIPT_TINY))
def test_scripts_and_trace_run_with_jax_blocked(tmp_path, script):
    """The stream variants and the flagship pipeline run on the CPU at a
    tiny size under ``utils/profiler.py::trace`` (one trace file) with
    every JAX module blocked."""
    code = SCRIPT_BLOCKED_RUN.format(
        forbidden=FORBIDDEN, repo=REPO, script=script, tiny=SCRIPT_TINY[script],
        out=str(tmp_path / "out"), trace_dir=str(tmp_path / "trace"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK []" in proc.stdout


@pytest.mark.parametrize("script", sorted(SCRIPT_TINY))
def test_scripts_raise_without_cuda(tmp_path, script):
    """Both scripts run on the card unless given device=cpu: without one
    they raise before writing anything, as a function and as a module."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the script would run on it")
    mod = importlib.import_module(f"modulationdetectioncnn_torch.scripts.{script}")
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="device=cpu"):
        mod.main([f"out={out}"])
    proc = subprocess.run([sys.executable, "-m", mod.__name__, f"out={out}"],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert "device=cpu" in proc.stderr
    assert not proc.stdout.strip()
    assert not out.exists()
