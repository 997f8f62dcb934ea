"""``utils/profiler.py::trace``, the port's counterpart of the JAX package's
``trace`` (``jax.profiler.trace`` of a region when ``logdir`` or
``AMC_TRACE_DIR`` is set), on the CPU: no profiler and no file without a
directory; with one, one Chrome/Perfetto trace file per region holding the
region's CPU operators; an exception in the region propagates unchanged."""
import json
import os

import pytest
import torch

from modulationdetectioncnn_torch.utils.profiler import trace


def _work():
    a = torch.ones(64, 64)
    return (a @ a).sum()


def _trace_files(d):
    return sorted(os.listdir(d))


def _cpu_ops(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "cpu_op"]


def test_no_directory_runs_without_a_profiler(tmp_path, monkeypatch):
    monkeypatch.delenv("AMC_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with trace():
        assert not torch.autograd._profiler_enabled()
        _work()
    with trace(None):
        _work()
    with trace(""):
        _work()
    assert _trace_files(tmp_path) == []


def test_one_parseable_trace_with_cpu_ops(tmp_path, monkeypatch):
    monkeypatch.delenv("AMC_TRACE_DIR", raising=False)
    d = tmp_path / "tb" / "run"
    with trace(str(d)):
        assert torch.autograd._profiler_enabled()
        _work()
    assert not torch.autograd._profiler_enabled()
    files = _trace_files(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert f"_{os.getpid()}." in files[0]
    ops = {e["name"] for e in _cpu_ops(d / files[0])}
    assert any("mm" in name for name in ops), sorted(ops)


def test_env_directory_is_honoured(tmp_path, monkeypatch):
    monkeypatch.setenv("AMC_TRACE_DIR", str(tmp_path / "env"))
    with trace():
        _work()
    assert len(_trace_files(tmp_path / "env")) == 1
    # An explicit directory wins over the environment's.
    with trace(str(tmp_path / "arg")):
        _work()
    assert len(_trace_files(tmp_path / "arg")) == 1
    assert len(_trace_files(tmp_path / "env")) == 1


def test_two_regions_write_two_files(tmp_path):
    for _ in range(2):
        with trace(str(tmp_path)):
            _work()
    files = _trace_files(tmp_path)
    assert len(files) == 2 and files[0] != files[1]
    for name in files:
        assert _cpu_ops(tmp_path / name)


def test_exception_in_the_region_propagates(tmp_path):
    class Boom(Exception):
        pass

    err = Boom("region failed")
    with pytest.raises(Boom) as got:
        with trace(str(tmp_path)):
            _work()
            raise err
    assert got.value is err
    assert not torch.autograd._profiler_enabled()
    assert len(_trace_files(tmp_path)) == 1
