"""The port's ``parallel/`` on the CPU: ranks as processes of their own
(``tests/torch_parallel_worker.py``) in a gloo group from a file store,
against the JAX package's tests of the same paths (tests/test_halo.py,
tests/test_model_sharding.py) and against the JAX package itself.

Each group of ranks is started once per module and joined within its own
time limit; a rank that exits non-zero, or a group that outlives its limit,
fails every test that reads it. Tolerances: labels equal; the channel-
sharded forward within 1e-5 of the unsharded one (float32 sums in another
order, tests/test_model_sharding.py:23); tensor- against data-parallel
training within rtol 2e-2, atol 5e-3 (tests/test_model_sharding.py:85).
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from modulationdetectioncnn_torch.config import (
    AmcConfig, MeshConfig, StreamConfig, apply_overrides)
from modulationdetectioncnn_torch.dsp import pipeline as tpipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
TIME_LIMIT_S = {"four": 300, "two": 240, "train": 300}


def _run_ranks(scenario: str, world: int, tmp) -> list[dict]:
    """Start ``world`` ranks of ``scenario``, join them within the
    scenario's time limit, and return each rank's results."""
    env = dict(os.environ, AMC_TEST_CKPT=str(tmp / "ck"), OMP_NUM_THREADS="1")
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, scenario, str(r), str(world),
                               str(tmp / "store"), str(tmp)],
                              stdin=subprocess.DEVNULL, stdout=logs[r],
                              stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for r in range(world)]
    deadline = time.monotonic() + TIME_LIMIT_S[scenario]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{scenario}: {world} ranks did not finish in "
                    f"{TIME_LIMIT_S[scenario]} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (f"{scenario} rank {r} exited {p.returncode}:\n"
                                   + (tmp / f"rank{r}.log").read_text()[-4000:])
    out = []
    for r in range(world):
        with np.load(tmp / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run_ranks("four", 4, tmp_path_factory.mktemp("four"))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run_ranks("two", 2, tmp_path_factory.mktemp("two"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    return _run_ranks("train", 4, tmp), tmp / "ck"


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])


def test_left_halo_exchange_values(four):
    """The exchanged halo is exactly the left neighbour's tail, zeros on
    rank 0 (tests/test_halo.py:52)."""
    t_local, h = 16, 3
    for d, r in enumerate(four):
        out = r["halo"]
        want_halo = np.zeros(h) if d == 0 else np.arange(d * t_local - h, d * t_local)
        np.testing.assert_array_equal(out[:h], want_halo)
        np.testing.assert_array_equal(out[h:], np.arange(d * t_local, (d + 1) * t_local))


@pytest.mark.parametrize("case", ["two/plain", "two/resampled", "four/plain"])
def test_sharded_equals_single_process(case, request):
    """Sharded labels equal the whole-stream labels of one process, on
    every rank, without and with the 2:3 resampler (tests/test_halo.py:34,82)."""
    group, kind = case.split("/")
    ranks = request.getfixturevalue(group)
    for r in ranks:
        got, want = r[f"{kind}_got"], r[f"{kind}_want"]
        f = got.shape[1]
        assert got.shape[0] == 8 and f >= want.shape[1] - 1
        np.testing.assert_array_equal(got, want[:, :f])


def test_sharded_v7_labels_match_jax(four):
    """The deployed int8 artifact through the port's v7 on 4 ranks against
    the JAX package's ``classify_stream_sharded`` on its 8-device CPU mesh
    with its v7 in interpret mode, on the same demo-style signal: equal on
    the occupied subbands, >= 99 % overall (CPU matmuls of the two libraries
    round the CFO spectrum differently on noise-only frames)."""
    import jax
    from jax.sharding import Mesh

    from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, QuantizedModel
    from modulationdetectioncnn_tpu.config import StreamConfig as JStreamConfig
    from modulationdetectioncnn_tpu.dsp.framer import to_planes
    from modulationdetectioncnn_tpu.ops.infer import make_int8_predict
    from modulationdetectioncnn_tpu.parallel import halo as jhalo
    from modulationdetectioncnn_tpu.train.quant import QuantizedModel as JQM

    _same_on_every_rank(four, "v7_labels")
    cfg = dataclasses.replace(AmcConfig(device="cpu"), stream=StreamConfig(block_len=8192))
    wide, occupied = tpipe.make_demo_signal(cfg)
    qm = JQM.from_tree(QuantizedModel.from_npz(DEFAULT_ARTIFACT).tree())
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8), ("time",))
    want = np.asarray(jhalo.classify_stream_sharded(
        to_planes(wide), make_int8_predict(qm, "v7", interpret=True),
        JStreamConfig(block_len=8192), mesh))
    got = four[0]["v7_labels"]
    assert got.shape == want.shape == (16, 16)
    occ = sorted(occupied)
    np.testing.assert_array_equal(got[occ], want[occ])
    assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("case", ["two/tp12", "four/tp22"])
def test_model_sharded_forward_matches_unsharded(case, request):
    """The channel-sharded forward on (data, model) = (1, 2) and (2, 2)
    equals the unsharded one within 1e-5 (tests/test_model_sharding.py:23),
    in eval mode and in train mode with dropout masks from one seed; the
    gathered shards are the model's parameters exactly."""
    group, key = case.split("/")
    for r in request.getfixturevalue(group):
        assert float(r[f"{key}_scale"]) > 0.1
        assert float(r[f"{key}_eval_err"]) <= 1e-5
        assert float(r[f"{key}_train_err"]) <= 1e-5
        assert bool(r[f"{key}_gather_equal"]) and bool(r[f"{key}_replicated_rows"])


def test_shard_params_splits_filters_and_columns(four):
    """On model = 4 each rank holds 1/4 of conv1's filters and bias, of
    conv2's input channels, of Dense1's units and Dense2's inputs; conv2's
    bias stays whole (tests/test_model_sharding.py:38)."""
    for r in four:
        np.testing.assert_array_equal(r["shard_shapes"], [64, 64, 64, 64, 64, 80])
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2
    from modulationdetectioncnn_torch.parallel import mesh as pmesh

    assert pmesh.param_spec(VTCNN2()) == {
        "conv1.weight": 0, "conv1.bias": 0, "conv2.weight": 1, "conv2.bias": None,
        "dense1.weight": 0, "dense1.bias": 0, "dense2.weight": 1, "dense2.bias": None}
    assert pmesh.Sharding(1, 2).rows(64) == slice(32, 64)


def test_make_mesh_raises_with_too_few_ranks(four):
    for r in four:
        assert "needs 8 ranks, have 4" in str(r["too_few_ranks"])
    from modulationdetectioncnn_torch.parallel import mesh as pmesh

    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        pmesh.make_mesh(MeshConfig(data=2), "cpu")      # no process group here


def test_hosts_and_block_floor_warning(four):
    """Under torchrun's LOCAL_WORLD_SIZE = 2 the 4 ranks are 2 hosts, and a
    per-rank block below block_len_dcn_floor warns."""
    for r in four:
        assert int(r["n_hosts"]) == 2 and bool(r["dcn_warning"])
    assert tpipe.n_hosts() == 1                          # no process group here


def test_dryrun_multichip_on_four_ranks(four):
    """``dryrun_multichip(4, "cpu")``: a (2, 2) mesh, one training step,
    then ``halo.dryrun``'s float and int8 v7 streams, each equal to the
    single-rank labels (it raises otherwise)."""
    for r in four:
        assert float(r["dryrun_loss"]) > 0


def test_train_honors_mesh_data_and_model(trained):
    """``train`` with mesh.data=2 mesh.model=2 learns the 2-class config
    (tests/test_model_sharding.py:52)."""
    ranks, _ = trained
    _same_on_every_rank(ranks, "learn_loss")
    loss, acc = ranks[0]["learn_loss"], ranks[0]["learn_acc"]
    assert loss[0] > loss[-1] and acc[-1] > 0.7


def test_train_model_sharded_matches_data_parallel(trained):
    """The same seed on (data, model) = (2, 2) and (4, 1): the gathered
    parameters agree (tests/test_model_sharding.py:85)."""
    ranks, _ = trained
    keys = [k for k in ranks[0] if k.startswith("tp/")]
    assert len(keys) == 8
    for k in keys:
        np.testing.assert_allclose(ranks[0][k], ranks[0]["dp/" + k[3:]], rtol=2e-2, atol=5e-3)
        _same_on_every_rank(ranks, k)


def test_train_mesh_checkpoint_is_whole_and_resumes(trained):
    """``python -m modulationdetectioncnn_torch train mesh.data=2
    mesh.model=2`` (the CLI in each rank): rank 0 writes the whole model in
    the usual format, which restores into a full-width model; a resume from
    step 4 logs steps 5 and 6."""
    from modulationdetectioncnn_torch.utils import checkpoint as ckpt

    ranks, ck = trained
    np.testing.assert_array_equal(ranks[0]["resumed_steps"], [5, 6])
    assert sorted(os.listdir(ck)) == ["2", "4", "6"]
    state, opt_state, step = ckpt.restore_train_state(str(ck))
    assert step == 6 and opt_state.count == 6
    assert tuple(state["conv1.weight"].shape) == (32, 1, 1, 3)
    assert tuple(state["dense1.weight"].shape) == (32, 124 * 16)
    assert tuple(opt_state.mu["dense1.weight"].shape) == (32, 124 * 16)


@pytest.mark.parametrize("n_processes", [1, 2])
def test_effective_block_len_matches_jax(n_processes):
    from modulationdetectioncnn_tpu.config import StreamConfig as JStreamConfig
    from modulationdetectioncnn_tpu.dsp.pipeline import effective_block_len

    for kw in ({}, {"block_len": 1 << 21}, {"block_len_dcn_floor": 1 << 16}):
        assert tpipe.effective_block_len(StreamConfig(**kw), n_processes) == \
            effective_block_len(JStreamConfig(**kw), n_processes)
    sc = StreamConfig()
    want = sc.block_len if n_processes == 1 else sc.block_len_dcn_floor
    assert tpipe.effective_block_len(sc, n_processes) == want


def test_blocked_stream_uses_the_floor_across_hosts(monkeypatch):
    """With two hosts ``classify_stream_blocked`` cuts blocks of
    ``block_len_dcn_floor``, and its labels still equal the whole stream's."""
    from modulationdetectioncnn_torch.dsp import framer
    from modulationdetectioncnn_torch.ops.infer import make_int8_predict
    from modulationdetectioncnn_torch.quant import load_int8

    sc = StreamConfig(num_subbands=8, taps_per_branch=8, block_len=1024,
                      block_len_dcn_floor=4096)
    x = framer.to_planes(np.random.default_rng(0).standard_normal(8192).astype(np.complex64))
    predict = make_int8_predict(load_int8(device="cpu"))
    seen = []
    real = tpipe.check_block_alignment
    monkeypatch.setattr(tpipe, "check_block_alignment",
                        lambda s, block: seen.append(block) or real(s, block))
    monkeypatch.setattr(tpipe, "n_hosts", lambda: 2)
    got = tpipe.classify_stream_blocked(x, predict, sc).numpy()
    assert seen == [4096]
    np.testing.assert_array_equal(got, tpipe.classify_stream(x, predict, sc).numpy())


@pytest.mark.parametrize("override", ["quant.weight_per_channel=true", "mesh.model=2",
                                      "mesh.data=4", "mesh.time=2",
                                      "stream.block_len_dcn_floor=2097152"])
def test_jax_overrides_are_accepted(override):
    """Overrides the JAX package takes mean the same in the port."""
    from modulationdetectioncnn_tpu.config import AmcConfig as JAmcConfig
    from modulationdetectioncnn_tpu.config import apply_overrides as japply

    key = override.split("=")[0]
    head, field = key.split(".")
    got = getattr(getattr(apply_overrides(AmcConfig(), [override]), head), field)
    assert got == getattr(getattr(japply(JAmcConfig(), [override]), head), field)


def test_weight_per_channel_false_is_refused():
    """The quantizer has per-channel scales only: false is a bad override,
    not an ignored one."""
    from modulationdetectioncnn_torch import cli

    with pytest.raises(ValueError, match="per-channel"):
        apply_overrides(AmcConfig(), ["quant.weight_per_channel=false"])
    with pytest.raises(SystemExit, match="bad override"):
        cli.main(["quantize", "quant.weight_per_channel=false"])


def test_port_config_has_every_jax_field_with_its_default():
    from modulationdetectioncnn_tpu.config import AmcConfig as JAmcConfig

    def walk(j, t, path):
        for f in dataclasses.fields(j):
            jv = getattr(j, f.name)
            assert hasattr(t, f.name), path + f.name
            tv = getattr(t, f.name)
            if dataclasses.is_dataclass(jv):
                walk(jv, tv, path + f.name + ".")
            else:
                assert tv == jv, path + f.name

    walk(JAmcConfig(), AmcConfig(), "")
