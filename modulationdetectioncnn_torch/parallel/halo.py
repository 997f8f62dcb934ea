"""Time-block sharded streaming with a halo exchange between neighbouring
ranks.

Counterpart of ``modulationdetectioncnn_tpu/parallel/halo.py``. The
continuous I/Q stream is split into P contiguous time blocks over the
mesh's ``time`` axis, one per rank. Each rank needs the last ``halo``
samples of its left neighbour as front-end history (resampler tail,
channelizer FIR state and the reach of overlapping frames, composed by
``dsp/pipeline.py::plan_frontend``); they move in one point-to-point hop,
rank i to rank i+1 (``left_halo_exchange``), where the JAX package used one
``jax.lax.ppermute``. The front end and the classifier then run on each
block alone, and one all-gather over the axis assembles the labels in time
order. The labels equal the whole-stream labels of ``classify_stream``.
"""
from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from modulationdetectioncnn_torch.config import StreamConfig
from modulationdetectioncnn_torch.device import resolve_device
from modulationdetectioncnn_torch.dsp import pipeline
from modulationdetectioncnn_torch.dsp.channelizer import design_prototype
from modulationdetectioncnn_torch.parallel import mesh as pmesh


def left_halo_exchange(x_local: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Prepend each rank's block with its left neighbour's last ``halo``
    samples (zeros on the group's rank 0: the stream has no history there).

    x_local: (..., T_local) on each rank, e.g. the (2, T_local) I/Q planes.
    Returns (..., halo + T_local). The tail goes to the next rank of
    ``group`` by ``batch_isend_irecv``; on a gloo group a tail on a card
    travels through host memory (gloo has no point-to-point for CUDA
    tensors)."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    tail = x_local[..., x_local.shape[-1] - halo:].contiguous()
    staged = pmesh._staged(x_local, group)
    send = tail.cpu() if staged else tail
    recv = torch.zeros_like(send)
    ops = []
    if idx + 1 < n:
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, idx + 1), group))
    if idx > 0:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, idx - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([recv.to(x_local.device), x_local], dim=-1)


def classify_stream_sharded(x, predict_fn: Callable[[torch.Tensor], torch.Tensor],
                            sc: StreamConfig, mesh: DeviceMesh,
                            h: np.ndarray | None = None,
                            time_axis: str = "time") -> torch.Tensor:
    """The distributed ``pipeline.classify_stream_blocked``, label-exact
    against ``pipeline.classify_stream``.

    x: the whole (2, T) wideband I/Q planes (a tensor or array, the same on
    every rank), T divisible by the ``time_axis`` size, each rank's share
    passing ``pipeline.check_block_alignment``. Each rank keeps its own
    block on the mesh's device, exchanges the halo, runs the front end and
    ``predict_fn`` on it; returns the (M, F) labels on every rank."""
    h = h if h is not None else design_prototype(sc.num_subbands, sc.taps_per_branch)
    plan = pipeline.plan_frontend(sc)
    m = sc.num_subbands
    group = mesh.get_group(time_axis)
    n_dev = pmesh.axis_size(mesh, time_axis)
    idx = pmesh.coordinate(mesh, time_axis)
    t_len = x.shape[-1]
    if t_len % n_dev:
        raise ValueError(f"stream length {t_len} is not divisible by {n_dev} ranks")
    t_local = t_len // n_dev
    pipeline.check_block_alignment(sc, t_local)
    # Here the caller picks the per-rank block (t_len / n_dev); when the time
    # axis spans hosts, warn if it undercuts the floor that
    # pipeline.effective_block_len enforces on the blocked path.
    hosts = pipeline.n_hosts()
    if hosts > 1:
        floor = pipeline.effective_block_len(sc, hosts)
        if t_local < floor:
            warnings.warn(
                f"per-rank time block {t_local} is below the multi-host floor {floor}; "
                "each hop between hosts is amortized over too short a block (see "
                "StreamConfig.block_len_dcn_floor)", stacklevel=2)
    dev = torch.device(mesh.device_type)
    x_loc = torch.as_tensor(x[..., idx * t_local:(idx + 1) * t_local],
                            dtype=torch.float32).to(dev)
    hr = (pipeline.design_resampler(sc) if (plan.up, plan.down) != (1, 1) else None)
    xb = left_halo_exchange(x_loc, plan.halo_in, group)
    fr = pipeline.block_frontend(xb, h, hr, sc, plan)        # (M, F_loc, 2, f)
    f_loc = fr.shape[1]
    labels = predict_fn(fr.reshape(m * f_loc, 2, fr.shape[-1])).reshape(m, f_loc)
    labels = pmesh.all_gather_cat(labels, group, dim=1)      # time order
    n_total = pipeline.total_frames(sc, t_len)
    return labels[:, plan.n_lead_frames:plan.n_lead_frames + n_total]


def time_mesh(n_devices: int | None = None, device: str | torch.device = "cuda"
              ) -> DeviceMesh:
    """A 1-D mesh ``("time",)`` of the first ``n_devices`` ranks (default:
    all) on ``device``."""
    pmesh.ensure_process_group(device)
    n = n_devices or dist.get_world_size()
    if n > dist.get_world_size():
        raise ValueError(f"time mesh needs {n} ranks, have {dist.get_world_size()}")
    return DeviceMesh(resolve_device(device).type, torch.arange(n),
                      mesh_dim_names=("time",))


def dryrun(mesh: DeviceMesh | None = None, device: str | torch.device | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The multi-rank smoke path (``parallel/dryrun.py::dryrun_multichip``
    runs it): the halo-exchange streaming classification on a time mesh of
    the ranks of ``mesh`` (default: all), first with the float VT-CNN2
    forward as the classifier, then with the port's PTQ of it through the
    int8 v7 classifier (on a card, kernel-table rows 1 and 2). Every rank's
    labels must equal the single-rank ``classify_stream`` labels of the
    same signal (the whole stream may hold one frame more). Returns the two
    (M, F) label tensors."""
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2
    from modulationdetectioncnn_torch.ops.infer import make_int8_predict
    from modulationdetectioncnn_torch.quant import int8_weights_from_numpy
    from modulationdetectioncnn_torch.train.quant import quantize

    dev = resolve_device(device or (mesh.device_type if mesh is not None else "cuda"))
    pmesh.ensure_process_group(dev)
    ranks = mesh.mesh.flatten() if mesh is not None else torch.arange(dist.get_world_size())
    tm = DeviceMesh(dev.type, ranks, mesh_dim_names=("time",))
    n_dev = tm.size()
    sc = StreamConfig(num_subbands=4, taps_per_branch=4, frame_hop=128)
    t_len = n_dev * 4 * 128 * 2
    r = np.random.default_rng(0)
    x = r.standard_normal((2, t_len)).astype(np.float32)      # I/Q planes
    model = VTCNN2(dtype="float32", generator=torch.Generator().manual_seed(0)).to(dev).eval()

    @torch.no_grad()
    def predict(xb: torch.Tensor) -> torch.Tensor:
        return model(xb).argmax(-1)

    calib = r.standard_normal((64, 2, sc.frame_len)).astype(np.float32)
    predict_i8 = make_int8_predict(int8_weights_from_numpy(quantize(model, calib), dev), "v7")
    out = []
    for fn in (predict, predict_i8):
        labels = classify_stream_sharded(x, fn, sc, tm)
        want = pipeline.classify_stream(torch.from_numpy(x).to(dev), fn, sc)
        f = labels.shape[1]
        if (labels.shape[0] != sc.num_subbands or f < want.shape[1] - 1
                or not torch.equal(labels, want[:, :f])):
            raise RuntimeError(f"sharded stream labels {tuple(labels.shape)} differ from "
                               f"the single-rank labels {tuple(want.shape)}")
        out.append(labels)
    return out[0], out[1]
