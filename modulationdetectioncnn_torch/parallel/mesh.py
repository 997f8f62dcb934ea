"""The mesh of ranks, channel sharding of the VT-CNN2 and the collectives
the port's parallel paths use, on ``torch.distributed``.

Counterpart of ``modulationdetectioncnn_tpu/parallel/mesh.py``. The JAX
package names three logical axes of a ``jax.sharding.Mesh`` and leaves the
collectives to the compiler; here the axes are the dimensions of a
``torch.distributed.device_mesh.DeviceMesh`` of ranks, one process each:

- ``data``: data parallelism over frames (each rank a slice of the batch,
  gradients averaged over the axis);
- ``model``: channel sharding, tensor parallelism written out by hand
  (``ShardedVTCNN2``): conv1's filters and Dense1's units are split over the
  axis, conv2 and Dense2 contract over the split channels and sum over it;
- ``time``: time-block sharding of the stream (``parallel/halo.py``).

Process groups: NCCL for one rank per card, gloo on the CPU. NCCL refuses
two ranks on one card and gloo's point-to-point aborts on a CUDA tensor, so
where the group's backend is gloo and a tensor lies on a card (ranks
sharing one card, as ``chip_smoke.py`` runs them) every collective here
stages the tensor through host memory; the backend decides, not a failed
call.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.nn import functional as F

from modulationdetectioncnn_torch.config import MeshConfig
from modulationdetectioncnn_torch.device import resolve_device
from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2

AXES = ("data", "model", "time")
TIMEOUT = timedelta(seconds=300)


# ---------------------------------------------------------- process groups


def backend_for(device: torch.device) -> str:
    """NCCL for ranks on cards, gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def init_from_env(device: str | torch.device = "cuda") -> bool:
    """Initialize the default process group from ``torchrun``'s environment
    when it says ``WORLD_SIZE`` > 1 (NCCL on cards, each rank on card
    ``LOCAL_RANK``; gloo for ``device=cpu``). Returns whether it did (not
    when a group exists already or the world is one rank)."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend_for(dev), timeout=TIMEOUT)
    return True


def ensure_process_group(device: str | torch.device = "cuda") -> None:
    """``init_from_env``, or else a process group of this one rank (a store
    on a free localhost port), so that a mesh of one rank needs no
    launcher, as a one-device JAX mesh needs none."""
    if dist.is_initialized() or init_from_env(device):
        return
    dev = resolve_device(device)
    if dev.type == "cuda" and "LOCAL_RANK" not in os.environ:
        torch.cuda.set_device(torch.cuda.current_device())
    store = dist.TCPStore("localhost", 0, 1, is_master=True, timeout=TIMEOUT)
    dist.init_process_group(backend_for(dev), store=store, rank=0, world_size=1,
                            timeout=TIMEOUT)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective on ``group`` takes ``t`` through host memory:
    gloo and a tensor on a card."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor, the sum of ``t`` over the ranks of ``group``."""
    if dist.get_world_size(group) == 1:
        return t.clone()
    buf = t.detach().to("cpu", copy=True) if _staged(t, group) else t.detach().clone()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` (one shape) concatenated along ``dim`` in the
    group's rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.clone()
    src = t.detach().contiguous()
    if _staged(t, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


# ------------------------------------------------------------------- mesh


def make_mesh(cfg: MeshConfig | None = None, devices: str | torch.device | None = None
              ) -> DeviceMesh:
    """A (data, model, time) ``DeviceMesh`` of the first data*model*time
    ranks, on ``devices`` (the device type every rank computes on: ``cuda``
    unless the caller asks for ``cpu``). Missing axes have size 1; the
    default is every rank on ``data``. Raises ``ValueError`` when the mesh
    needs more ranks than the world has. A world of one rank needs no
    launcher (``ensure_process_group``)."""
    dev = resolve_device(devices or "cuda")
    world = dist.get_world_size() if dist.is_initialized() else 1
    cfg = cfg or MeshConfig(data=world)
    n = cfg.data * cfg.model * cfg.time
    if n > world:
        raise ValueError(f"mesh {cfg} needs {n} ranks, have {world}")
    ensure_process_group(dev)
    ranks = torch.arange(n).reshape(cfg.data, cfg.model, cfg.time)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def coordinate(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along ``axis``; raises if it is outside the mesh."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    return mesh.get_local_rank(axis)


# Which dimension of each VT-CNN2 parameter (torch layouts: conv weights
# OIHW, Linear weights (out, in)) is split over the model axis; None =
# replicated. conv2 and Dense2 contract over the split channels, so their
# outputs are partial sums that one all-reduce completes; their biases are
# added after it.
_VTCNN2_RULES = {
    "conv1.weight": 0,       # (C1, 1, 1, 3): conv1's filters
    "conv1.bias": 0,
    "conv2.weight": 1,       # (C2, C1, 2, 3): its input channels
    "conv2.bias": None,
    "dense1.weight": 0,      # (D, 124*C2): Dense1's units
    "dense1.bias": 0,
    "dense2.weight": 1,      # (N, D): its input units
    "dense2.bias": None,
}


def param_spec(params) -> dict[str, int | None]:
    """{parameter name: its dimension split over ``model``, or None} for a
    VT-CNN2 module or state dict."""
    names = params.state_dict() if isinstance(params, torch.nn.Module) else params
    return {k: _VTCNN2_RULES.get(k) for k in names}


@dataclass(frozen=True)
class Sharding:
    """A split of a tensor's leading (batch) axis over ranks: this rank
    holds part ``index`` of ``count`` equal parts (the port's counterpart of
    a ``NamedSharding`` over the batch)."""
    index: int
    count: int

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n`` (divisible by ``count``)."""
        if n % self.count:
            raise ValueError(f"batch {n} is not divisible by {self.count} ranks")
        return slice(self.index * (n // self.count), (self.index + 1) * (n // self.count))


def batch_sharding(mesh: DeviceMesh) -> Sharding:
    """The global batch split over ``data``: this rank's slice."""
    return Sharding(coordinate(mesh, "data"), axis_size(mesh, "data"))


def replicated(mesh: DeviceMesh) -> Sharding:
    """The whole tensor on every rank of ``mesh``."""
    coordinate(mesh, "data")
    return Sharding(0, 1)


class _SumOverModel(torch.autograd.Function):
    """Sum of partial results over the model axis in forward; identity in
    backward: every rank holds the same upstream gradient of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """Identity in forward, where a replicated tensor enters a layer split
    over the model axis; sum over the axis in backward, since each rank's
    split layer gives only its part of the input's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class ShardedVTCNN2(VTCNN2):
    """This rank's shard of a VT-CNN2 on a mesh: a ``VTCNN2`` whose
    parameters are its slices under ``_VTCNN2_RULES`` (the same names, so an
    optimizer and a checkpoint map them by name), and whose forward is the
    tensor-parallel one:

    conv1 on this rank's filters -> ReLU -> dropout; conv2 over those
    channels, sum over ``model``, + bias -> ReLU -> dropout; Dense1 on this
    rank's units -> ReLU -> dropout; Dense2 over those units, sum over
    ``model``, + bias. Dropout draws each mask for the global batch at full
    width from the generator, as the unsharded model does, then keeps this
    rank's rows and channels: the masks do not depend on the mesh."""

    def __init__(self, model: VTCNN2, mesh: DeviceMesh):
        c1, c2 = model.conv1.out_channels, model.conv2.out_channels
        d, nc = model.dense1.out_features, model.dense2.out_features
        k = axis_size(mesh, "model")
        if c1 % k or d % k:
            raise ValueError(f"conv1 filters {c1} and dense units {d} must divide by "
                             f"the model axis size {k}")
        frame_len = model.dense1.in_features // c2 + 4
        super().__init__(num_classes=nc, conv1_filters=c1 // k, conv2_filters=c2,
                         dense_units=d // k, dropout_rate=model.dropout_rate,
                         dtype=model.dtype, frame_len=frame_len,
                         generator=torch.Generator().manual_seed(0))
        self.group = mesh.get_group("model")
        self.full_widths = (c1, d)
        self.part = coordinate(mesh, "model")
        self.to(next(model.parameters()).device)
        self.load_state_dict(shard_tensors(model.state_dict(), mesh))

    def _dropout(self, h: torch.Tensor, rate: float, generator, rows: slice,
                 total: int, channels: slice | None) -> torch.Tensor:
        """Dropout of this rank's block of a (total, channels, ...) map."""
        if rate == 0.0:
            return h
        full = list(h.shape)
        full[0] = total
        if channels is not None:
            full[1] = self.full_widths[0] if h.dim() == 4 else self.full_widths[1]
        keep = torch.rand(full, generator=generator, device=h.device) < 1.0 - rate
        keep = keep[rows] if channels is None else keep[rows, channels]
        return torch.where(keep, h / (1.0 - rate),
                           torch.zeros((), dtype=h.dtype, device=h.device))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                rows: slice | None = None, total: int | None = None) -> torch.Tensor:
        """This rank's rows ``rows`` of a global batch of ``total`` frames
        (default: ``x`` is the whole batch) -> their (B, C) fp32 logits,
        the same on every rank of the model axis."""
        rows = rows if rows is not None else slice(0, x.shape[0])
        total = total if total is not None else x.shape[0]
        rate = self.dropout_rate if self.training else 0.0
        c1_part = slice(self.part * self.conv1.out_channels,
                        (self.part + 1) * self.conv1.out_channels)
        d_part = slice(self.part * self.dense1.out_features,
                       (self.part + 1) * self.dense1.out_features)
        dt = self.dtype
        h = x.to(dt)[:, None]
        h = F.conv2d(h, self.conv1.weight.to(dt), self.conv1.bias.to(dt))
        h = self._dropout(torch.relu(h), rate, generator, rows, total, c1_part)
        h = F.conv1d(h.flatten(1, 2), self.conv2.weight.to(dt).flatten(1, 2))[:, :, None]
        h = _SumOverModel.apply(h, self.group) + self.conv2.bias.to(dt)[:, None, None]
        h = self._dropout(torch.relu(h), rate, generator, rows, total, None)
        h = h.permute(0, 2, 3, 1).flatten(1)
        h = _CopyToModel.apply(h, self.group)
        h = F.linear(h, self.dense1.weight.to(dt), self.dense1.bias.to(dt))
        h = self._dropout(torch.relu(h), rate, generator, rows, total, d_part)
        h = F.linear(h, self.dense2.weight.to(dt))
        h = _SumOverModel.apply(h, self.group) + self.dense2.bias.to(dt)
        return h.to(torch.float32)


def shard_params(model: VTCNN2, mesh: DeviceMesh) -> ShardedVTCNN2:
    """This rank's shard of ``model`` under the VT-CNN2 rules (every rank
    passes the same full model)."""
    return ShardedVTCNN2(model, mesh)


def shard_tensors(tensors: dict[str, torch.Tensor], mesh: DeviceMesh
                  ) -> dict[str, torch.Tensor]:
    """This rank's slices (keys: parameter names) of whole tensors, under
    the VT-CNN2 rules: the inverse of ``gather_tensors``."""
    k, i = axis_size(mesh, "model"), coordinate(mesh, "model")
    out = {}
    for name, t in tensors.items():
        dim = _VTCNN2_RULES[name]
        out[name] = t if dim is None else t.narrow(dim, i * (t.shape[dim] // k),
                                                   t.shape[dim] // k)
    return out


def gather_tensors(tensors: dict[str, torch.Tensor], group) -> dict[str, torch.Tensor]:
    """Whole tensors from this rank's shards (keys: parameter names), by an
    all-gather over ``group`` (the model axis) along each rule's dimension."""
    out = {}
    for name, t in tensors.items():
        dim = _VTCNN2_RULES[name]
        out[name] = t.detach().clone() if dim is None else all_gather_cat(t, group, dim)
    return out


def gather_model(sharded: ShardedVTCNN2) -> VTCNN2:
    """The whole VT-CNN2 (eval mode) from the shards, on every rank."""
    c1, d = sharded.full_widths
    full = VTCNN2(num_classes=sharded.dense2.out_features, conv1_filters=c1,
                  conv2_filters=sharded.conv2.out_channels, dense_units=d,
                  dropout_rate=sharded.dropout_rate, dtype=sharded.dtype,
                  frame_len=sharded.dense1.in_features // sharded.conv2.out_channels + 4,
                  generator=torch.Generator().manual_seed(0))
    state = gather_tensors(dict(sharded.named_parameters()), sharded.group)
    full.load_state_dict(state)
    return full.to(next(sharded.parameters()).device).eval()
