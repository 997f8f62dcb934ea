"""Training loop: AdamW under a warmup-cosine schedule, softmax cross-entropy,
the whole training split resident on the device.

Counterpart of ``modulationdetectioncnn_tpu/train/loop.py``. The JAX
package leaves training to XLA and has no Pallas kernel on this path; the
port trains with PyTorch's own ops (autograd, cuDNN/cuBLAS), the model in
``cfg.model.dtype`` with float32 parameters.

On a mesh (``cfg.mesh`` of more than one rank, or ``mesh=``; one process
per rank, ``parallel/mesh.py``) the step is data-parallel over ``data`` and
channel-sharded over ``model`` (``ShardedVTCNN2``): every rank draws the
same global batch indices and the same full-width dropout masks from the
shared seeded generators and keeps its slice, so the run does not depend on
the mesh but for the order of float sums; gradients are averaged over
``data``. The eval and the checkpoint see the whole model, gathered: rank 0
writes the usual format, and a resume slices it again.

What carries over unchanged, so a run follows the JAX one step for step:

- the optimizer: ``optax.adamw(optax.warmup_cosine_decay_schedule(0, lr,
  warmup_steps, num_steps), weight_decay=...)`` written out (``AdamW``,
  ``warmup_cosine_decay_schedule``) in optax's order of operations; the
  first update uses the schedule's value at count 0, which is 0;
- ``batch_iterator`` (NumPy, the same batch order), the seeded subsample of
  the in-training eval, the steps at which records are written and their
  keys, the checkpoint steps, and resume at the step after the newest
  checkpoint.

What differs: the random numbers. Batch indices (``make_device_train_step``)
and dropout masks come from two ``torch.Generator``s on the device, seeded
from ``(train.seed, start step)`` (``step_generators``), as the JAX loop
folds the start step into its key; they are not JAX's numbers, so a run is
reproducible but not bit-equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Callable, Iterator

import numpy as np
import torch
from torch.nn import functional as F

from modulationdetectioncnn_torch.config import AmcConfig
from modulationdetectioncnn_torch.device import resolve_device
from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2

log = logging.getLogger("amc.train")

f32 = np.float32


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(init, peak, warmup_steps,
    decay_steps)`` (end value 0, exponent 1): a linear warmup from ``init``
    to ``peak`` over ``warmup_steps``, then a cosine decay to 0 at
    ``decay_steps``, computed in float32 as optax computes it."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("the cosine decay needs num_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        c = min(f32(count - warmup_steps), f32(decay_steps - warmup_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps - warmup_steps)))
        return float(f32(peak_value) * cosine)

    return schedule


@dataclasses.dataclass
class AdamState:
    """``optax.ScaleByAdamState``: the update count and the two moments,
    keyed by the parameter's name in the model's state dict."""
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


class AdamW:
    """``optax.adamw(schedule, b1, b2, eps, weight_decay)`` over a dict of
    float32 parameters, updated in place (the JAX package's transform is
    pure; here the step owns the tensors, so nothing is copied). Per
    parameter, with t the count after the update and lr the schedule at
    the count before it:

        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
        u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
        p  = p + (-lr) u

    eps sits outside the square root (optax's ``eps_root`` is 0)."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0):
        self.schedule, self.b1, self.b2 = schedule, b1, b2
        self.eps, self.weight_decay = eps, weight_decay

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        return AdamState(count=0, mu={k: torch.zeros_like(p) for k, p in params.items()},
                         nu={k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
               state: AdamState) -> None:
        t = state.count + 1
        bc1 = float(f32(1) - np.power(f32(self.b1), f32(t)))
        bc2 = float(f32(1) - np.power(f32(self.b2), f32(t)))
        neg_lr = -self.schedule(state.count)
        for k, p in params.items():
            g = grads[k]
            mu = (1 - self.b1) * g + self.b1 * state.mu[k]
            nu = (1 - self.b2) * (g * g) + self.b2 * state.nu[k]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(u * neg_lr)
            state.mu[k], state.nu[k] = mu, nu
        state.count = t


def make_optimizer(cfg: AmcConfig) -> AdamW:
    """The JAX loop's optimizer (``loop.py:193-196``)."""
    tc = cfg.train
    return AdamW(warmup_cosine_decay_schedule(0.0, tc.learning_rate, tc.warmup_steps,
                                              tc.num_steps),
                 weight_decay=tc.weight_decay)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    return F.cross_entropy(logits.to(torch.float32), labels.long())


def _step(model: VTCNN2, opt: AdamW, opt_state: AdamState, x: torch.Tensor,
          y: torch.Tensor, generator: torch.Generator | None, shard=None):
    """One step. ``shard``: None, or (this rank's rows, the global batch
    size, the data group) on a mesh, where ``x``, ``y`` are those rows."""
    model.train()
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    if shard is None:
        logits = model(x, generator=generator)
    else:
        logits = model(x, generator=generator, rows=shard[0], total=shard[1])
    loss = cross_entropy(logits, y)
    loss.backward()
    grads = {k: p.grad for k, p in params.items()}
    if shard is not None:
        grads = _average_over(grads, shard[2])
    opt.update(params, grads, opt_state)
    acc = (logits.detach().argmax(-1) == y).to(torch.float32).mean()
    return loss.detach(), acc


def _average_over(tensors: dict[str, torch.Tensor], group) -> dict[str, torch.Tensor]:
    """The mean of each tensor over the ranks of ``group``, in one
    all-reduce of their concatenation (every rank's slice of the batch has
    the same size, so the mean of the slices' mean gradients is the
    global batch's)."""
    import torch.distributed as dist

    from modulationdetectioncnn_torch.parallel.mesh import all_reduce_sum

    n = dist.get_world_size(group)
    if n == 1:
        return tensors
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors.values()]), group) / n
    out, i = {}, 0
    for k, t in tensors.items():
        out[k] = flat[i:i + t.numel()].view_as(t)
        i += t.numel()
    return out


def _mesh_shard(mesh, batch_size: int):
    """(rows, batch_size, data group) of this rank on ``mesh``, or None."""
    if mesh is None:
        return None
    from modulationdetectioncnn_torch.parallel import mesh as pmesh

    return (pmesh.batch_sharding(mesh).rows(batch_size), batch_size,
            mesh.get_group("data"))


def make_train_step(model: VTCNN2, opt: AdamW, mesh=None):
    """The host-batch step: ``step(opt_state, (x, y), generator) -> (loss,
    acc)``, 0-d tensors on the model's device (not synchronised), the model
    and ``opt_state`` updated in place. ``x``, ``y`` may be NumPy; dropout
    masks come from ``generator``. On a ``mesh`` (``model`` a
    ``ShardedVTCNN2``) the batch is the global one and each rank takes its
    rows; loss and accuracy are this rank's."""
    dev = next(model.parameters()).device

    def train_step(opt_state: AdamState, batch, generator: torch.Generator | None = None):
        x, y = (torch.as_tensor(b) for b in batch)
        shard = _mesh_shard(mesh, x.shape[0])
        if shard is not None:
            x, y = x[shard[0]], y[shard[0]]
        return _step(model, opt, opt_state, x.to(dev, torch.float32), y.to(dev),
                     generator, shard)

    return train_step


def make_device_train_step(model: VTCNN2, opt: AdamW, batch_size: int, mesh=None):
    """The device-resident step: ``step(opt_state, data_x, data_y,
    idx_generator, dropout_generator) -> (loss, acc)``. The whole split
    lives on the device; each step draws ``batch_size`` indices uniformly
    with replacement from ``idx_generator`` and gathers its batch there, so
    no batch crosses from the host. On a ``mesh`` each rank gathers its rows
    of the global batch."""
    shard = _mesh_shard(mesh, batch_size)

    def train_step(opt_state: AdamState, data_x: torch.Tensor, data_y: torch.Tensor,
                   idx_generator: torch.Generator, dropout_generator: torch.Generator):
        idx = torch.randint(0, data_x.shape[0], (batch_size,), generator=idx_generator,
                            device=data_x.device)
        if shard is not None:
            idx = idx[shard[0]]
        return _step(model, opt, opt_state, data_x.index_select(0, idx),
                     data_y.index_select(0, idx), dropout_generator, shard)

    return train_step


def make_eval_step(model: VTCNN2):
    """``eval_step(x) -> labels``: the model in eval mode (no dropout)."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(x) -> torch.Tensor:
        model.eval()
        return model(torch.as_tensor(x).to(dev, torch.float32)).argmax(-1)

    return eval_step


def batch_iterator(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int
                   ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Infinite shuffled batch stream (drops the ragged tail each epoch)."""
    rng = np.random.default_rng(seed)
    n = len(x)
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i: i + batch_size]
            yield x[idx], y[idx]


def evaluate(eval_step, x: np.ndarray, y: np.ndarray, batch_size: int = 2048) -> float:
    """Accuracy over a full split; the tail batch is padded with zero frames
    so every call sees the same batch shape (``batch_size``, or the whole
    split when it is smaller)."""
    correct = 0
    n = len(x)
    batch_size = min(batch_size, n)
    for i in range(0, n, batch_size):
        xb, yb = x[i: i + batch_size], y[i: i + batch_size]
        k = len(xb)
        if k < batch_size:
            xb = np.concatenate([xb, np.zeros((batch_size - k,) + xb.shape[1:], xb.dtype)])
        pred = eval_step(xb)[:k].cpu().numpy()
        correct += int((pred == yb).sum())
    return correct / n


def eval_subsample(n: int, max_frames: int, seed: int) -> np.ndarray | None:
    """The indices of the capped in-training eval (the JAX loop's NumPy
    call, so the same frames), or None when the split is not larger than
    ``max_frames`` or the cap is 0."""
    if not max_frames or n <= max_frames:
        return None
    return np.random.default_rng(seed).choice(n, max_frames, replace=False)


class JsonlLogger:
    def __init__(self, path: str | None):
        self.f = open(path, "a") if path else None

    def write(self, **kv):
        if self.f:
            self.f.write(json.dumps(kv) + "\n")
            self.f.flush()

    def close(self):
        if self.f:
            self.f.close()


def step_generators(seed: int, step: int, device: torch.device
                    ) -> tuple[torch.Generator, torch.Generator]:
    """(batch-index generator, dropout generator) on ``device`` for a run
    that starts after ``step``, each seeded from (seed, step) and its role."""
    gens = []
    for role in range(2):
        s = int(np.random.SeedSequence([seed, step, role]).generate_state(1, np.uint64)[0])
        gens.append(torch.Generator(device=device).manual_seed(s))
    return gens[0], gens[1]


def train(cfg: AmcConfig, train_data: tuple[np.ndarray, np.ndarray],
          eval_data: tuple[np.ndarray, np.ndarray] | None = None,
          device_data: bool = True, mesh=None) -> tuple[VTCNN2, list[dict]]:
    """Run the training loop on ``cfg.device``; returns (the trained model
    in eval mode, the records). With ``train.checkpoint_dir`` it resumes
    from the newest checkpoint there and saves every
    ``train.checkpoint_every`` steps and at the last.

    ``device_data=True`` keeps the whole training split on the device and
    draws batches there (uniform with replacement); False feeds shuffled
    host batches (``batch_iterator``), for a split larger than the device.

    ``mesh``: a ``parallel.mesh.make_mesh`` mesh that every rank passes
    with the same arguments; without one, ``cfg.mesh`` of more than one rank
    makes it. On a mesh every rank returns the whole gathered model and the
    same records; rank 0 writes the checkpoints and ``train.log_jsonl``,
    and every rank reads the checkpoint directory to resume."""
    from modulationdetectioncnn_torch.utils import checkpoint as ckpt

    tc = cfg.train
    mc = cfg.mesh
    if mesh is None and mc.data * mc.model * mc.time > 1:
        from modulationdetectioncnn_torch.parallel import mesh as pmesh

        mesh = pmesh.make_mesh(mc, cfg.device)
    dev = resolve_device(cfg.device)
    model = VTCNN2.from_config(cfg.model, cfg.data.frame_len,
                               generator=torch.Generator().manual_seed(tc.seed)).to(dev)
    opt = make_optimizer(cfg)
    opt_state = opt.init(dict(model.named_parameters()))
    start_step = 0
    if tc.checkpoint_dir:
        restored = ckpt.restore_train_state(tc.checkpoint_dir, device=dev)
        if restored is not None:
            state, r_opt, start_step = restored
            model.load_state_dict(state)
            if r_opt is not None:
                opt_state = r_opt
            log.info("resumed from checkpoint step %d", start_step)
    leader = True
    if mesh is not None:
        import torch.distributed as dist

        from modulationdetectioncnn_torch.parallel import mesh as pmesh

        model = pmesh.shard_params(model, mesh)
        opt_state = AdamState(opt_state.count, pmesh.shard_tensors(opt_state.mu, mesh),
                              pmesh.shard_tensors(opt_state.nu, mesh))
        data_group = mesh.get_group("data")
        leader = dist.get_rank() == 0
    idx_gen, drop_gen = step_generators(tc.seed, start_step, dev)

    if device_data:
        train_step = make_device_train_step(model, opt, tc.batch_size, mesh)
        data_x = torch.as_tensor(np.asarray(train_data[0], np.float32)).to(dev)
        data_y = torch.as_tensor(np.asarray(train_data[1], np.int64)).to(dev)
    else:
        train_step = make_train_step(model, opt, mesh)
        batches = batch_iterator(*train_data, tc.batch_size, tc.seed)
    if eval_data is not None:
        sub = eval_subsample(len(eval_data[0]), tc.eval_max_frames, tc.seed)
        if sub is not None:
            eval_data = (eval_data[0][sub], eval_data[1][sub])
    jlog = JsonlLogger(tc.log_jsonl if leader else None)

    def whole_state():
        """(the whole model, the whole optimizer state) of this step."""
        if mesh is None:
            return model, opt_state
        group = mesh.get_group("model")
        return pmesh.gather_model(model), AdamState(
            opt_state.count, pmesh.gather_tensors(opt_state.mu, group),
            pmesh.gather_tensors(opt_state.nu, group))

    history = []
    t_start = time.time()
    samples_done = 0
    t_last, samples_last = t_start, 0
    for step in range(start_step + 1, tc.num_steps + 1):
        if device_data:
            loss, acc = train_step(opt_state, data_x, data_y, idx_gen, drop_gen)
        else:
            loss, acc = train_step(opt_state, next(batches), drop_gen)
        samples_done += tc.batch_size
        if step % tc.eval_every == 0 or step == tc.num_steps:
            if mesh is not None:                        # the global batch's means
                loss, acc = _average_over({"l": loss, "a": acc}, data_group).values()
            loss_v, acc_v = float(loss), float(acc)     # synchronises the device
            # samples_per_sec is the rate over the current log window;
            # samples_per_sec_avg the cumulative one.
            now = time.time()
            rec = {"step": step, "loss": round(loss_v, 5), "train_acc": round(acc_v, 5),
                   "samples_per_sec": round((samples_done - samples_last) / (now - t_last)),
                   "samples_per_sec_avg": round(samples_done / (now - t_start))}
            if eval_data is not None:
                rec["eval_acc"] = round(evaluate(make_eval_step(whole_state()[0]),
                                                 *eval_data), 5)
            t_last, samples_last = time.time(), samples_done  # eval time stays out
            log.info("%s", rec)
            jlog.write(**rec)
            history.append(rec)
        if tc.checkpoint_dir and (step % tc.checkpoint_every == 0 or step == tc.num_steps):
            whole, whole_opt = whole_state()
            if leader:
                ckpt.save(tc.checkpoint_dir, step, whole.state_dict(), whole_opt)
    jlog.close()
    return whole_state()[0].eval(), history
