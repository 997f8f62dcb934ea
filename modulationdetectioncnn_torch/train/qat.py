"""Quantization-aware fine-tuning: the deployment's int8 rounding in the
forward pass, gradients straight through.

Counterpart of ``modulationdetectioncnn_tpu/train/qat.py``, over the
``VTCNN2`` state dict (torch layouts: OIHW conv and (out, in) dense
weights) instead of the Flax tree:

- ``fake_quant_weight``: per-output-channel symmetric int8
  quantize-dequantize (axis 0 in the torch layouts), ``s = max|w| / 127``;
- ``fake_quant_act``: per-tensor, multiply by the float32 reciprocal of the
  frozen scale, as ``golden/quant.py``'s input quantizer does;
- both with the straight-through estimator ``x + (qdq - x).detach()``:
  forward the quantized value, backward the identity;
- ``qat_apply``: the VT-CNN2 forward in float32 with every weight and
  activation fake-quantized, under the scales of
  ``train/quant.py::calibrate_activations``;
- ``finetune_qat``: Adam at a constant rate, batches drawn on the device.

The flow is the JAX package's: train float -> calibrate -> ``finetune_qat``
-> PTQ export as usual (``cli.py qat``, then ``quantize``). As in the JAX
package this path runs no kernel of its own: autograd and cuDNN/cuBLAS.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from modulationdetectioncnn_torch.models.vtcnn2 import dropout


def _ste(x: torch.Tensor, qdq: torch.Tensor) -> torch.Tensor:
    """Straight-through: forward ``qdq``, backward the identity."""
    return x + (qdq - x).detach()


def fake_quant_weight(w: torch.Tensor, channel_axis: int = 0) -> torch.Tensor:
    """Per-output-channel symmetric int8 quantize-dequantize with STE."""
    reduce = tuple(i for i in range(w.dim()) if i != channel_axis % w.dim())
    s = torch.amax(torch.abs(w), dim=reduce, keepdim=True) / 127.0
    s = torch.clamp(s, min=1e-12)
    qdq = torch.clamp(torch.round(w / s), -127, 127) * s
    return _ste(w, qdq)


def fake_quant_act(x: torch.Tensor, scale: float, relu_domain: bool = True) -> torch.Tensor:
    """Per-tensor int8 quantize-dequantize with STE, the scale frozen; the
    multiplier is ``float32(1 / float64(float32(scale)))``."""
    inv = float(np.float32(1.0 / np.float64(np.float32(scale))))
    lo = 0.0 if relu_domain else -127.0
    qdq = torch.clamp(torch.round(x * inv), lo, 127.0) * float(np.float32(scale))
    return _ste(x, qdq)


def qat_apply(params: dict[str, torch.Tensor], x: torch.Tensor, scales: dict, *,
              train: bool = False, generator: torch.Generator | None = None,
              dropout_rate: float = 0.5) -> torch.Tensor:
    """The fake-quant VT-CNN2 forward, float32 throughout: (B, 2, T) ->
    (B, C) logits from the ``VTCNN2`` state dict ``params`` and the scales
    ``{'s_x', 'a1', 'a2', 'a3'}``. In train mode dropout (masks from
    ``generator``) follows each hidden layer, as in the JAX package."""
    rate = dropout_rate if train else 0.0
    x = fake_quant_act(x.to(torch.float32), scales["s_x"], relu_domain=False)
    h = F.conv2d(x[:, None], fake_quant_weight(params["conv1.weight"]),
                 params["conv1.bias"])                             # (B, C1, 2, T-2)
    h = dropout(fake_quant_act(F.relu(h), scales["a1"]), rate, generator)
    h = F.conv2d(h, fake_quant_weight(params["conv2.weight"]),
                 params["conv2.bias"])                             # (B, C2, 1, T-4)
    h = dropout(fake_quant_act(F.relu(h), scales["a2"]), rate, generator)
    h = h.permute(0, 2, 3, 1).flatten(1)                           # t*C2 + c order
    h = F.linear(h, fake_quant_weight(params["dense1.weight"]), params["dense1.bias"])
    h = dropout(fake_quant_act(F.relu(h), scales["a3"]), rate, generator)
    return F.linear(h, fake_quant_weight(params["dense2.weight"]), params["dense2.bias"])


def finetune_qat(params: dict[str, torch.Tensor], scales: dict, data_x: np.ndarray,
                 data_y: np.ndarray, *, num_steps: int = 300, batch_size: int = 1024,
                 learning_rate: float = 1e-4, dropout_rate: float = 0.5, seed: int = 0,
                 device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Fine-tune float parameters under the deployment's fake-quant:
    ``optax.adam(learning_rate)`` (``train.loop.AdamW`` at a constant rate,
    no weight decay) for ``num_steps`` steps, each on ``batch_size`` frames
    drawn uniformly with replacement from the split, which stays on the
    device (``device``, default the parameters'). Returns a new state dict
    of float32 tensors on that device; ``params`` is not changed."""
    from modulationdetectioncnn_torch.train.loop import AdamW, step_generators

    dev = torch.device(device) if device is not None else next(iter(params.values())).device
    p = {k: v.detach().to(dev, torch.float32).clone().requires_grad_(True)
         for k, v in params.items()}
    opt = AdamW(lambda count: learning_rate)
    opt_state = opt.init(p)
    dx = torch.as_tensor(np.asarray(data_x, np.float32)).to(dev)
    dy = torch.as_tensor(np.asarray(data_y, np.int64)).to(dev)
    idx_gen, drop_gen = step_generators(seed, 0, dev)
    for _ in range(num_steps):
        idx = torch.randint(0, dx.shape[0], (batch_size,), generator=idx_gen, device=dev)
        for t in p.values():
            t.grad = None
        logits = qat_apply(p, dx.index_select(0, idx), scales, train=True,
                           generator=drop_gen, dropout_rate=dropout_rate)
        F.cross_entropy(logits, dy.index_select(0, idx)).backward()
        opt.update(p, {k: t.grad for k, t in p.items()}, opt_state)
    return {k: t.detach() for k, t in p.items()}
