"""PyTorch + CUDA port of the automatic-modulation-classification framework.

A second package beside ``modulationdetectioncnn_tpu`` (JAX, Flax, Pallas),
which stays the reference it is held against. This package imports
``torch``, ``numpy`` and ``scipy`` only -- never ``jax`` and nothing of the
JAX package -- so it runs on a machine with an NVIDIA H100 and no JAX.

It does what the JAX package does, through the same commands
(``python -m modulationdetectioncnn_torch <cmd>``): ``stream`` (the
streaming front end, [rational resampler ->] overlap-save blocks ->
polyphase channelizer -> framer -> power, CFO [and timing] normalization,
feeding the int8 VT-CNN2 classifier), ``bench`` (every JAX bench backend),
``eval``, ``quantize`` (PTQ), ``train`` and ``qat`` (on one card or on a
mesh of ranks, ``parallel/``) and ``scaling`` (the multi-card efficiency
report from the measured one-card rate). The fused stages of the int8 and
bf16 classifiers, the stand-alone conv kernels and the timing FIR are
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` on
first use (``ops/_build.py``); ``scripts/`` holds the per-stage breakdown
and the probes of those kernels.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version, which is what the CPU tests check against the JAX package.
Importing the package builds nothing and does not touch the card.
"""

__version__ = "0.1.0"

from modulationdetectioncnn_torch.config import AmcConfig
from modulationdetectioncnn_torch.data import (
    MODULATIONS, generate_frames, load_radioml_pickle, make_dataset)
from modulationdetectioncnn_torch.models import VTCNN2

__all__ = ["AmcConfig", "MODULATIONS", "VTCNN2", "generate_frames",
           "load_radioml_pickle", "make_dataset", "__version__"]
