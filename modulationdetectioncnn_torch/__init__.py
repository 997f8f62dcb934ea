"""PyTorch + CUDA port of the automatic-modulation-classification framework.

A second package beside ``modulationdetectioncnn_tpu`` (JAX, Flax, Pallas),
which stays the reference it is held against. This package imports
``torch``, ``numpy`` and ``scipy`` only -- never ``jax`` and nothing of the
JAX package -- so it runs on a machine with an NVIDIA H100 and no JAX.

Ported so far (ROADMAP.md lists the rest): the ``stream``, ``bench``,
``eval`` and ``quantize`` commands (``python -m modulationdetectioncnn_torch
<cmd>``). The streaming front end ([rational resampler ->] overlap-save
blocks -> polyphase channelizer -> framer -> power, CFO [and timing]
normalization) feeds the int8
VT-CNN2 classifier, whose fused stages are hand-written CUDA kernels for
Hopper (``csrc/``) built with ``nvcc`` on first use (``ops/_build.py``);
``eval`` sweeps the synthetic RadioML-style dataset with the float model,
the NumPy golden forward or those kernels, and ``quantize`` turns a float
checkpoint into the int8 artifact.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version, which is what the CPU tests check against the JAX package.
"""

__version__ = "0.1.0"
