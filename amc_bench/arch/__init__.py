"""One module per architecture, found by the ``architecture`` a configuration
file names (``spec.architecture``): ``arch/<architecture>.py``, beside its
plain reference ``reference/<architecture>.py``. Each holds:

- ``PUBLISHED``: the published widths, by configuration key;
- ``reference(config, path, device)``: the plain reference on the weights
  at ``path``, with ``labels(x)`` for an int8 configuration (compared
  exactly) or ``logits(x)`` for a float one (the widest gap of a served
  label below the best logit), (B, 2, T) float32 frames in;
- ``ops_per_frame(config)``: the operations of one frame's forward pass;
- ``KERNELS``: kernel name -> ``fn(config, batch) -> (operations, bytes)``
  of one call on ``batch`` frames, for the kernel rooflines;
- ``CONTROLS``: precision -> {control name -> ``fn(system, cell)``}, the
  lower-precision controls of a configuration at that precision, each
  returning a predictor to put in the program's place.

The reference imports nothing of the program; a control may, inside its
function.
"""
