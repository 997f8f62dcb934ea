"""The least time of one ``dense_argmax_bf16`` call (the architecture's
``KERNELS``: the larger of its operations at the bf16 peak and its bytes at
the HBM bandwidth, at the call's batch) over the measured device time per
call of ``dense_argmax_bf16_kernel<true>``, the dense stage's argmax entry,
in percent (``shares.kernel_roofline``)."""
from amc_bench.shares import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "dense_argmax_bf16", "dense_argmax_bf16_kernel<true>")
