"""The least time of one ``residual_chain_bf16`` call (the architecture's
``KERNELS``: the larger of its operations at the bf16 peak and its bytes at
the HBM bandwidth, at the call's batch) over the measured device time per
call of ``residual_chain_bf16_kernel``, the fused chain, in percent
(``shares.kernel_roofline``)."""
from amc_bench.shares import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "residual_chain_bf16")
