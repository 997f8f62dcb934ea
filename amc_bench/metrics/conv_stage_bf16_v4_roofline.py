"""The least time of one ``conv_stage_bf16_v4`` call (the architecture's
``KERNELS``: the larger of its operations at the bf16 peak and its bytes at
the HBM bandwidth, at the call's batch) over the measured device time per
call of ``conv_stage_bf16_kernel<0>``, the conv stage's v4 entry, in percent
(``shares.kernel_roofline``)."""
from amc_bench.shares import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "conv_stage_bf16_v4", "conv_stage_bf16_kernel<0>")
