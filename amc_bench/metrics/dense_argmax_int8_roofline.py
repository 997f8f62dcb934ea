"""The least time of one ``dense_argmax_int8`` call (``counts.py``: the larger of its
operations at the int8 peak and its bytes at the HBM bandwidth, at the
call's batch) over its measured device time per call, in percent
(``shares.kernel_roofline``)."""
from amc_bench.shares import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "dense_argmax_int8")
