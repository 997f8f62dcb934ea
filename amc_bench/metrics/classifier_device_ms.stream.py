"""Device time, per capture, of the kernels and copies the host launched
inside the predictor's span, from the profiler's trace."""
from amc_bench.system import SPAN_CLASSIFIER


def read(ctx):
    if ctx.summary is None or ctx.items == 0:
        return None
    s, n = ctx.summary.device_s(span=SPAN_CLASSIFIER)
    return s / ctx.items * 1e3 if n else None
