"""The 95th percentile, over every capture whose labels reached the host
inside the window, of the time from handing the capture to the stream call
to its labels on the host (numpy's linear interpolation)."""
import numpy as np


def read(ctx):
    if ctx.cell.traffic["kind"] != "stream" or not ctx.latencies_s:
        return None
    return float(np.percentile(ctx.latencies_s, 95)) * 1e3
