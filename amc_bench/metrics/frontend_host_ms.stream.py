"""Host time, per capture, from the stream call to the start of the
predictor it is handed (the benchmark's own span around the front end),
over the traced window."""


def read(ctx):
    if ctx.cell.traffic["kind"] != "stream" or ctx.items == 0:
        return None
    return ctx.frontend_host_s / ctx.items * 1e3
