"""Shares of the traced window that the mfu, idle and roofline readers read."""


def model_flops_share(ctx):
    """Model operations of every frame classified in the traced window
    (``counts.ops_per_frame``, at the configuration's widths) over the
    window's seconds times the configuration's data-sheet peak, in percent."""
    if ctx.summary is None or ctx.frames_classified == 0:
        return None
    ops = ctx.counts.ops_per_frame(ctx.cell.config) * ctx.frames_classified
    peak = ctx.counts.PEAK_OPS_PER_S[ctx.cell.config["precision"]]
    return 100.0 * ops / (ctx.summary.window_s * peak)


def idle_share(ctx):
    """The share of the traced window with nothing running on the card."""
    if ctx.summary is None or ctx.summary.window_s <= 0 or ctx.summary.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.summary.busy_s / ctx.summary.window_s)


def kernel_roofline(ctx, kernel: str, traced_as: str | None = None):
    """The least time of one call of the architecture's ``kernel``, at the
    configuration's precision, over its device time per call in the traced
    window, in percent; None when no call was traced. ``traced_as``: the
    part of the device op's name that marks the kernel (default
    ``<kernel>_kernel``)."""
    if ctx.summary is None:
        return None
    s, n = ctx.summary.device_s(name_has=traced_as or f"{kernel}_kernel")
    if n == 0 or s <= 0:
        return None
    cfg = ctx.cell.config
    ops, nbytes = ctx.counts.kernel(cfg, kernel, ctx.frames_classified // n)
    return 100.0 * ctx.counts.roofline_ms(ops, nbytes, cfg["precision"]) * 1e-3 / (s / n)
