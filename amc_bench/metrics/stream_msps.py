"""Wideband samples, in millions a second, of every capture whose labels
reached the host inside the window, over the window's seconds."""


def read(ctx):
    if ctx.cell.traffic["kind"] != "stream":
        return None
    return ctx.samples_in_window / ctx.seconds / 1e6
