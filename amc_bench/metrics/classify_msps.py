"""I/Q samples (frames x frame length), in millions a second, of every
batch whose labels reached the host inside the window, over the window's
seconds."""


def read(ctx):
    if ctx.cell.traffic["kind"] != "frames":
        return None
    return ctx.samples_in_window / ctx.seconds / 1e6
