"""Set-up time: from the harness's first statement to the first timed call
(loading the weights, building or loading the kernel library, making the
traffic on the card, warming the cell's one input shape). Host clock."""


def read(ctx):
    return ctx.setup_s
