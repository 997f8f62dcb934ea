"""Host time, per capture, spent in the front end's copies of its host
constants to the device (the program's ``amc.frontend.sync`` spans: each a
blocking copy from pageable memory, in which the host waits for the card's
queue to drain), over the traced window's ``amc.stream`` calls. None for a
program without spans."""


def read(ctx):
    try:
        from modulationdetectioncnn_torch.utils.profiler import self_ms, spans
    except ImportError:
        return None
    calls = sum(s.name == "amc.stream" and s.parent is None for s in spans())
    return self_ms("amc.frontend.sync") / calls if calls else None
