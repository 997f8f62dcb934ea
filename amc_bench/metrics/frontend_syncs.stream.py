"""Blocking host waits, per capture, in the front end: the program's
counter ``amc.frontend.syncs`` (one a constant copied from pageable host
memory to a card; 0 on the CPU) over the traced window's ``amc.stream``
calls. None for a program without spans."""


def read(ctx):
    try:
        from modulationdetectioncnn_torch.utils.profiler import counters, spans
    except ImportError:
        return None
    calls = sum(s.name == "amc.stream" and s.parent is None for s in spans())
    return counters().get("amc.frontend.syncs", 0) / calls if calls else None
