"""Host self time, per capture, of the program's carrier span
(``amc.frontend.cfo``: the CFO estimate by a padded DFT and its correction,
less the blocking constant copies inside it), over the traced window's
``amc.stream`` calls. None for a program without spans."""


def read(ctx):
    try:
        from modulationdetectioncnn_torch.utils.profiler import self_ms, spans
    except ImportError:
        return None
    calls = sum(s.name == "amc.stream" and s.parent is None for s in spans())
    return self_ms("amc.frontend.cfo") / calls if calls else None
