"""Host self time, per capture, of the program's symbol-timing span
(``amc.frontend.timing``: the estimate, the per-frame filters and the
timing FIR's launch, less the blocking constant copy inside it), over the
traced window's ``amc.stream`` calls. None for a program without spans or
a window without timing correction."""


def read(ctx):
    try:
        from modulationdetectioncnn_torch.utils.profiler import self_ms, spans
    except ImportError:
        return None
    recs = spans()
    calls = sum(s.name == "amc.stream" and s.parent is None for s in recs)
    if not calls or not any(s.name == "amc.frontend.timing" for s in recs):
        return None
    return self_ms("amc.frontend.timing") / calls
