"""Host self time, per capture, of the program's channelizer span
(``amc.frontend.channelize``: the filter bank and its DFT, less the
blocking constant copies inside it, which ``frontend_wait_ms.stream``
reads), over the traced window's ``amc.stream`` calls. None for a program
without spans."""


def read(ctx):
    try:
        from modulationdetectioncnn_torch.utils.profiler import self_ms, spans
    except ImportError:
        return None
    calls = sum(s.name == "amc.stream" and s.parent is None for s in spans())
    return self_ms("amc.frontend.channelize") / calls if calls else None
