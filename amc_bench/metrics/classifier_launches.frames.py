"""Launches of the program's hand-written classifier kernels, per batch: its
counter ``amc.classifier.launches``, which each kernel's launch site adds
to, over the traced window's ``amc.classifier.predict`` calls. None for a
program without that counter."""


def read(ctx):
    try:
        from modulationdetectioncnn_torch.utils.profiler import counters, spans
    except ImportError:
        return None
    calls = sum(s.name == "amc.classifier.predict" and s.parent is None for s in spans())
    launches = counters().get("amc.classifier.launches")
    return launches / calls if calls and launches is not None else None
