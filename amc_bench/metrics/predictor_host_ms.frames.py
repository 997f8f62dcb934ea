"""Host time, per batch, inside the program's predictor (the root spans
``amc.classifier.predict``: the wrapper's checks and the launches, from
the call to its return, before the labels are waited for), over the
traced window. None for a program without spans."""


def read(ctx):
    try:
        from modulationdetectioncnn_torch.utils.profiler import spans
    except ImportError:
        return None
    calls = [s for s in spans() if s.name == "amc.classifier.predict" and s.parent is None]
    if not calls:
        return None
    return sum(s.end_ns - s.start_ns for s in calls) / len(calls) / 1e6
