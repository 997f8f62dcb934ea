"""Host self time, per batch, of the program's dense-head span
(``amc.classifier.head``: the head's PyTorch launches after the fused
chain), over the traced window's ``amc.classifier.predict`` calls. None
for a program without that span."""


def read(ctx):
    try:
        from modulationdetectioncnn_torch.utils.profiler import self_ms, spans
    except ImportError:
        return None
    recs = spans()
    calls = sum(s.name == "amc.classifier.predict" and s.parent is None for s in recs)
    if not calls or not any(s.name == "amc.classifier.head" for s in recs):
        return None
    return self_ms("amc.classifier.head") / calls
