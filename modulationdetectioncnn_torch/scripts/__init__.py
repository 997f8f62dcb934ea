"""The port's scripts: diagnostics, the stream variants and the flagship
pipeline, each run as ``python -m modulationdetectioncnn_torch.scripts.<name>``."""
from __future__ import annotations

import os


def refuse_artifacts(path: str) -> None:
    """Exit when ``path`` lies under a directory named ``artifacts``: the
    repo's ``artifacts/`` holds the JAX package's records, which no run of
    the port writes."""
    if "artifacts" in os.path.normpath(os.path.abspath(path)).split(os.sep):
        raise SystemExit(f"{path}: artifacts/ holds the JAX package's records; "
                         "write elsewhere")
