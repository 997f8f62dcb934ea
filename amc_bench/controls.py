"""The controls and the planted faults that must come out as not correct.

Never run by a benchmark run. ``calibrate.py`` runs them on the card to
read the upper end of each limit, and ``tests/`` runs them on the CPU at a
small size. Each takes a built ``System`` and changes it in place:

Controls (the nearest precision below the configuration's, in the
program's place):

- the classifier's: those that the configuration's architecture lists for
  the configuration's precision (``arch/<architecture>.py::CONTROLS``;
  VT-CNN2's: ``int4``, the integer chain with every weight rounded to 4
  bits, for int8; ``int8_path``, the program's own int8 path, for
  bfloat16), as the classifier;
- ``tf32`` (stream cells): the reference front end in float32 with TF32 on
  (the front end's precision is float32 with TF32 off), as the front end.

Faults, planted in the program's timed path:

- ``half``: the classifier labels half of each batch and repeats those
  labels for the other half;
- ``alter``: one label of each batch is changed where it is produced;
- ``no_cfo``: the front end's carrier correction is skipped (stream cells).
"""
from __future__ import annotations

import torch

from amc_bench import spec
from amc_bench.reference import frontend as ref_frontend
from amc_bench.reference.common import tf32

FAULTS = ("half", "alter", "no_cfo")


def classifier_controls(cell) -> dict:
    """The lower-precision controls of the cell's configuration: its
    architecture's for its precision, name -> ``fn(system, cell)``."""
    cfg = cell.config
    return spec.architecture(cfg).CONTROLS.get(cfg["precision"], {})


def applies(cell, mode: str) -> bool:
    if mode in ("tf32", "no_cfo"):
        return cell.traffic["kind"] == "stream"
    return mode == "sound" or mode in FAULTS or mode in classifier_controls(cell)


def _reference_stream(x: torch.Tensor, predict_fn, sc, settings: dict) -> torch.Tensor:
    """The reference front end in float32 with TF32 on, handing the
    classifier its frames in the stream call's block order."""
    with tf32(True):
        fr = ref_frontend.stream_frames(x, settings, dtype=torch.float32)   # (M, F, 2, f)
    m, f_all = fr.shape[:2]
    nb = -(-x.shape[-1] // sc.block_len)
    fb = f_all // nb
    blocks = fr.reshape(m, nb, fb, 2, -1).transpose(0, 1).reshape(-1, 2, fr.shape[-1])
    labels = predict_fn(blocks.contiguous())
    return labels.reshape(nb, m, fb).transpose(0, 1).reshape(m, f_all)


def apply(system, cell, mode: str, restore: list) -> None:
    """Put ``mode`` in place in ``system`` (and the program); undo
    callables are appended to ``restore``."""
    from amc_bench import check

    if mode == "sound":
        return
    predict, entry = system.predict, system.stream_entry
    restore.append(lambda: (setattr(system, "predict", predict),
                            setattr(system, "stream_entry", entry)))
    lower = classifier_controls(cell)
    if mode in lower:
        system.predict = lower[mode](system, cell)
    elif mode == "tf32":
        settings = check.front_end_settings(system.cfg.stream)
        system.stream_entry = lambda x, fn, sc: _reference_stream(x, fn, sc, settings)
    elif mode == "half":
        def predict_half(x):
            h = predict(x[:x.shape[0] // 2])
            return torch.cat([h, h[:x.shape[0] - h.shape[0]]])
        system.predict = predict_half
    elif mode == "alter":
        def predict_altered(x):
            lab = predict(x).clone()
            lab[0] = (lab[0] + 1) % cell.config["num_classes"]
            return lab
        system.predict = predict_altered
    elif mode == "no_cfo":
        from modulationdetectioncnn_torch.dsp import normalize

        correct_cfo = normalize.correct_cfo
        normalize.correct_cfo = lambda x, cfo: x
        restore.append(lambda: setattr(normalize, "correct_cfo", correct_cfo))
    else:
        raise ValueError(f"no control or fault {mode!r} for {cell.name!r}")
