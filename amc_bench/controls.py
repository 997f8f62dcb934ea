"""The controls and the planted faults that must come out as not correct.

Never run by a benchmark run. ``calibrate.py`` runs them on the card to
read the upper end of each limit, and ``tests/`` runs them on the CPU at a
small size. Each takes a built ``System`` and changes it in place:

Controls (the nearest precision below the configuration's, in the
program's place):

- ``int4`` (int8 configurations): the integer chain with every weight
  rounded to 4 bits, as the classifier;
- ``int8_path`` (bfloat16 configurations): the program's own int8 path
  (the committed artifact on the v7 kernels), as the classifier;
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

from amc_bench.reference import frontend as ref_frontend
from amc_bench.reference.vtcnn2 import Int8Model, tf32

CONTROLS = ("int4", "int8_path", "tf32")
FAULTS = ("half", "alter", "no_cfo")


def applies(cell, mode: str) -> bool:
    stream = cell.traffic["kind"] == "stream"
    int8 = cell.config["precision"] == "int8"
    return {"int4": int8, "int8_path": not int8, "tf32": stream, "no_cfo": stream}.get(mode, True)


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
    if mode == "int4":
        model = Int8Model(cell.path(cell.config["weights"]), system.cfg.device, weight_bits=4)
        system.predict = lambda x: model.labels(x).to(torch.int32)
    elif mode == "int8_path":
        from modulationdetectioncnn_torch.ops.infer import make_int8_predict
        from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, load_int8

        system.predict = make_int8_predict(load_int8(DEFAULT_ARTIFACT, system.cfg.device), "v7")
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
        raise ValueError(f"unknown control or fault {mode!r}")
