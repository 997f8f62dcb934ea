"""What decides ``correct``: the window's outputs against the plain reference.

Run once the window has closed and the program's state is freed. Every
answer the window produced is judged, the one that came after the close
too. The numbers, each beside its limit in ``workloads/<cell>.json``:

- ``label_mismatch`` (int8 configurations): labels that differ from the
  plain reference's (the integer chain of the configuration's
  architecture, ``arch/<architecture>.py::reference``) on the frames the
  classifier was handed. Exact: limit 0.
- ``logit_gap_max`` (float configurations): the widest gap by which the
  logit of a served label lies below the best logit of the architecture's
  float32 reference on those frames.
- ``frames_err_p99`` (stream cells): the 99th percentile over frames of the
  largest absolute difference between the program's front-end frames and
  the float64 reference's (``reference/frontend.py``) from the raw capture.

A frames cell hands the classifier the generated pool itself. A stream
cell's classifier input is the program's own front-end output (the
reference follows the program from there), so the front end is judged on
its own by ``frames_err_p99``: its carrier search and timing phase are
argmax and rounding steps, so an input that differs by rounding can move a
frame to another bin, and no tolerance on labels from an independent front
end would hold.
"""
from __future__ import annotations

import torch

from amc_bench import spec
from amc_bench.reference import frontend as ref_frontend


def stream_geometry(sc, t_len: int, n_frames: int) -> tuple[int, int, int, int]:
    """(blocks, frames a block and subband, lead frames, frames a subband)
    of the stream call on a ``t_len``-sample capture whose classifier was
    handed ``n_frames`` frames."""
    m = sc.num_subbands
    nb = -(-t_len // sc.block_len)
    fb = n_frames // (nb * m)
    lead = (sc.frame_len - sc.frame_hop) // sc.frame_hop
    total = (t_len // m - sc.frame_len) // sc.frame_hop + 1
    return nb, fb, lead, total


def subband_order(x: torch.Tensor, sc, t_len: int) -> torch.Tensor:
    """The classifier's input or output in block order, (nb*M*fb, ...),
    -> subband order (M, F, ...) as the stream's labels come out."""
    nb, fb, lead, total = stream_geometry(sc, t_len, x.shape[0])
    m = sc.num_subbands
    x = x.reshape((nb, m, fb) + x.shape[1:]).transpose(0, 1)
    return x.reshape((m, nb * fb) + x.shape[3:])[:, lead:lead + total]


def front_end_settings(sc) -> dict:
    return {k: getattr(sc, k) for k in (
        "num_subbands", "taps_per_branch", "frame_len", "frame_hop",
        "cfo_pad_factor", "normalize_timing", "sps", "timing_phases")}


def reference_model(cell, device):
    """The plain reference of the cell's configuration, from its
    architecture's module."""
    c = cell.config
    return spec.architecture(c).reference(c, cell.path(c["weights"]), device)


def frames_error(program_frames: torch.Tensor, ref_frames: torch.Tensor) -> torch.Tensor:
    """Per frame, the largest absolute difference: (..., 2, T) -> (...)."""
    return (program_frames.double() - ref_frames.double()).abs().amax(dim=(-1, -2)).reshape(-1)


def judge_labels(model, precision: str, inputs: dict, pool_index: list, labels: list) -> dict:
    """``inputs[j]``: the frames the classifier was handed for pool item j,
    shaped as item j's labels plus (2, T). An int8 ``precision``:
    mismatches against the reference's labels; any other: the widest gap
    below the reference's best logit."""
    if precision == "int8":
        ref = {j: model.labels(x.reshape((-1,) + x.shape[-2:])).reshape(x.shape[:-2]).cpu().numpy()
               for j, x in inputs.items()}
        bad = 0
        for j, lab in zip(pool_index, labels):
            bad += lab.size if lab.shape != ref[j].shape else int((lab != ref[j]).sum())
        return {"label_mismatch": bad}
    gap = 0.0
    for j, x in inputs.items():
        logits = model.logits(x.reshape((-1,) + x.shape[-2:]))
        best = logits.max(dim=-1).values
        for jj, lab in zip(pool_index, labels):
            if jj != j:
                continue
            if lab.size != best.numel():
                return {"logit_gap_max": float("inf")}
            idx = torch.as_tensor(lab.reshape(-1), dtype=torch.long, device=logits.device)
            if int(idx.min()) < 0 or int(idx.max()) >= logits.shape[-1]:
                return {"logit_gap_max": float("inf")}
            served = logits.gather(-1, idx[:, None])[:, 0]
            gap = max(gap, float((best - served).max()))
    return {"logit_gap_max": gap}


def numbers(cell, sc, items: list, tally, device) -> dict:
    """The cell's compared numbers for one window's tally."""
    model = reference_model(cell, device)
    precision = cell.config["precision"]
    if cell.traffic["kind"] == "frames":
        inputs = {j: items[j] for j in set(tally.pool_index)}
        return judge_labels(model, precision, inputs, tally.pool_index, tally.labels)
    out, errs, inputs = {}, [], {}
    settings = front_end_settings(sc)
    for j, x in tally.kept.items():
        t_len = items[j].shape[-1]
        prog = subband_order(x, sc, t_len)
        errs.append(frames_error(prog, ref_frontend.stream_frames(items[j], settings)))
        inputs[j] = prog
    out["frames_err_p99"] = (float(torch.quantile(torch.cat(errs).float(), 0.99))
                             if errs else float("inf"))
    out.update(judge_labels(model, precision, inputs, tally.pool_index, tally.labels))
    return out


def verdict(values: dict, limits: dict, tally) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, every call answered, none failed."""
    checks = {k: {"value": values.get(k, float("inf")), "limit": v} for k, v in limits.items()}
    ok = (tally.failed == 0 and len(tally.labels) > 0
          and all(c["value"] <= c["limit"] for c in checks.values()))
    return ok, checks
