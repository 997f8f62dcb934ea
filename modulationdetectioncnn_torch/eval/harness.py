"""SNR-sweep evaluation harness, the port's own copy of
``modulationdetectioncnn_tpu/eval/harness.py``.

Per-SNR accuracy over the dataset's SNRs, the headline accuracies at
0/10/18 dB and per-SNR confusion matrices, as the same ``results.json``
dict the JAX package writes. The harness does not care which backend
predicts: the torch float model, the int8 kernels or the NumPy golden.
"""
from __future__ import annotations

import json
from typing import Callable

import numpy as np


def confusion_matrix(pred: np.ndarray, true: np.ndarray, n_classes: int) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (true, pred), 1)
    return cm


def predict_all(predict_fn: Callable[[np.ndarray], np.ndarray], x: np.ndarray,
                batch_size: int = 2048) -> np.ndarray:
    """Batched predictions; the tail batch is zero-padded to ``batch_size``
    (the JAX package's static-shape batches) and the padding dropped."""
    preds = []
    for i in range(0, len(x), batch_size):
        xb = x[i:i + batch_size]
        k = len(xb)
        if k < batch_size:
            xb = np.concatenate(
                [xb, np.zeros((batch_size - k,) + xb.shape[1:], xb.dtype)])
        preds.append(np.asarray(predict_fn(xb))[:k])
    return np.concatenate(preds)


def snr_sweep(predict_fn: Callable[[np.ndarray], np.ndarray], x: np.ndarray,
              y: np.ndarray, snr: np.ndarray, classes: tuple[str, ...],
              batch_size: int = 2048) -> dict:
    """Per-SNR accuracy and confusion matrices of ``predict_fn``, a
    (B, 2, T) float32 -> (B,) int predictor."""
    return score(predict_all(predict_fn, x, batch_size), y, snr, classes)


def score(pred: np.ndarray, y: np.ndarray, snr: np.ndarray,
          classes: tuple[str, ...]) -> dict:
    """``snr_sweep``'s dict of the predicted labels ``pred``."""
    snrs = sorted(int(s) for s in np.unique(snr))
    curve, conf = {}, {}
    for s in snrs:
        m = snr == s
        curve[s] = float((pred[m] == y[m]).mean())
        conf[s] = confusion_matrix(pred[m], y[m], len(classes)).tolist()
    return {
        "classes": list(classes),
        "overall_accuracy": float((pred == y).mean()),
        "snr_accuracy": {str(s): curve[s] for s in snrs},
        "headline": {
            "acc_at_0dB": curve.get(0),
            "acc_at_10dB": curve.get(10),
            "acc_at_18dB": curve.get(18),
        },
        "confusion": {str(s): conf[s] for s in snrs},
    }


def compare(result: dict, reference: dict) -> dict:
    """Per-SNR frames (the confusion matrices' sums) and accuracies of
    ``result`` against ``reference``, exactly."""
    def frames(r):
        return {s: int(np.sum(c)) for s, c in r["confusion"].items()}

    got_a, want_a = result["snr_accuracy"], reference["snr_accuracy"]
    return {
        "frames_equal": frames(result) == frames(reference),
        "accuracy_equal": got_a == want_a,
        "snrs_differing": sorted((s for s in want_a if got_a.get(s) != want_a[s]), key=int),
        "accuracy_delta": {s: got_a[s] - want_a[s] for s in want_a if s in got_a},
        "headline": result["headline"], "reference_headline": reference["headline"],
    }


def save_results(result: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(result, f, indent=1)


def format_curve(result: dict) -> str:
    lines = ["SNR(dB)  accuracy"]
    for s, a in sorted(result["snr_accuracy"].items(), key=lambda kv: int(kv[0])):
        lines.append(f"{int(s):7d}  {a:.4f}")
    lines.append(f"overall  {result['overall_accuracy']:.4f}")
    return "\n".join(lines)


def main(argv: list[str]) -> int:
    """``python -m modulationdetectioncnn_torch.eval.harness RESULT REFERENCE``:
    prints ``compare`` of two results files; exit 0 when they are equal."""
    with open(argv[0]) as f, open(argv[1]) as g:
        report = compare(json.load(f), json.load(g))
    print(json.dumps(report, indent=1))
    return 0 if report["frames_equal"] and report["accuracy_equal"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
