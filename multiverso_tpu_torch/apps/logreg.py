"""libsvm parsing for the logistic-regression apps (copied from
``multiverso_tpu/apps/logreg.py``; the dense ``LogisticRegression`` app is
not ported yet)."""

from __future__ import annotations


def _parse_libsvm(path: str):
    """One parse pass: (labels list, rows list of [(idx, val), ...])."""
    labels, rows = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            rows.append([(int(t[0]), float(t[1])) for t in
                         (tok.split(":") for tok in parts[1:])])
    return labels, rows
