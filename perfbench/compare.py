"""The numbers that decide ``correct``: gaps between the program's outputs
and the plain reference's, each held to a limit of its own
(``limits/<workload>.json``)."""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np


def rel_max(prog: Iterable[float], ref: Iterable[float]) -> float:
    """The largest ``|prog - ref| / |ref|`` over paired values; a length
    mismatch reads infinite."""
    a, b = np.asarray(list(prog), float), np.asarray(list(ref), float)
    if a.shape != b.shape or not len(b):
        return float("inf")
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def scaled_max(prog, ref) -> float:
    """``max |prog - ref|`` over the root mean square of ``ref``; a shape
    mismatch or a non-finite value reads infinite."""
    a, b = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        return float("inf")
    rms = float(np.sqrt(np.mean(b * b)))
    return float(np.max(np.abs(a - b)) / max(rms, 1e-30))


def leaf_norms(leaves: Dict[str, "torch.Tensor"]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              grad_ref: Dict[str, float]):
    """Per leaf, the gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger. Leaves whose reference gradient (``grad_ref``) is
    under a thousandth of the median leaf's are left out: they move by
    round-off alone. A leaf set that differs reads infinite."""
    if set(prog) != set(ref):
        return [float("inf")]
    gmed = float(np.median(list(grad_ref.values())))
    kept = [k for k in ref if grad_ref[k] >= 1e-3 * gmed]
    med = float(np.median([ref[k] for k in kept]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in kept]


def worst_leaf(prog, ref, grad_ref) -> float:
    """:func:`leaf_gaps` at the worst leaf."""
    return max(leaf_gaps(prog, ref, grad_ref))


def moved_apart(prog: Dict[str, "torch.Tensor"],
                ref: Dict[str, "torch.Tensor"],
                start: Dict[str, "torch.Tensor"], step: float) -> float:
    """How many parameter elements changed from ``start`` by amounts that
    differ between the program and the reference by more than ``step``,
    Adam's learning rate: an element whose update went the other way
    (Adam's first step is the gradient's sign times the rate) differs by
    two. A float32 program sends no element the other way but where its
    gradient is nought to rounding; a TF32 product sends every element
    whose gradient is under its rounding (~5e-4 of the terms)."""
    if set(prog) != set(ref):
        return float("inf")
    return float(sum(int(((prog[k] - start[k]) - (ref[k] - start[k]))
                         .abs().gt(step).sum()) for k in ref))


def log_p_gap(prog, ref) -> float:
    """The largest gap of ``log10 p`` over ``max(1, |log10 p_ref|)``, the
    p-values clipped at 1e-300."""
    a = np.log10(np.clip(np.asarray(prog, np.float64), 1e-300, None))
    b = np.log10(np.clip(np.asarray(ref, np.float64), 1e-300, None))
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        return float("inf")
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))
