"""Conditional-generation label coherence.

Counterpart of ``multivae_tpu/eval/coherence.py``: label classifiers are fit
per modality on the raw train features (the numpy stand-in for
scikit-learn's logistic regression,
:class:`multivae_tpu_torch.eval.estimators.LogisticRegression`), then the
conditional generations of every subset posterior are scored for agreement
with the conditioning sample's label, and random generations for agreement
across modalities. The generations and their noise are
:mod:`multivae_tpu_torch.eval.sample_quality`'s.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .estimators import LogisticRegression
from .sample_quality import generate_conditional_samples, \
    generate_random_samples


def train_modality_classifiers(exp, model_idx: int = 0):
    """Per-modality label classifiers on the train split's complete samples,
    or None when the labels have a single class."""
    dataset = exp.member_datasets(model_idx)[0]
    data, labels, _ = dataset.gather(dataset.idx_per_modality_subset[-1])
    if len(np.unique(labels)) < 2:
        return None
    return {m: LogisticRegression(max_iter=1000).fit(x, labels)
            for m, x in data.items()}


def test_generation(exp, model_idx: int = 0,
                    clfs=None, samples=None) -> Dict[str, Dict[str, float]]:
    """``{subset: {modality: accuracy}}`` of the modality classifiers on the
    conditional generations against the conditioning samples' labels.
    ``clfs`` reuses trained classifiers, ``samples`` a
    :func:`generate_conditional_samples` result."""
    if clfs is None:
        clfs = train_modality_classifiers(exp, model_idx)
    if clfs is None:
        return {}
    dataset = exp.member_datasets(model_idx)[1]
    _, labels, _ = dataset.gather(dataset.idx_per_modality_subset[-1])
    gen, _ = (samples if samples is not None
              else generate_conditional_samples(exp, model_idx))
    return {s_key: {m_key: float(np.mean(clfs[m_key].predict(x) == labels))
                    for m_key, x in mods.items()}
            for s_key, mods in gen.items()}


# the JAX package's function name, not collected by pytest as a test
test_generation.__test__ = False


def calculate_coherence(exp, samples: Dict[str, np.ndarray],
                        model_idx: int = 0, clfs=None) -> float:
    """Fraction of unconditional generations on whose label every modality
    classifier agrees."""
    if clfs is None:
        clfs = train_modality_classifiers(exp, model_idx)
    if clfs is None:
        return float("nan")
    preds = np.stack([clfs[m].predict(np.asarray(x))
                      for m, x in samples.items()])
    return float(np.mean(np.all(preds == preds[0], axis=0)))


def evaluate_coherence(exp, model_idx: int = 0,
                       num_random_samples: int = 256,
                       clfs=None, samples=None) -> Dict[str, object]:
    """The eval cadence's entry point: ``{"cond": test_generation(...),
    "random": calculate_coherence(...)}`` of ``num_random_samples`` random
    generations, the logger's ``Generation/*`` family; ``{}`` when the
    labels have a single class."""
    if clfs is None:
        clfs = train_modality_classifiers(exp, model_idx)
    if clfs is None:
        return {}
    cond = test_generation(exp, model_idx, clfs=clfs, samples=samples)
    rand = generate_random_samples(exp, model_idx,
                                   num_samples=num_random_samples)
    return {"cond": cond,
            "random": calculate_coherence(exp, rand, model_idx, clfs=clfs)}
