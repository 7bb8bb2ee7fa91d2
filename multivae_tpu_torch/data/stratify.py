"""Multilabel iterative stratification (shuffle-split and k-fold).

A copy of ``multivae_tpu/data/stratify.py`` (numpy and pandas), so the
port's data layer needs nothing of the JAX package.

The reference depends on ``iterative-stratification``'s
``MultilabelStratifiedShuffleSplit`` / ``MultilabelStratifiedKFold``
(``multimodal_cohort/fetchers/multiblock_fetcher.py:5``,
``multimodal_cohort/dataset.py:10``) to balance train/test/fold splits on
``[age, sex, site]`` (age discretized). That package is not available here, so
this module implements the same iterative-stratification algorithm
(Sechidis, Tsoumakas & Vlahavas, ECML-PKDD 2011) natively. Categorical
stratification columns are one-hot encoded into a multilabel indicator matrix
first; RNG streams differ from iterstrat so splits match in *balance*, not in
exact membership (noted in SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np
import pandas as pd


def discretizer(values, method: str = "auto") -> np.ndarray:
    """Histogram binning of a continuous variable
    (``multimodal_cohort/utils.py:15-22``)."""
    bins = np.histogram_bin_edges(values, bins=method)
    return np.digitize(values, bins=bins[1:], right=True)


def indicator_matrix(y) -> np.ndarray:
    """One-hot encode each column of a DataFrame/array of categoricals into a
    single binary indicator matrix."""
    if isinstance(y, pd.DataFrame):
        cols = [np.asarray(y[c]) for c in y.columns]
    else:
        arr = np.asarray(y)
        if arr.ndim == 1:
            arr = arr[:, None]
        cols = [arr[:, i] for i in range(arr.shape[1])]
    blocks = []
    for col in cols:
        cats, codes = np.unique(col.astype(str), return_inverse=True)
        onehot = np.zeros((len(col), len(cats)), dtype=np.int8)
        onehot[np.arange(len(col)), codes] = 1
        blocks.append(onehot)
    return np.concatenate(blocks, axis=1)


def _iterative_stratification(labels: np.ndarray, proportions: Sequence[float],
                              rng: np.random.Generator) -> np.ndarray:
    """Assign each sample to one of ``len(proportions)`` folds.

    Implements the iterative stratification algorithm: repeatedly pick the
    label with the fewest remaining samples and deal its samples to the fold
    with the greatest remaining desire for that label (ties → larger overall
    capacity → random).
    """
    n, n_labels = labels.shape
    n_folds = len(proportions)
    r = np.asarray(proportions, dtype=np.float64)
    r = r / r.sum()
    fold_of = np.full(n, -1, dtype=np.int64)
    # desired counts per fold, overall and per label
    c_fold = r * n
    c_label = r[:, None] * labels.sum(axis=0)[None, :]

    remaining = np.ones(n, dtype=bool)
    while True:
        counts = labels[remaining].sum(axis=0)
        active = np.where(counts > 0)[0]
        if len(active) == 0:
            break
        lbl = active[np.argmin(counts[active])]
        idxs = np.where(remaining & (labels[:, lbl] > 0))[0]
        idxs = rng.permutation(idxs)
        for i in idxs:
            # fold with max remaining desire for this label
            best = np.where(c_label[:, lbl] == c_label[:, lbl].max())[0]
            if len(best) > 1:
                caps = c_fold[best]
                best = best[caps == caps.max()]
                if len(best) > 1:
                    best = best[[rng.integers(len(best))]]
            f = int(best[0])
            fold_of[i] = f
            remaining[i] = False
            c_fold[f] -= 1
            c_label[f] -= labels[i]
    # samples with no labels: fill by remaining fold capacity
    for i in np.where(remaining)[0]:
        f = int(np.argmax(c_fold))
        fold_of[i] = f
        c_fold[f] -= 1
    return fold_of


class MultilabelStratifiedShuffleSplit:
    """Drop-in equivalent of iterstrat's splitter of the same name."""

    def __init__(self, n_splits: int = 1, test_size: float = 0.2,
                 random_state: int | None = None):
        self.n_splits = n_splits
        self.test_size = test_size
        self.random_state = random_state

    def split(self, X, y) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(X)
        if y is None:
            rng = np.random.default_rng(self.random_state)
            for _ in range(self.n_splits):
                perm = rng.permutation(n)
                n_test = int(round(n * self.test_size))
                yield np.sort(perm[n_test:]), np.sort(perm[:n_test])
            return
        labels = indicator_matrix(y)
        for s in range(self.n_splits):
            seed = (None if self.random_state is None
                    else self.random_state + s)
            rng = np.random.default_rng(seed)
            fold_of = _iterative_stratification(
                labels, [1.0 - self.test_size, self.test_size], rng)
            train = np.where(fold_of == 0)[0]
            test = np.where(fold_of == 1)[0]
            yield np.sort(train), np.sort(test)


class MultilabelStratifiedKFold:
    """Drop-in equivalent of iterstrat's k-fold splitter."""

    def __init__(self, n_splits: int = 5, shuffle: bool = False,
                 random_state: int | None = None):
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def split(self, X, y) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        labels = indicator_matrix(y)
        rng = np.random.default_rng(self.random_state if self.shuffle
                                    else 0)
        fold_of = _iterative_stratification(
            labels, [1.0 / self.n_splits] * self.n_splits, rng)
        for f in range(self.n_splits):
            test = np.where(fold_of == f)[0]
            train = np.where(fold_of != f)[0]
            yield np.sort(train), np.sort(test)


class ShuffleSplit:
    """Plain shuffle split (mirrors sklearn's, used when stratify is None;
    ``dataset.py:231-233``)."""

    def __init__(self, n_splits: int = 1, test_size: float = 0.2,
                 random_state: int | None = None):
        self.n_splits = n_splits
        self.test_size = test_size
        self.random_state = random_state

    def split(self, X, y=None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(X)
        rng = np.random.default_rng(self.random_state)
        for _ in range(self.n_splits):
            perm = rng.permutation(n)
            n_test = int(round(n * self.test_size))
            yield np.sort(perm[n_test:]), np.sort(perm[:n_test])
