"""Per-modality preprocessing: standard scaling, ordinal encoding and
covariate residualization.

Counterpart of ``multivae_tpu/data/preprocess.py``, which takes its scaler
from scikit-learn (as ``multivae_tpu/analysis/avatars.py`` takes its
``OrdinalEncoder``). The port's :class:`StandardScaler` and
:class:`OrdinalEncoder` are numpy with scikit-learn's semantics, so the
port loads where scikit-learn is not installed: the scaler's
population standard deviation (``ddof=0``) from float64 accumulators,
scikit-learn's constant-feature rule (such a column scales by 1),
``fit`` / ``transform`` / ``inverse_transform`` / ``fit_transform``, fitted
``mean_``, ``var_``, ``scale_`` and ``n_samples_seen_``. :class:`Residualizer` is the JAX
package's, which is numpy and pandas already: one ``lstsq`` over a shared
design matrix (off by default, ``train/experiment.py``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import pandas as pd

__all__ = ["OrdinalEncoder", "StandardScaler", "Residualizer"]


class StandardScaler:
    """``(x - mean_) / scale_`` per column, fit on float64 copies of the
    data (scikit-learn's ``StandardScaler`` with its default flags)."""

    def __init__(self, with_mean: bool = True, with_std: bool = True):
        self.with_mean = with_mean
        self.with_std = with_std
        self.mean_ = None
        self.var_ = None
        self.scale_ = None
        self.n_samples_seen_ = 0

    def fit(self, X, y=None) -> "StandardScaler":
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError(f"expected a 2-d array, got shape {X.shape}")
        n = X.shape[0]
        self.n_samples_seen_ = n
        # scikit-learn's float64 accumulators: the mean, then the corrected
        # two-pass variance (Chan, Golub and LeVeque), in its order
        mean = np.sum(X, axis=0, dtype=np.float64) / n
        self.mean_ = mean if self.with_mean else None
        if self.with_std:
            temp = X - mean
            correction = np.sum(temp, axis=0, dtype=np.float64)
            temp **= 2
            self.var_ = (np.sum(temp, axis=0, dtype=np.float64)
                         - correction ** 2 / n) / n
            # scikit-learn's _is_constant_feature on the variance, then
            # _handle_zeros_in_scale: a column indistinguishable from a
            # constant is left unscaled
            eps = np.finfo(np.float64).eps
            constant = self.var_ <= (n * eps * self.var_
                                     + (n * mean * eps) ** 2)
            scale = np.sqrt(self.var_)
            scale[constant] = 1.0
            self.scale_ = scale
        return self

    def _check(self):
        if self.n_samples_seen_ == 0:
            raise ValueError("This StandardScaler instance is not fitted "
                             "yet. Call 'fit' first.")

    @staticmethod
    def _float_copy(X):
        X = np.asarray(X)
        return np.array(X, dtype=X.dtype if X.dtype.kind == "f"
                        else np.float64, copy=True)

    # as scikit-learn does, the statistics are cast to the data's float type
    def transform(self, X):
        self._check()
        X = self._float_copy(X)
        if self.with_mean:
            X -= self.mean_.astype(X.dtype)
        if self.with_std:
            X /= self.scale_.astype(X.dtype)
        return X

    def inverse_transform(self, X):
        self._check()
        X = self._float_copy(X)
        if self.with_std:
            X *= self.scale_.astype(X.dtype)
        if self.with_mean:
            X += self.mean_.astype(X.dtype)
        return X

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


class OrdinalEncoder:
    """Each column's categories coded ``0 .. k-1`` in sorted order
    (scikit-learn's ``OrdinalEncoder`` with its default flags: the
    categories are ``np.unique`` of the column, an unknown one raises, the
    codes are float64)."""

    def __init__(self):
        self.categories_ = None

    def fit(self, X, y=None) -> "OrdinalEncoder":
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError(f"expected a 2-d array, got shape {X.shape}")
        self.categories_ = [np.unique(X[:, j]) for j in range(X.shape[1])]
        return self

    def transform(self, X):
        if self.categories_ is None:
            raise ValueError("This OrdinalEncoder instance is not fitted "
                             "yet. Call 'fit' first.")
        X = np.asarray(X)
        out = np.empty(X.shape, dtype=np.float64)
        for j, cats in enumerate(self.categories_):
            col = X[:, j]
            codes = np.searchsorted(cats, col)
            known = (codes < len(cats)) & (cats[np.minimum(
                codes, len(cats) - 1)] == col)
            if not known.all():
                raise ValueError(f"Found unknown categories "
                                 f"{sorted(set(col[~known].tolist()))} in "
                                 f"column {j} during transform")
            out[:, j] = codes
        return out

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


def _design_matrix(df: pd.DataFrame, by_continuous: Sequence[str],
                   by_categorical: Sequence[str],
                   categories: Dict[str, np.ndarray] | None = None):
    """[1, continuous..., one-hot(categorical, first level dropped)...] —
    the parameterization of the formula ``y ~ cont + C(cat)``."""
    n = len(df)
    cols = [np.ones((n, 1))]
    for c in by_continuous:
        cols.append(np.asarray(df[c], dtype=np.float64)[:, None])
    cats_out = {}
    for c in by_categorical:
        vals = np.asarray(df[c]).astype(str)
        if categories is None:
            levels = np.unique(vals)
        else:
            levels = categories[c]
        cats_out[c] = levels
        for lev in levels[1:]:  # drop first level (treatment coding)
            cols.append((vals == lev).astype(np.float64)[:, None])
    return np.concatenate(cols, axis=1), cats_out


class Residualizer:
    """OLS residualizer over covariates (the JAX package's, unchanged)."""

    def __init__(self, by_continuous: Sequence[str],
                 by_categorical: Sequence[str]):
        self.by_continuous = list(by_continuous)
        self.by_categorical = list(by_categorical)
        self.coefs = None           # [n_design, n_features]
        self.categories = None
        self.columns_to_residualize: List[str] = []

    def fit(self, df: pd.DataFrame, columns_to_residualize: Sequence[str]):
        self.columns_to_residualize = list(columns_to_residualize)
        X, self.categories = _design_matrix(df, self.by_continuous,
                                            self.by_categorical)
        Y = np.asarray(df[self.columns_to_residualize], dtype=np.float64)
        self.coefs, *_ = np.linalg.lstsq(X, Y, rcond=None)

    def _predict(self, df: pd.DataFrame) -> np.ndarray:
        X, _ = _design_matrix(df, self.by_continuous, self.by_categorical,
                              self.categories)
        return X @ self.coefs

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        if self.coefs is None:
            raise ValueError(
                "You must fit the residualizer before transforming data")
        new_df = df.copy()
        pred = self._predict(df)
        for i, col in enumerate(self.columns_to_residualize):
            new_df[col] = np.asarray(new_df[col], dtype=np.float64) - pred[:, i]
        return new_df

    def fit_transform(self, df, columns_to_residualize):
        self.fit(df, columns_to_residualize)
        return self.transform(df)

    def inverse_transform(self, df: pd.DataFrame) -> pd.DataFrame:
        if self.coefs is None:
            raise ValueError(
                "You must fit the residualizer before transforming data")
        new_df = df.copy()
        pred = self._predict(df)
        for i, col in enumerate(self.columns_to_residualize):
            new_df[col] = np.asarray(new_df[col], dtype=np.float64) + pred[:, i]
        return new_df
