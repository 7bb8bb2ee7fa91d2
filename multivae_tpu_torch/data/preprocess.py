"""Per-modality preprocessing: standard scaling and covariate residualization.

Counterpart of ``multivae_tpu/data/preprocess.py``, which takes its scaler
from scikit-learn. The port's :class:`StandardScaler` is numpy with
scikit-learn's semantics, so the data layer loads where scikit-learn is not
installed (the card's machine): population standard deviation (``ddof=0``),
a zero standard deviation scales by 1, ``fit`` / ``transform`` /
``inverse_transform`` / ``fit_transform``, fitted ``mean_``, ``var_``,
``scale_`` and ``n_samples_seen_``. :class:`Residualizer` is the JAX
package's, which is numpy and pandas already: one ``lstsq`` over a shared
design matrix (off by default, ``train/experiment.py``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import pandas as pd

__all__ = ["StandardScaler", "Residualizer"]


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
        X = np.asarray(X, dtype=np.float64)
        if X.ndim != 2:
            raise ValueError(f"expected a 2-d array, got shape {X.shape}")
        self.n_samples_seen_ = X.shape[0]
        self.mean_ = X.mean(axis=0) if self.with_mean else None
        if self.with_std:
            self.var_ = X.var(axis=0)
            scale = np.sqrt(self.var_)
            # scikit-learn's _handle_zeros_in_scale: a constant column
            # (std within 10 eps of 0) is left unscaled
            eps = np.finfo(np.float64).eps
            scale[scale < 10 * eps] = 1.0
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
