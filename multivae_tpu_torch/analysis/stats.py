"""Statistics of the analyses: similarity matrices and RSA, scalar linear
models, the DAA regressions and the one-way ANOVA.

Counterpart of ``multivae_tpu/analysis/stats.py``, in numpy, scipy and
pandas (statsmodels is not used). The RSA and scalar-fit helpers
(``:39-195``) and :func:`one_way_anova_batch` (``:450-471``) are copies of
the JAX package's. The DAA regressions (``:197-450``) fit every ROI at
once: closed-form two-level, pooled-OLS and random-intercept REML designs,
each in a ``_batch`` form (from the avatar tensor) and a ``_from_stats``
form (from the per-subject sufficient statistics that the ``stats-only``
artifact mode reduces on the device).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import pandas as pd
from scipy import optimize, stats
from scipy.spatial.distance import pdist, squareform
from scipy.stats import kendalltau


# --------------------------------------------------------------------------
# similarity matrices / RSA
# --------------------------------------------------------------------------
def data2cmat(data: np.ndarray) -> np.ndarray:
    """Pairwise euclidean dissimilarity matrix (``stat_utils.py:25-32``)."""
    if data.ndim > 2:
        return np.array([squareform(pdist(data[idx], metric="euclidean"))
                         for idx in range(len(data))])
    return squareform(pdist(data, metric="euclidean"))


def cmat2triu(arr: np.ndarray) -> np.ndarray:
    """Upper triangular (k=1) of a square matrix (``stat_utils.py:35-42``)."""
    assert np.ndim(arr) == 2, "Expect 2 dim similarity!"
    assert arr.shape[0] == arr.shape[1], "Expect square similarity!"
    return arr[np.triu_indices(n=arr.shape[0], k=1)]


def vec2cmat(vec: np.ndarray, categorical: bool = False,
             metric: str = "euclidean") -> np.ndarray:
    """Dissimilarity matrix of a single characteristic
    (``stat_utils.py:45-53``)."""
    vec = np.asarray(vec)
    if not categorical:
        return squareform(pdist(vec[:, None].astype(float), metric=metric))
    return (vec[:, None] != vec[None, :]).astype(int)


def fit_rsa(cmat: np.ndarray, ref_cmat: np.ndarray,
            idxs: Optional[np.ndarray] = None):
    """Kendall tau between matrix upper triangles (``stat_utils.py:81-95``).

    The 3-D branch replicates the reference's hardcoded ``range(10)`` loop
    (``stat_utils.py:87-92``) — bug-compatible by documented choice — but
    guards the silent 10-round assumption: fewer rounds would IndexError
    upstream (raised here with a clear message), extra rounds are silently
    ignored upstream (warned about here).
    """
    if cmat.ndim > 2:
        if cmat.shape[0] < 10:
            raise ValueError(
                f"fit_rsa's 3-D path replicates the reference's hardcoded "
                f"10-round loop (stat_utils.py:87-92) and needs "
                f"cmat.shape[0] >= 10; got {cmat.shape[0]}")
        if cmat.shape[0] > 10:
            import warnings
            warnings.warn(
                f"fit_rsa's 3-D path uses only the first 10 of "
                f"{cmat.shape[0]} rounds (reference range(10) quirk, "
                f"stat_utils.py:87-92)", stacklevel=2)
        r = np.array([
            kendalltau(cmat2triu(cmat[idx][idxs, :][:, idxs]),
                       cmat2triu(ref_cmat))[0]
            for idx in range(10)])
        return np.arctan(r)
    tau, pval = kendalltau(cmat2triu(cmat), cmat2triu(ref_cmat))
    return tau, pval


# --------------------------------------------------------------------------
# scalar linear models (statsmodels-free)
# --------------------------------------------------------------------------
def _design(df: pd.DataFrame, x_name: str,
            other_cov_names: Sequence[str]) -> np.ndarray:
    cols = [np.ones(len(df)), np.asarray(df[x_name], dtype=float)]
    for c in other_cov_names:
        cols.append(np.asarray(df[c], dtype=float))
    return np.stack(cols, axis=1)


def ols_fit(X: np.ndarray, y: np.ndarray):
    """OLS with t-tests; returns (params, pvalues, se, dof)."""
    n, p = X.shape
    beta, _, rank, _ = np.linalg.lstsq(X, y, rcond=None)
    resid = y - X @ beta
    dof = n - rank
    sigma2 = float(resid @ resid) / max(dof, 1)
    xtx_inv = np.linalg.pinv(X.T @ X)
    se = np.sqrt(np.clip(np.diag(xtx_inv) * sigma2, 0, None))
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(se > 0, beta / se, np.inf)
    pvals = 2.0 * stats.t.sf(np.abs(t), max(dof, 1))
    return beta, pvals, se, dof


def _mixed_reml(X: np.ndarray, y: np.ndarray, groups: np.ndarray):
    """Random-intercept LMM by REML; returns (beta, pvalues, se)."""
    uniq, inv = np.unique(groups, return_inverse=True)
    group_lists = [np.where(inv == g)[0] for g in range(len(uniq))]
    n, p = X.shape

    def profile(lam: float):
        xtwx = np.zeros((p, p))
        xtwy = np.zeros(p)
        logdet = 0.0
        for rows in group_lists:
            Xi, yi = X[rows], y[rows]
            ni = len(rows)
            w = lam / (1.0 + ni * lam)
            xtwx += Xi.T @ Xi - w * np.outer(Xi.sum(0), Xi.sum(0))
            xtwy += Xi.T @ yi - w * Xi.sum(0) * yi.sum()
            logdet += np.log1p(ni * lam)
        beta = np.linalg.solve(xtwx, xtwy)
        rss = 0.0
        for rows in group_lists:
            Xi, yi = X[rows], y[rows]
            ri = yi - Xi @ beta
            ni = len(rows)
            w = lam / (1.0 + ni * lam)
            rss += ri @ ri - w * ri.sum() ** 2
        sigma2 = rss / max(n - p, 1)
        _, ld2 = np.linalg.slogdet(xtwx)
        reml = -0.5 * ((n - p) * np.log(sigma2) + logdet + ld2
                       + (n - p))
        return reml, beta, sigma2, xtwx

    res = optimize.minimize_scalar(
        lambda t: -profile(np.exp(t))[0], bounds=(-10.0, 10.0),
        method="bounded")
    lam = float(np.exp(res.x))
    _, beta, sigma2, xtwx = profile(lam)
    cov = sigma2 * np.linalg.pinv(xtwx)
    se = np.sqrt(np.clip(np.diag(cov), 0, None))
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(se > 0, beta / se, np.inf)
    pvals = 2.0 * stats.norm.sf(np.abs(z))
    return beta, pvals, se


def make_regression(df: pd.DataFrame, x_name: str, y_name: str,
                    other_cov_names: Sequence[str] = (),
                    groups_name: Optional[str] = None, method: str = "fixed",
                    other=None):
    """Fit a linear model with the requested design
    (``stat_utils.py:55-79``); returns ``(pvalue, coef, subjects_betas)``."""
    y = np.asarray(df[y_name], dtype=float)
    subjects_betas = None
    if method == "fixed":
        X = _design(df, x_name, other_cov_names)
        beta, pvals, _, _ = ols_fit(X, y)
        return pvals[1], beta[1], None
    if method == "mixed":
        X = _design(df, x_name, other_cov_names)
        groups = np.asarray(df[groups_name])
        beta, pvals, _ = _mixed_reml(X, y, groups)
        return pvals[1], beta[1], None
    if method == "hierarchical":
        rows = []
        for group_lab, group_df in df.groupby(groups_name, sort=False):
            Xg = _design(group_df, x_name, other_cov_names)
            yg = np.asarray(group_df[y_name], dtype=float)
            bg, *_ = np.linalg.lstsq(Xg, yg, rcond=None)
            rows.append([group_lab, bg[1]])
        lv1 = pd.DataFrame(rows, columns=[groups_name, "beta"])
        subjects_betas = lv1
        betas = lv1["beta"].to_numpy(dtype=float)
        coef, pval = one_sample_ttest(betas)
        return pval, coef, subjects_betas
    raise ValueError(f"unknown regression method: {method}")


def one_sample_ttest(values: np.ndarray) -> Tuple[float, float]:
    """Mean + two-sided t-test vs 0, dof n-1 — equals OLS ``beta ~ 1``."""
    values = np.asarray(values, dtype=float)
    n = len(values)
    mean = float(values.mean())
    se = values.std(ddof=1) / np.sqrt(n)
    if se == 0:
        return mean, 0.0 if mean != 0 else 1.0
    t = mean / se
    return mean, float(2.0 * stats.t.sf(abs(t), n - 1))


# --------------------------------------------------------------------------
# batched regressions of the DAA stage
# --------------------------------------------------------------------------
def per_group_slopes(x: np.ndarray, y: np.ndarray):
    """Closed-form per-group OLS slopes.

    ``x``: ``[G, N]`` regressor per group; ``y``: ``[G, N, R]`` responses.
    Returns slopes ``[G, R]`` — ``cov(x, y) / var(x)`` per group, identical to
    each group's OLS slope with intercept.

    Runs on host numpy: the einsum is a few MFLOP and the avatars already
    live in host memory (the artifact memmap).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xc = x - x.mean(axis=1, keepdims=True)
    yc = y - y.mean(axis=1, keepdims=True)
    sxx = np.sum(xc * xc, axis=1)  # [G]
    sxy = np.einsum("gn,gnr->gr", xc, yc)
    return sxy / sxx[:, None]


def hierarchical_regression_batch(x: np.ndarray, y: np.ndarray):
    """Vectorized two-level regression matching the JAX package's
    ``make_regression(..., method='hierarchical')``.

    ``x``: ``[G, N]``; ``y``: ``[G, N, R]``. Level 1 computes per-group
    slopes; level 2 is the one-sample t-test across groups.
    Returns ``(pvalues [R], coefs [R], betas [G, R])``.
    """
    betas = np.asarray(per_group_slopes(x, y), dtype=np.float64)  # [G, R]
    g = betas.shape[0]
    coefs = betas.mean(axis=0)
    se = betas.std(axis=0, ddof=1) / np.sqrt(g)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(se > 0, coefs / se, np.inf)
    pvals = 2.0 * stats.t.sf(np.abs(t), g - 1)
    return pvals, coefs, betas


def hierarchical_regression_from_stats(x: np.ndarray, ysum_g: np.ndarray,
                                       xysum_g: np.ndarray):
    """Two-level regression from per-group sufficient statistics.

    Level-1 per-group OLS slopes need only ``Σ_n y`` and ``Σ_n x·y`` per
    group (``slope_g = (Σxy − x̄·Σy) / Sxx``); the DAA stats-only mode
    ships those ``[G, R]`` tensors from device instead of the full avatar
    tensor. ``x``: ``[G, N]`` exact host-side regressor. Returns
    ``(pvalues [R], coefs [R], betas [G, R])`` exactly like
    :func:`hierarchical_regression_batch` (level 2 is unchanged).
    """
    x = np.asarray(x, dtype=np.float64)
    ysum_g = np.asarray(ysum_g, dtype=np.float64)
    xysum_g = np.asarray(xysum_g, dtype=np.float64)
    xmean = x.mean(axis=1)                                # [G]
    sxx = np.sum((x - xmean[:, None]) ** 2, axis=1)       # [G]
    betas = (xysum_g - xmean[:, None] * ysum_g) / sxx[:, None]
    g = betas.shape[0]
    coefs = betas.mean(axis=0)
    se = betas.std(axis=0, ddof=1) / np.sqrt(g)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(se > 0, coefs / se, np.inf)
    pvals = 2.0 * stats.t.sf(np.abs(t), g - 1)
    return pvals, coefs, betas


def fixed_regression_from_stats(x: np.ndarray, ysum_g: np.ndarray,
                                xysum_g: np.ndarray, yysum_g: np.ndarray,
                                offset_g: Optional[np.ndarray] = None):
    """Pooled OLS (slope + intercept) from per-group sufficient statistics.

    Matches :func:`fixed_regression_batch` run on the flattened
    ``[G·N]`` observations ``y − offset`` (the DAA fixed design subtracts
    the per-subject reconstruction, ``workflow.py:476-481``), using only
    ``Σ_n y``, ``Σ_n x·y`` and ``Σ_n y²`` per group plus the exact
    host-side ``x``. Returns ``(pvalues [R], coefs [R])``.
    """
    x = np.asarray(x, dtype=np.float64)
    ysum_g = np.asarray(ysum_g, dtype=np.float64)
    xysum_g = np.asarray(xysum_g, dtype=np.float64)
    yysum_g = np.asarray(yysum_g, dtype=np.float64)
    g, n_per = x.shape
    n = g * n_per
    sx_g = x.sum(axis=1)                                  # [G]
    if offset_g is not None:
        off = np.asarray(offset_g, dtype=np.float64)      # [G, R]
        yysum_g = yysum_g - 2.0 * off * ysum_g + n_per * off ** 2
        xysum_g = xysum_g - off * sx_g[:, None]
        ysum_g = ysum_g - n_per * off
    sx = sx_g.sum()
    sxx_raw = np.sum(x * x)
    sy = ysum_g.sum(axis=0)                               # [R]
    sxy_raw = xysum_g.sum(axis=0)                         # [R]
    syy_raw = yysum_g.sum(axis=0)                         # [R]
    sxx = sxx_raw - sx * sx / n
    sxy = sxy_raw - sx * sy / n
    syy = syy_raw - sy * sy / n
    slope = sxy / sxx
    ss_res = np.maximum(syy - slope * sxy, 0.0)
    sigma2 = ss_res / (n - 2)
    se = np.sqrt(sigma2 / sxx)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(se > 0, slope / se, np.inf)
    pvals = 2.0 * stats.t.sf(np.abs(t), n - 2)
    return pvals, slope


def mixed_regression_batch(x: np.ndarray, y: np.ndarray,
                           n_grid: int = 61, n_refine: int = 3):
    """Vectorized random-intercept REML across all ROIs at once.

    ``x``: ``[G, N]`` per-subject regressor; ``y``: ``[G, N, R]`` responses
    — the DAA mixed design (``stat_utils.py:make_regression('mixed')``,
    MixedLM with a random intercept per subject), balanced: every subject
    carries the same ``N`` observations. Matches :func:`_mixed_reml` per
    ROI to numerical tolerance but runs all ``R`` fits together: for a
    candidate variance ratio ``lam`` the 2x2 normal matrix
    ``X'V^{-1}X`` and its log-determinant are ROI-independent, so only the
    ``X'V^{-1}y`` / RSS terms carry an R axis. ``lam`` is profiled per ROI
    on a log grid with ``n_refine`` local refinements.

    Returns ``(pvalues [R], coefs [R])`` for the slope term.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    ysum_g = y.sum(axis=1)                                # [G, R]
    xysum_g = np.einsum("gn,gnr->gr", x, y)               # [G, R]
    yysum_g = np.einsum("gnr,gnr->gr", y, y)              # [G, R]
    return mixed_regression_from_stats(x, ysum_g, xysum_g, yysum_g,
                                       n_grid=n_grid, n_refine=n_refine)


def mixed_regression_from_stats(x: np.ndarray, ysum_g: np.ndarray,
                                xysum_g: np.ndarray, yysum_g: np.ndarray,
                                n_grid: int = 61, n_refine: int = 3):
    """Random-intercept REML from per-group sufficient statistics.

    The REML objective for the balanced random-intercept model depends on
    ``y`` only through ``Σ_n y``, ``Σ_n x·y`` and ``Σ_n y²`` per group, so
    the DAA stats-only mode computes those three ``[G, R]`` tensors on
    device and never materializes the avatar tensor on the host.
    ``x``: ``[G, N]`` (exact, host-side). Returns ``(pvalues, coefs)``.
    """
    x = np.asarray(x, dtype=np.float64)
    g, n_per = x.shape
    r = ysum_g.shape[1]
    n = g * n_per
    p = 2

    # group-level sufficient statistics (shared across lam candidates)
    ones = np.ones_like(x)
    Xg = np.stack([ones, x], axis=2)                      # [G, N, 2]
    si = Xg.sum(axis=1)                                   # [G, 2]
    xtx_g = np.einsum("gnk,gnl->gkl", Xg, Xg)             # [G, 2, 2]
    xtx = xtx_g.sum(axis=0)                               # [2, 2]
    ssi = np.einsum("gk,gl->kl", si, si)                  # [2, 2]
    xty_g = np.stack([np.asarray(ysum_g, dtype=np.float64),
                      np.asarray(xysum_g, dtype=np.float64)],
                     axis=1)                              # [G, 2, R]
    xty = xty_g.sum(axis=0)                               # [2, R]
    ysum = np.asarray(ysum_g, dtype=np.float64)           # [G, R]
    s_ysum = np.einsum("gk,gr->kr", si, ysum)             # [2, R]
    yy = np.asarray(yysum_g, dtype=np.float64).sum(axis=0)  # [R]

    def reml(lam, idx=None):
        """Objective for ROIs ``idx`` (all when None) at a shared lam,
        plus their (beta, sigma2, inv(xtwx))."""
        sl = slice(None) if idx is None else idx
        w = lam / (1.0 + n_per * lam)
        xtwx = xtx - w * ssi                              # [2, 2]
        xtwy = xty[:, sl] - w * s_ysum[:, sl]             # [2, r']
        det = xtwx[0, 0] * xtwx[1, 1] - xtwx[0, 1] * xtwx[1, 0]
        inv = np.array([[xtwx[1, 1], -xtwx[0, 1]],
                        [-xtwx[1, 0], xtwx[0, 0]]]) / det
        beta = inv @ xtwy                                 # [2, r']
        # rss = Σ_i r_i'r_i - w (r_i.sum)^2, expanded in the sufficient
        # statistics so no per-group pass is needed
        rtr = (yy[sl] - 2.0 * np.einsum("kr,kr->r", beta, xty[:, sl])
               + np.einsum("kr,kl,lr->r", beta, xtx, beta))
        rsum = ysum[:, sl] - si @ beta                    # [G, r']
        rss = rtr - w * np.einsum("gr,gr->r", rsum, rsum)
        sigma2 = np.maximum(rss, 1e-300) / max(n - p, 1)
        logdet = g * np.log1p(n_per * lam)
        obj = -0.5 * ((n - p) * np.log(sigma2) + logdet + np.log(abs(det))
                      + (n - p))
        return obj, beta, sigma2, inv

    # coarse log-lambda grid shared by every ROI...
    ts = np.linspace(-10.0, 10.0, n_grid)
    objs = np.stack([reml(np.exp(t))[0] for t in ts])     # [L, R]
    t_centers = ts[np.argmax(objs, axis=0)]               # [R]
    delta = (ts[1] - ts[0])
    # ...then local refinement, ROIs grouped by their current optimum so
    # each evaluation is restricted to the ROIs that need it
    for _ in range(n_refine):
        new_centers = t_centers.copy()
        for c in np.unique(t_centers):
            idx = np.where(t_centers == c)[0]
            local = np.linspace(c - delta, c + delta, 9)
            vals = np.stack([reml(np.exp(t), idx)[0] for t in local])
            new_centers[idx] = local[np.argmax(vals, axis=0)]
        t_centers = new_centers
        delta = delta / 4.0

    pvals = np.empty(r)
    coefs = np.empty(r)
    for c in np.unique(t_centers):
        idx = np.where(t_centers == c)[0]
        _, beta, sigma2, inv = reml(np.exp(c), idx)
        se = np.sqrt(np.clip(sigma2 * inv[1, 1], 0, None))
        b = beta[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            z = np.where(se > 0, b / se, np.inf)
        pvals[idx] = 2.0 * stats.norm.sf(np.abs(z))
        coefs[idx] = b
    return pvals, coefs


def fixed_regression_batch(x: np.ndarray, y: np.ndarray):
    """Vectorized pooled OLS (slope + intercept) across all observations.

    ``x``: ``[N]``; ``y``: ``[N, R]``. Matches ``method='fixed'`` (dof n-2).
    Returns ``(pvalues [R], coefs [R])``.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    xc = x - x.mean()
    yc = y - y.mean(axis=0, keepdims=True)
    sxx = np.sum(xc * xc)
    slope = np.einsum("n,nr->r", xc, yc) / sxx
    resid = yc - xc[:, None] * slope[None, :]
    sigma2 = np.sum(resid * resid, axis=0) / (n - 2)
    se = np.sqrt(sigma2 / sxx)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(se > 0, slope / se, np.inf)
    pvals = 2.0 * stats.t.sf(np.abs(t), n - 2)
    return pvals, slope


def one_way_anova_batch(values: np.ndarray, groups: np.ndarray):
    """Vectorized one-way ANOVA F-test p-values.

    ``values``: ``[N, R]`` responses; ``groups``: ``[N]`` labels. Equals
    statsmodels ``anova_lm(OLS('y ~ C(g)'))``'s ``PR(>F)`` per column.
    """
    values = np.asarray(values, dtype=np.float64)
    uniq, inv = np.unique(groups, return_inverse=True)
    k = len(uniq)
    n = values.shape[0]
    grand = values.mean(axis=0)
    ss_between = np.zeros(values.shape[1])
    ss_within = np.zeros(values.shape[1])
    for g in range(k):
        rows = values[inv == g]
        mg = rows.mean(axis=0)
        ss_between += len(rows) * (mg - grand) ** 2
        ss_within += ((rows - mg) ** 2).sum(axis=0)
    df_b, df_w = k - 1, n - k
    with np.errstate(divide="ignore", invalid="ignore"):
        f = (ss_between / df_b) / (ss_within / df_w)
    return stats.f.sf(f, df_b, df_w)
