"""The DAA regressions: closed-form two-level, pooled-OLS and
random-intercept REML fits over every ROI at once.

The regression half of ``multivae_tpu/analysis/stats.py`` (``:197-450``),
in numpy and scipy only: the original module imports pandas at module level
for its RSA and scalar-fit helpers, which the DAA path does not use. Each
design comes in a ``_batch`` form (from the avatar tensor) and a
``_from_stats`` form (from the per-subject sufficient statistics that the
``stats-only`` artifact mode reduces on the device).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import stats


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
