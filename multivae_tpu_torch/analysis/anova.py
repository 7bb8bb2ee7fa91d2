"""Site-effect ANOVA on DAA per-subject regression coefficients.

A copy of ``multivae_tpu/analysis/anova.py`` (host numpy and scipy).
Reference: ``experiments/workflow.py:542-654`` (``anova_exp``): for every
(model, validation round, score, ROI) fit ``beta ~ C(site)`` and record the
F-test p-value. Here the per-ROI loop collapses into one vectorized one-way
ANOVA per (model, round, score) — identical F statistics, ~n_rois× fewer
passes.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.colors import print_result, print_text
from .stats import one_way_anova_batch


def run_anova(resdir: str, clinical_names, rois_names, n_models: int,
              n_validation: int, trust_level: float = 0.75,
              vote_prop: float = 1.0):
    n_scores = len(clinical_names)
    n_rois = len(rois_names)
    all_coefs = np.load(os.path.join(resdir, "all_coefs.npy"),
                        allow_pickle=True)
    pvalues = np.load(os.path.join(resdir, "pvalues.npy"))
    if n_models == 1:
        all_coefs = all_coefs[np.newaxis]
        pvalues = pvalues[np.newaxis]

    significativity_thr = 0.05 / n_rois / n_scores
    vote_level = n_validation * trust_level
    idx_sign = ((pvalues < significativity_thr).sum(axis=1) >= vote_level)
    idx_sign = idx_sign.sum(0) >= vote_prop * n_models

    anova_pvalues = np.zeros((n_models, n_validation, n_scores, n_rois))
    for model_idx in range(n_models):
        for val_idx in range(n_validation):
            for score_idx in range(n_scores):
                rec = np.asarray(all_coefs[model_idx][val_idx][score_idx])
                sites = rec[:, 1]
                betas = rec[:, 2:].astype(np.float64)
                anova_pvalues[model_idx, val_idx, score_idx] = (
                    one_way_anova_batch(betas, sites))

    print_result(f"results ANOVA: {anova_pvalues.shape}")
    print_text(f"min/max: {anova_pvalues.min()}, {anova_pvalues.max()}")
    print_text("mean over (models, rounds) min/max: "
               f"{anova_pvalues.mean((0, 1)).min()}, "
               f"{anova_pvalues.mean((0, 1)).max()}")
    if idx_sign.any():
        sig = anova_pvalues[:, :, idx_sign]
        print_text(f"significant-assoc min/max: {sig.min()}, {sig.max()}")
    np.save(os.path.join(resdir, "anova_pvalues.npy"), anova_pvalues)
    return anova_pvalues
