"""Latent-representation classification probes.

Counterpart of ``multivae_tpu/eval/representation.py``: a logistic-
regression probe is fit on each subset's latent posterior means on the
train split's complete samples and scored by accuracy on the test split's.
The probe is the numpy stand-in for scikit-learn's
(:class:`multivae_tpu_torch.eval.estimators.LogisticRegression`).

Noise: none. The latents are posterior means from ``inference``, whose
mixture selection is a fixed partition (the JAX package hands it a key it
does not draw from).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .estimators import LogisticRegression


@torch.no_grad()
def _subset_latents(exp, dataset, model_idx: int):
    model = exp.models[model_idx]
    dev = next(model.parameters()).device
    data, labels, _ = dataset.gather(dataset.idx_per_modality_subset[-1])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    latents = model.inference(batch)
    # key-sorted, as the jitted JAX inference returns its dicts
    feats = {s: mu.cpu().numpy()
             for s, (mu, _) in sorted(latents["subsets"].items())}
    return feats, np.asarray(labels)


def train_clf_lr_all_subsets(exp, model_idx: int = 0):
    """One probe per subset on the train latents: ``{subset: clf}``. With
    more than ``cfg.num_training_samples_lr`` rows the probe trains on that
    many rows drawn with replacement by ``default_rng(cfg.seed)``."""
    cfg = exp.cfg
    feats, labels = _subset_latents(exp, exp.member_datasets(model_idx)[0],
                                    model_idx)
    n_cap = getattr(cfg, "num_training_samples_lr", None)
    if n_cap and len(labels) > n_cap:
        sel = np.random.default_rng(cfg.seed).integers(len(labels),
                                                       size=n_cap)
        labels = labels[sel]
        feats = {s: x[sel] for s, x in feats.items()}
    if len(np.unique(labels)) < 2:
        return {}
    return {s_key: LogisticRegression(max_iter=1000).fit(x, labels)
            for s_key, x in feats.items()}


def test_clf_lr_all_subsets(exp, clfs, model_idx: int = 0) -> Dict[str, float]:
    """Accuracy of each subset probe on the test split."""
    feats, labels = _subset_latents(exp, exp.member_datasets(model_idx)[1],
                                    model_idx)
    return {s_key: float(clf.score(feats[s_key], labels))
            for s_key, clf in clfs.items() if s_key in feats}


# the JAX package's function name, not collected by pytest as a test
test_clf_lr_all_subsets.__test__ = False
