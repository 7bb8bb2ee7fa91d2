"""Precision-recall distributions (PRD) for generative models.

Implements the PRD algorithm of Sajjadi et al., "Assessing Generative Models
via Precision and Recall" (NeurIPS 2018), which the reference vendors from
Google compare_gan (``experiments/prd_score/prd_score.py``): cluster the union
of real and generated embeddings, histogram cluster memberships into two
discrete distributions, and sweep the likelihood ratio ``lambda = tan(theta)``
to trace the precision/recall curve

    alpha(lambda) = sum_i min(lambda * p_i, q_i)
    beta(lambda)  = alpha(lambda) / lambda

(written here from the paper's definitions, not ported from the vendored
file).

A copy of ``multivae_tpu/eval/prd.py`` (numpy); the k-means is the numpy
stand-in for scikit-learn's (:class:`multivae_tpu_torch.eval.estimators.
KMeans`).
"""

from __future__ import annotations

import numpy as np

from .estimators import KMeans


def compute_prd(eval_dist: np.ndarray, ref_dist: np.ndarray,
                num_angles: int = 1001, epsilon: float = 1e-10):
    """PRD curve from two discrete distributions over the same support.

    Returns ``(precision, recall)`` arrays of length ``num_angles``.
    """
    if not (3 <= num_angles <= 1_000_000):
        raise ValueError("num_angles must be in [3, 1e6].")
    eval_dist = np.asarray(eval_dist, dtype=np.float64)
    ref_dist = np.asarray(ref_dist, dtype=np.float64)
    if np.any(eval_dist < 0) or np.any(ref_dist < 0):
        raise ValueError("distributions must be non-negative")

    angles = np.linspace(epsilon, np.pi / 2 - epsilon, num_angles)
    lam = np.tan(angles)[:, None]                       # [A, 1]
    precision = np.minimum(lam * ref_dist[None, :],
                           eval_dist[None, :]).sum(axis=1)
    recall = precision / lam[:, 0]
    return np.clip(precision, 0, 1), np.clip(recall, 0, 1)


def _cluster_histograms(eval_data: np.ndarray, ref_data: np.ndarray,
                        num_clusters: int, seed: int):
    combined = np.concatenate([eval_data, ref_data], axis=0)
    labels = KMeans(n_clusters=num_clusters, n_init=10,
                    random_state=seed).fit_predict(combined)
    eval_labels = labels[:len(eval_data)]
    ref_labels = labels[len(eval_data):]
    eval_dist = np.histogram(eval_labels, bins=num_clusters,
                             range=(0, num_clusters), density=True)[0]
    ref_dist = np.histogram(ref_labels, bins=num_clusters,
                            range=(0, num_clusters), density=True)[0]
    eval_dist = eval_dist / max(eval_dist.sum(), 1e-12)
    ref_dist = ref_dist / max(ref_dist.sum(), 1e-12)
    return eval_dist, ref_dist


def compute_prd_from_embedding(eval_data: np.ndarray, ref_data: np.ndarray,
                               num_clusters: int = 20,
                               num_angles: int = 1001, num_runs: int = 10,
                               enforce_balance: bool = True, seed: int = 0):
    """PRD from embedding vectors: k-means binning averaged over runs."""
    eval_data = np.asarray(eval_data, dtype=np.float64)
    ref_data = np.asarray(ref_data, dtype=np.float64)
    if enforce_balance and len(eval_data) != len(ref_data):
        n = min(len(eval_data), len(ref_data))
        rng = np.random.default_rng(seed)
        eval_data = eval_data[rng.choice(len(eval_data), n, replace=False)]
        ref_data = ref_data[rng.choice(len(ref_data), n, replace=False)]
    precisions, recalls = [], []
    for run in range(num_runs):
        e_dist, r_dist = _cluster_histograms(eval_data, ref_data,
                                             num_clusters, seed + run)
        p, r = compute_prd(e_dist, r_dist, num_angles)
        precisions.append(p)
        recalls.append(r)
    return np.mean(precisions, axis=0), np.mean(recalls, axis=0)


def _prd_to_f_beta(precision, recall, beta: float = 1.0,
                   epsilon: float = 1e-10):
    """Maximum F_beta over the curve."""
    precision = np.asarray(precision)
    recall = np.asarray(recall)
    f = (1 + beta ** 2) * precision * recall / (
        beta ** 2 * precision + recall + epsilon)
    return float(f.max())


def prd_to_max_f_beta_pair(precision, recall, beta: float = 8.0):
    """(F_beta, F_1/beta) summary pair — recall- and precision-weighted."""
    return (_prd_to_f_beta(precision, recall, beta),
            _prd_to_f_beta(precision, recall, 1.0 / beta))


def plot(precision_recall_pairs, labels=None, out_path=None,
         legend_loc="lower left", dpi=150):
    """PRD curve plot (API parity with the vendored module's ``plot``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(3.5, 3.5), dpi=dpi)
    ax = fig.add_subplot(111)
    for i, (precision, recall) in enumerate(precision_recall_pairs):
        label = labels[i] if labels is not None else None
        ax.plot(recall, precision, label=label, alpha=0.6, linewidth=3)
    ax.set_xlim([0, 1])
    ax.set_ylim([0, 1])
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    if labels is not None:
        ax.legend(loc=legend_loc)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, bbox_inches="tight", dpi=dpi)
    return fig
