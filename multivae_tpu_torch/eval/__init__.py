"""Evaluation metrics: IWAE likelihoods, PRD, FID, representation probes,
coherence (the counterpart of ``multivae_tpu/eval``)."""

from .coherence import calculate_coherence, test_generation, train_modality_classifiers
from .likelihood import batch_likelihoods, estimate_likelihoods
from .prd import (
    compute_prd,
    compute_prd_from_embedding,
    plot,
    prd_to_max_f_beta_pair,
)
from .representation import test_clf_lr_all_subsets, train_clf_lr_all_subsets
from .sample_quality import (
    calc_fid_scores,
    calc_prd_score,
    calculate_fid_from_embeddings,
    calculate_fid_given_paths,
    calculate_frechet_distance,
    load_embedding,
)

__all__ = [
    "batch_likelihoods",
    "calculate_coherence",
    "test_generation",
    "train_modality_classifiers",
    "calc_fid_scores",
    "calc_prd_score",
    "calculate_fid_from_embeddings",
    "calculate_fid_given_paths",
    "calculate_frechet_distance",
    "compute_prd",
    "load_embedding",
    "compute_prd_from_embedding",
    "estimate_likelihoods",
    "plot",
    "prd_to_max_f_beta_pair",
    "test_clf_lr_all_subsets",
    "train_clf_lr_all_subsets",
]
