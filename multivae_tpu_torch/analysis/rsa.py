"""Representational Similarity Analysis.

Counterpart of ``multivae_tpu/analysis/rsa.py``. Reference:
``experiments/workflow.py:656-820`` (``rsa_exp``). For each latent space
(joint, clinical_rois subset, per-modality styles) the euclidean
dissimilarity matrix of test-set latents is compared — via Kendall tau —
with per-clinical-score and per-covariate dissimilarity matrices.

The latents come from one ``MultimodalVAE.inference`` of each round's
subjects on the model's device; the dissimilarities and the Kendall taus
are host numpy and scipy. The subjects are drawn from
``numpy.random.default_rng(seed)``, as the JAX package draws them.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import torch

from ..utils.colors import print_result, print_subtitle
from .daa import complete_indices, full_batch
from .stats import data2cmat, fit_rsa, vec2cmat

LATENT_NAMES = ["joint", "clinical_rois", "clinical_style", "rois_style"]


def rsa_noise(seed: int):
    """The reparameterization noise of ``sample_latents=True``: a callable
    ``(model_idx, val_idx, latent_idx, shape) -> float32 CPU tensor`` that
    draws each (model, round, latent) from a ``torch.Generator`` of its own,
    seeded with ``numpy.random.SeedSequence([seed, 7000 * model_idx +
    val_idx, latent_idx])`` (the JAX package's ``fold_in`` chain,
    ``rsa.py:62-81``, takes the same indices). The draw is on the CPU, so a
    card run and a CPU run see the same noise."""
    def draw(model_idx, val_idx, latent_idx, shape):
        state = np.random.SeedSequence(
            [seed, 7000 * model_idx + val_idx, latent_idx]).generate_state(
                1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(state))
        return torch.randn(tuple(shape), generator=gen, dtype=torch.float32)

    return draw


@torch.no_grad()
def run_rsa(experiment, cfg, datasetdir: str, rsadir: str,
            n_validation: int = 1, n_subjects: int = 301,
            sample_latents: bool = False, seed: int = 1037, noise=None):
    """Kendall taus of every latent space against every score and
    covariate; writes ``kendalltau_stats.npy`` ``[n_models, 4,
    n_validation, n_scores + n_covs, 2]`` (tau, p-value),
    ``latent_dissimilarity.npy``, ``scores_dissimilarity.npy`` and one
    ``kendalltau_<latent>.tsv`` summary per latent space; returns the taus.

    ``experiment`` holds the models and, loaded, their datasets
    (:func:`multivae_tpu_torch.train.experiment.load_trained`); the
    forward runs on the experiment's device. With ``sample_latents`` each
    latent is ``mu + eps * exp(logvar / 2)`` with ``eps`` from ``noise``
    (default :func:`rsa_noise` of ``seed``), a callable ``(model_idx,
    val_idx, latent_idx, shape)``.
    """
    n_models = cfg.num_models
    clinical_names = np.load(os.path.join(datasetdir, "clinical_names.npy"),
                             allow_pickle=True)
    cov_names = ["age", "sex", "site"]
    if cfg.dataset == "euaims":
        cov_names.append("fsiq")
    categorical_covs = ["sex", "site"]
    n_scores = len(clinical_names)
    if noise is None:
        noise = rsa_noise(seed)

    kendalltaus = np.zeros((n_models, len(LATENT_NAMES), n_validation,
                            n_scores + len(cov_names), 2))
    latent_dis, scores_dis = [], []
    np_rng = np.random.default_rng(seed)

    for model_idx in range(n_models):
        testset = experiment.member_datasets(model_idx)[1]
        model = experiment.models[model_idx]
        latent_dis.append([])
        scores_dis.append([])
        test_complete = complete_indices(testset)
        for val_idx in range(n_validation):
            sel = np_rng.choice(test_complete,
                                size=min(n_subjects, len(test_complete)),
                                replace=False)
            data, metadata = full_batch(testset, sel, experiment.device)
            latents_all = model.inference(data, sample=sample_latents)
            for latent_idx, latent_name in enumerate(LATENT_NAMES):
                if latent_name == "joint":
                    lat = latents_all["joint"]
                elif "style" in latent_name:
                    lat = latents_all["modalities"][latent_name]
                else:
                    lat = latents_all["subsets"][latent_name]
                if lat[0] is None:
                    continue
                if sample_latents:
                    eps = noise(model_idx, val_idx, latent_idx,
                                lat[0].shape).to(lat[0].device)
                    z = lat[0] + eps * torch.exp(0.5 * lat[1])
                else:
                    z = lat[0]
                z = z.cpu().numpy()
                cmat = data2cmat(z)
                latent_dis[model_idx].append(cmat)
                scores_cmats = []
                clinical = data["clinical"].cpu().numpy()
                for score_idx in range(n_scores):
                    score_cmat = vec2cmat(clinical[:, score_idx])
                    scores_cmats.append(score_cmat)
                    tau, pval = fit_rsa(cmat, score_cmat)
                    kendalltaus[model_idx, latent_idx, val_idx,
                                score_idx] = (tau, pval)
                for cov_idx, name in enumerate(cov_names):
                    score_cmat = vec2cmat(metadata[name].to_numpy(),
                                          categorical=name in categorical_covs)
                    scores_cmats.append(score_cmat)
                    tau, pval = fit_rsa(cmat, score_cmat)
                    kendalltaus[model_idx, latent_idx, val_idx,
                                n_scores + cov_idx] = (tau, pval)
                scores_dis[model_idx].append(np.asarray(scores_cmats))

    latent_dis = np.asarray(latent_dis)
    scores_dis = np.asarray(scores_dis)
    np.save(os.path.join(rsadir, "kendalltau_stats.npy"), kendalltaus)
    np.save(os.path.join(rsadir, "latent_dissimilarity.npy"), latent_dis)
    np.save(os.path.join(rsadir, "scores_dissimilarity.npy"), scores_dis)
    print_result(f"kendall tau statistics: "
                 f"{os.path.join(rsadir, 'kendalltau_stats.npy')}")

    print_subtitle("Summarize Kendall tau statstics...")
    for latent_idx, latent_name in enumerate(LATENT_NAMES):
        data_out = {"score": [], "pval": [], "pval_std": [], "r": [],
                    "r_std": []}
        names = list(clinical_names) + cov_names
        for i, name in enumerate(names):
            data_out["score"].append(name)
            data_out["pval"].append(
                np.mean(kendalltaus[:, latent_idx, :, i, 1]))
            data_out["pval_std"].append(
                np.std(kendalltaus[:, latent_idx, :, i, 1]))
            data_out["r"].append(
                np.mean(kendalltaus[:, latent_idx, :, i, 0]))
            data_out["r_std"].append(
                np.std(kendalltaus[:, latent_idx, :, i, 0]))
        df = pd.DataFrame.from_dict(data_out)
        summary_file = os.path.join(rsadir, f"kendalltau_{latent_name}.tsv")
        df.to_csv(summary_file, sep="\t", index=False)
        print_result(f"kendall tau summary: {summary_file}")
    return kendalltaus
