"""Synthetic two-modality cohort generator.

A copy of ``multivae_tpu/data/synthetic.py``: the same arrays for the same
seed.

Writes the same on-disk artifacts a real cohort directory provides
(``{block}_data.npy``, ``{block}_subjects.npy``, ``{block}_names.npy``,
``metadata.tsv``), shaped like the HBN config (clinical 7-d + ROI 444-d;
``BASELINE.json`` configs). Ground truth: a shared low-rank factor drives both
blocks and a known sparse score→ROI linear map is injected so DAA has a
recoverable signal.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import pandas as pd

ROI_METRICS = ("thickness", "area", "meancurv")


def make_synthetic_cohort(datasetdir: str, n_subjects: int = 400,
                          n_scores: int = 7, n_rois: int = 444,
                          missing_rate: float = 0.2, latent_rank: int = 4,
                          n_sites: int = 3, seed: int = 0,
                          signal_strength: float = 1.0) -> Dict[str, np.ndarray]:
    """Generate and write a synthetic cohort; returns the ground-truth map.

    ``missing_rate`` of subjects lack the rois block (they land in train only
    when ``allow_missing_blocks``); the returned ``score_to_roi`` matrix
    ``[n_scores, n_rois]`` is the injected linear effect DAA should recover.
    """
    os.makedirs(datasetdir, exist_ok=True)
    rng = np.random.default_rng(seed)

    subjects = np.array([f"sub-{i:05d}" for i in range(n_subjects)],
                        dtype=object)
    age = rng.uniform(6.0, 18.0, n_subjects)
    sex = rng.integers(0, 2, n_subjects)
    site = rng.integers(0, n_sites, n_subjects)
    asd = rng.integers(1, 3, n_subjects)  # labels 1/2; dataset maps to 0/1

    z = rng.normal(size=(n_subjects, latent_rank))
    w_clin = rng.normal(size=(latent_rank, n_scores)) * 0.8
    clinical = (z @ w_clin
                + 0.05 * age[:, None]
                + 0.3 * rng.normal(size=(n_subjects, n_scores)))

    # sparse score->roi ground truth: each of the first 3 scores drives a
    # disjoint roi block
    score_to_roi = np.zeros((n_scores, n_rois))
    block = max(n_rois // 12, 1)
    for s in range(min(3, n_scores)):
        cols = slice(s * block, (s + 1) * block)
        score_to_roi[s, cols] = signal_strength * rng.uniform(
            0.5, 1.5, block) * rng.choice([-1, 1], block)

    w_rois = rng.normal(size=(latent_rank, n_rois)) * 0.5
    rois_data = (z @ w_rois
                 + clinical @ score_to_roi
                 + 0.1 * site[:, None] * rng.normal(size=(1, n_rois))
                 + 0.3 * rng.normal(size=(n_subjects, n_rois)))

    # missing rois block for a fraction of subjects
    n_missing = int(round(missing_rate * n_subjects))
    missing = rng.choice(n_subjects, size=n_missing, replace=False)
    has_rois = np.ones(n_subjects, dtype=bool)
    has_rois[missing] = False

    clinical_names = np.array(
        [f"score_{i}" for i in range(n_scores)], dtype=object)
    rois_names = np.array(
        [f"roi{i // len(ROI_METRICS):03d}_{ROI_METRICS[i % len(ROI_METRICS)]}"
         for i in range(n_rois)], dtype=object)

    np.save(os.path.join(datasetdir, "clinical_data.npy"),
            clinical.astype(np.float32))
    np.save(os.path.join(datasetdir, "clinical_subjects.npy"), subjects)
    np.save(os.path.join(datasetdir, "clinical_names.npy"), clinical_names)
    np.save(os.path.join(datasetdir, "rois_data.npy"),
            rois_data[has_rois].astype(np.float32))
    np.save(os.path.join(datasetdir, "rois_subjects.npy"), subjects[has_rois])
    np.save(os.path.join(datasetdir, "rois_names.npy"), rois_names)

    metadata = pd.DataFrame({
        "participant_id": subjects,
        "age": age,
        "sex": np.where(sex == 0, "M", "F"),
        "site": np.array([f"site{chr(65 + s)}" for s in site], dtype=object),
        "asd": asd,
    })
    metadata.to_csv(os.path.join(datasetdir, "metadata.tsv"), index=False,
                    sep="\t")
    return {"score_to_roi": score_to_roi, "has_rois": has_rois,
            "latent": z}
