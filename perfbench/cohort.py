"""The benchmark's inputs made from the seed: the synthetic cohort on disk,
and the DAA's cohort arrays.

:func:`make_synthetic_cohort` is a copy of the port's
``multivae_tpu_torch/data/synthetic.py`` generator (HBN-shaped: clinical 7
+ ROIs 444, a shared low-rank factor, a sparse score -> ROI map, a share
of subjects without the ROI block), kept here so that the inputs do not
depend on the program under test. Both the program and the reference read
the files it writes.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

ROI_METRICS = ("thickness", "area", "meancurv")


def roi_names(n_rois: int) -> np.ndarray:
    return np.array(
        [f"roi{i // len(ROI_METRICS):03d}_{ROI_METRICS[i % len(ROI_METRICS)]}"
         for i in range(n_rois)], dtype=object)


def make_cohort_arrays(n_subjects: int, n_scores: int, n_rois: int,
                       missing_rate: float, seed: int,
                       latent_rank: int = 4, n_sites: int = 3,
                       signal_strength: float = 1.0) -> Dict[str, np.ndarray]:
    """The cohort as arrays: ``clinical [N, S]`` and ``rois [N, R]``
    float32 (every subject's row; ``has_rois`` says whose are kept),
    ``subjects``, ``age``, ``sex``, ``site``, ``asd``."""
    rng = np.random.default_rng(seed)
    subjects = np.array([f"sub-{i:05d}" for i in range(n_subjects)],
                        dtype=object)
    age = rng.uniform(6.0, 18.0, n_subjects)
    sex = rng.integers(0, 2, n_subjects)
    site = rng.integers(0, n_sites, n_subjects)
    asd = rng.integers(1, 3, n_subjects)

    z = rng.normal(size=(n_subjects, latent_rank))
    w_clin = rng.normal(size=(latent_rank, n_scores)) * 0.8
    clinical = (z @ w_clin + 0.05 * age[:, None]
                + 0.3 * rng.normal(size=(n_subjects, n_scores)))
    score_to_roi = np.zeros((n_scores, n_rois))
    block = max(n_rois // 12, 1)
    for s in range(min(3, n_scores)):
        cols = slice(s * block, (s + 1) * block)
        score_to_roi[s, cols] = signal_strength * rng.uniform(
            0.5, 1.5, block) * rng.choice([-1, 1], block)
    w_rois = rng.normal(size=(latent_rank, n_rois)) * 0.5
    rois = (z @ w_rois + clinical @ score_to_roi
            + 0.1 * site[:, None] * rng.normal(size=(1, n_rois))
            + 0.3 * rng.normal(size=(n_subjects, n_rois)))
    n_missing = int(round(missing_rate * n_subjects))
    missing = rng.choice(n_subjects, size=n_missing, replace=False)
    has_rois = np.ones(n_subjects, dtype=bool)
    has_rois[missing] = False
    return {"clinical": clinical.astype(np.float32),
            "rois": rois.astype(np.float32), "has_rois": has_rois,
            "subjects": subjects, "age": age, "sex": sex, "site": site,
            "asd": asd}


def make_synthetic_cohort(datasetdir: str, n_subjects: int, n_scores: int,
                          n_rois: int, missing_rate: float, seed: int
                          ) -> Dict[str, np.ndarray]:
    """Write the cohort in the data layer's on-disk form
    (``{block}_data.npy``, ``{block}_subjects.npy``, ``{block}_names.npy``,
    ``metadata.tsv``); returns its arrays."""
    import pandas as pd

    arr = make_cohort_arrays(n_subjects, n_scores, n_rois, missing_rate,
                             seed)
    os.makedirs(datasetdir, exist_ok=True)
    keep = arr["has_rois"]
    subjects = arr["subjects"]
    np.save(os.path.join(datasetdir, "clinical_data.npy"), arr["clinical"])
    np.save(os.path.join(datasetdir, "clinical_subjects.npy"), subjects)
    np.save(os.path.join(datasetdir, "clinical_names.npy"),
            np.array([f"score_{i}" for i in range(n_scores)], dtype=object))
    np.save(os.path.join(datasetdir, "rois_data.npy"), arr["rois"][keep])
    np.save(os.path.join(datasetdir, "rois_subjects.npy"), subjects[keep])
    np.save(os.path.join(datasetdir, "rois_names.npy"), roi_names(n_rois))
    pd.DataFrame({
        "participant_id": subjects,
        "age": arr["age"],
        "sex": np.where(arr["sex"] == 0, "M", "F"),
        "site": np.array([f"site{chr(65 + s)}" for s in arr["site"]],
                         dtype=object),
        "asd": arr["asd"],
    }).to_csv(os.path.join(datasetdir, "metadata.tsv"), index=False,
              sep="\t")
    return arr


def daa_cohort_arrays(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """The DAA's inputs: the complete subjects (both blocks), split from
    the seed into a train part and ``daa_test_share`` of test subjects,
    each block standardized by the train part's mean and population
    standard deviation. Returns ``train_clinical``, ``test_clinical``,
    ``test_rois``, ``test_metadata`` (``participant_id``, ``site``) and
    the names."""
    arr = make_cohort_arrays(cfg["n_subjects"], cfg["n_scores"],
                             cfg["n_rois"], cfg["missing_rate"], seed)
    complete = np.flatnonzero(arr["has_rois"])
    order = np.random.default_rng([seed, 1]).permutation(complete)
    n_test = int(round(cfg["daa_test_share"] * len(complete)))
    test, train = np.sort(order[:n_test]), np.sort(order[n_test:])
    out = {}
    for block in ("clinical", "rois"):
        x = arr[block]
        mean = x[train].astype(np.float64).mean(axis=0)
        std = x[train].astype(np.float64).std(axis=0)
        scaled = ((x - mean) / std).astype(np.float32)
        out["train_" + block] = scaled[train]
        out["test_" + block] = scaled[test]
    site = np.array([f"site{chr(65 + s)}" for s in arr["site"]], dtype=object)
    out["test_metadata"] = np.stack([arr["subjects"][test], site[test]],
                                    axis=1)
    out["metadata_columns"] = ["participant_id", "site"]
    out["clinical_names"] = np.array(
        [f"score_{i}" for i in range(cfg["n_scores"])], dtype=object)
    out["rois_names"] = roi_names(cfg["n_rois"])
    return out
