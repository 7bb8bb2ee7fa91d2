"""Multiblock cohort fetcher: one-time dataset materialization on disk.

A copy of ``multivae_tpu/data/fetchers.py`` (numpy and pandas).

Same on-disk contract as the reference
(``multimodal_cohort/fetchers/multiblock_fetcher.py:15-181``):

* inputs in ``datasetdir``: ``{block}_data.npy``, ``{block}_subjects.npy``,
  ``{block}_names.npy``, ``metadata.tsv``;
* outputs: ``multiblock_idx_{train,test}.npz`` (per-block row-index arrays,
  ``None`` marking a missing block for a subject) and
  ``metadata_{train,test}.tsv``.

Subjects present in every block are split stratified on ``[age, sex, site]``
(age discretized); with ``allow_missing_blocks`` the remaining subjects are
appended to the train set only (``multiblock_fetcher.py:156-159``).
"""

from __future__ import annotations

import os
from collections import namedtuple
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

from .stratify import (
    MultilabelStratifiedShuffleSplit,
    ShuffleSplit,
    discretizer,
)

Item = namedtuple("Item", ["train_input_path", "test_input_path",
                           "train_metadata_path", "test_metadata_path"])

# Per-cohort defaults (fetchers/hbn.py:18-27, fetchers/euaims.py:19-28); the
# synthetic cohort mirrors the HBN shape for driver configs.
DEFAULTS: Dict[str, dict] = {
    name: {
        "multiblock": {
            "test_size": 0.2, "seed": 42,
            "stratify": ["age", "sex", "site"],
            "discretize": ["age"],
            "blocks": ["clinical", "rois"],
            "allow_missing_blocks": False,
        }
    }
    for name in ("hbn", "euaims", "synthetic")
}


def extract_and_order_by(df: pd.DataFrame, column_name: str,
                         values: Sequence) -> pd.DataFrame:
    """Subset rows to ``values`` and order them accordingly
    (``multimodal_cohort/utils.py:5-13``)."""
    df = df[df[column_name].isin(values)]
    order = {v: i for i, v in enumerate(values)}
    df = df.iloc[np.argsort([order[v] for v in df[column_name]],
                            kind="stable")]
    return df.reset_index(drop=True)


def fetch_multiblock(datasetdir: str,
                     blocks: Sequence[str] = ("clinical", "rois"),
                     test_size: Optional[float] = 0.2,
                     stratify: Optional[Sequence[str]] = ("age", "sex", "site"),
                     discretize: Sequence[str] = ("age",),
                     seed: int = 42,
                     allow_missing_blocks: bool = False,
                     overwrite: bool = False, **kwargs) -> Item:
    """Materialize the multiblock index/metadata artifacts (see module doc)."""
    path = os.path.join(datasetdir, "multiblock_idx_train.npz")
    metadata_path = os.path.join(datasetdir, "metadata_train.tsv")
    path_test, metadata_path_test = None, None
    if test_size is None or test_size > 0:
        path_test = os.path.join(datasetdir, "multiblock_idx_test.npz")
        metadata_path_test = os.path.join(datasetdir, "metadata_test.tsv")

    if os.path.isfile(path) and not overwrite:
        return Item(path, path_test, metadata_path, metadata_path_test)

    subj_per_block = {
        block: np.load(os.path.join(datasetdir, f"{block}_subjects.npy"),
                       allow_pickle=True)
        for block in blocks
    }
    common_subjects = sorted(
        set.intersection(*map(set, subj_per_block.values())))
    other_subjects: List = []
    if allow_missing_blocks:
        all_subjects = set.union(*map(set, subj_per_block.values()))
        other_subjects = sorted(all_subjects.difference(common_subjects))

    # per-block row index for each subject; None marks a missing block
    index: Dict[str, np.ndarray] = {}
    for block in blocks:
        subjects = subj_per_block[block].tolist()
        pos = {s: i for i, s in enumerate(subjects)}
        new_index = [pos[s] for s in common_subjects]
        if allow_missing_blocks:
            new_index += [pos.get(s) for s in other_subjects]
        index[block] = np.array(new_index, dtype=object)

    metadata = pd.read_table(os.path.join(datasetdir, "metadata.tsv"))
    common_metadata = extract_and_order_by(metadata, "participant_id",
                                           common_subjects)

    idx_train = list(range(len(common_subjects)))
    idx_test: List[int] = []
    if test_size is not None and test_size > 0:
        if stratify is not None:
            stratify = list(stratify)
            splitter = MultilabelStratifiedShuffleSplit(
                1, test_size=test_size, random_state=seed)
            y = common_metadata[stratify].copy()
            for name in stratify:
                if name in discretize:
                    y[name] = discretizer(y[name].values)
        else:
            splitter = ShuffleSplit(1, test_size=test_size, random_state=seed)
            y = None
        idx_train, idx_test = next(splitter.split(common_subjects, y))
        idx_train, idx_test = list(idx_train), list(idx_test)

    subjects_train = np.array(common_subjects, dtype=object)[idx_train]
    subjects_test = (np.array(common_subjects, dtype=object)[idx_test]
                     if idx_test else np.array([], dtype=object))
    if allow_missing_blocks:
        subjects_train = np.array(subjects_train.tolist() + other_subjects,
                                  dtype=object)
        idx_train = idx_train + list(range(
            len(common_subjects), len(common_subjects) + len(other_subjects)))

    index_train = {b: index[b][idx_train] for b in blocks}
    np.savez(path, **index_train)
    metadata_train = extract_and_order_by(metadata, "participant_id",
                                          subjects_train.tolist())
    metadata_train.to_csv(metadata_path, index=False, sep="\t")
    if test_size is None or test_size > 0:
        index_test = {b: index[b][idx_test] for b in blocks}
        np.savez(path_test, **index_test)
        metadata_test = extract_and_order_by(metadata, "participant_id",
                                             subjects_test.tolist())
        metadata_test.to_csv(metadata_path_test, index=False, sep="\t")
    return Item(path, path_test, metadata_path, metadata_path_test)


def make_fetcher(dataset: str, datasetdir: str):
    """Bind cohort defaults to :func:`fetch_multiblock`
    (``fetchers/hbn.py:make_all_fetchers``)."""
    defaults = DEFAULTS.get(dataset, DEFAULTS["synthetic"])["multiblock"]

    def fetch(**overrides):
        kw = dict(defaults)
        kw.update({k: v for k, v in overrides.items() if v != "defaults"})
        return fetch_multiblock(datasetdir, **kw)

    return fetch
