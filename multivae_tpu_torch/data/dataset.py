"""Datasets and the data manager.

A copy of ``multivae_tpu/data/dataset.py`` (numpy and pandas).

Reference: ``multimodal_cohort/dataset.py:15-272``. The TPU-first change is
vectorized batch materialization: :meth:`MultimodalDataset.gather` fancy-
indexes the memmapped block arrays and applies scalers to whole batches, so
the host never loops per item (the reference pays a per-item ``__getitem__`` +
torch collate + 8 worker processes; ``run_epochs.py:157``).
"""

from __future__ import annotations

import os
from itertools import chain, combinations
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

from .fetchers import DEFAULTS, make_fetcher
from .stratify import (
    MultilabelStratifiedShuffleSplit,
    ShuffleSplit,
    discretizer,
)


class MultimodalDataset:
    """Map-style multiblock dataset over the fetcher's index artifacts
    (``dataset.py:15-147``)."""

    def __init__(self, idx_path: str, metadata_path: Optional[str] = None,
                 indices: Optional[np.ndarray] = None, transform=None,
                 on_the_fly_transform=None, overwrite: bool = False):
        self.idx_per_mod = dict(np.load(idx_path, allow_pickle=True))
        self.modalities = list(self.idx_per_mod)
        self.metadata = (pd.read_table(metadata_path) if metadata_path
                         else None)
        n_samples = [len(self.idx_per_mod[key]) for key in self.modalities]
        if len(set(n_samples)) > 1:
            raise ValueError(
                "All modalities do not have the same number of samples.")
        if self.metadata is not None and n_samples[0] != len(self.metadata):
            raise ValueError(
                "The data and metadata do not have the same number of "
                "samples.")
        self.n_samples = n_samples[0]
        self.indices = (np.asarray(indices) if indices is not None else None)

        datasetdir = os.path.dirname(idx_path)
        self.datasetdir = datasetdir

        # integer row index + presence mask per modality (vectorized view of
        # the reference's object arrays with None)
        self._row_idx, self._present = {}, {}
        for mod in self.modalities:
            raw = self.idx_per_mod[mod]
            present = np.array([v is not None for v in raw])
            rows = np.array([int(v) if v is not None else 0 for v in raw])
            self._row_idx[mod] = rows
            self._present[mod] = present

        # offline transform (residualizer) cache:
        # {mod}_data_transformed.npy (dataset.py:63-90)
        self.data: Dict[str, np.ndarray] = {}
        for mod in self.modalities:
            mod_path = os.path.join(datasetdir, f"{mod}_data.npy")
            if transform is not None and (
                    not isinstance(transform, dict) or mod in transform):
                tpath = os.path.join(datasetdir,
                                     f"{mod}_data_transformed.npy")
                if overwrite or not os.path.exists(tpath):
                    data = np.load(mod_path, mmap_mode="r")
                    fn = (transform[mod] if isinstance(transform, dict)
                          else transform)
                    names = np.load(
                        os.path.join(datasetdir, f"{mod}_names.npy"),
                        allow_pickle=True)
                    names = [str(c).replace("&", "_").replace("-", "_")
                             for c in names]
                    meta_path = os.path.join(datasetdir,
                                             f"{mod}_metadata.tsv")
                    if os.path.exists(meta_path):
                        df = pd.concat(
                            [pd.read_table(meta_path),
                             pd.DataFrame(np.asarray(data), columns=names)],
                            axis=1)
                        out = fn(df)[names].values
                    else:
                        out = fn(np.asarray(data))
                    np.save(tpath, out)
                mod_path = tpath
            self.data[mod] = np.load(mod_path, mmap_mode="r")

        self.on_the_fly_transform = on_the_fly_transform

        self.modality_subsets = list(chain.from_iterable(
            combinations(self.modalities, n)
            for n in range(1, len(self.modalities) + 1)))
        self.idx_per_modality_subset = self._compute_idx_per_modality_subset()

    def __len__(self):
        if self.indices is not None:
            return len(self.indices)
        return self.n_samples

    def _true_idx(self, idx):
        return self.indices[idx] if self.indices is not None else idx

    def _compute_idx_per_modality_subset(self) -> List[List[int]]:
        """Which local indices carry exactly which modality subset
        (``dataset.py:128-144``)."""
        out: List[List[int]] = [[] for _ in self.modality_subsets]
        for idx in range(len(self)):
            true_idx = self._true_idx(idx)
            present = tuple(m for m in self.modalities
                            if self._present[m][true_idx])
            for sub_idx, subset in enumerate(self.modality_subsets):
                if set(subset) == set(present):
                    out[sub_idx].append(idx)
                    break
        return out

    def get_modality_proportions(self):
        return [len(s) / len(self) for s in self.idx_per_modality_subset]

    # ------------------------------------------------------------- item API
    def __getitem__(self, idx):
        """Single-item access, reference contract:
        ``({mod: vector}, label, metadata_dict)`` with absent modalities
        dropped from the dict (``dataset.py:101-126``)."""
        true_idx = self._true_idx(idx)
        ret = {}
        for mod in self.modalities:
            if self._present[mod][true_idx]:
                x = np.asarray(self.data[mod][self._row_idx[mod][true_idx]],
                               dtype=np.float32)
                ret[mod] = self._apply_otf(mod, x[None])[0]
        label = 0
        metadata = {}
        if self.metadata is not None:
            metadata = self.metadata.iloc[true_idx].to_dict()
            if "asd" in metadata:
                label = metadata["asd"] - 1
        return ret, label, metadata

    def _apply_otf(self, mod, batch: np.ndarray) -> np.ndarray:
        tf = self.on_the_fly_transform
        if tf is None:
            return batch
        if isinstance(tf, dict):
            if mod in tf:
                return np.asarray(tf[mod].transform(batch), dtype=np.float32)
            return batch
        return np.asarray(tf.transform(batch), dtype=np.float32)

    # ------------------------------------------------------------ batch API
    def gather(self, idxs: Sequence[int]):
        """Vectorized batch materialization.

        Returns ``(data: {mod: [B, D] float32}, labels: [B], metadata_df)``
        with a modality included only when present for *every* row (batches
        from :class:`MissingModalitySampler` are subset-homogeneous).
        """
        idxs = np.asarray(idxs)
        true = (self.indices[idxs] if self.indices is not None else idxs)
        data = {}
        for mod in self.modalities:
            if self._present[mod][true].all():
                rows = self._row_idx[mod][true]
                batch = np.asarray(self.data[mod][rows], dtype=np.float32)
                data[mod] = self._apply_otf(mod, batch)
        labels = np.zeros(len(idxs), dtype=np.int64)
        metadata = None
        if self.metadata is not None:
            metadata = self.metadata.iloc[true].reset_index(drop=True)
            if "asd" in metadata.columns:
                labels = metadata["asd"].to_numpy() - 1
        return data, labels, metadata


class DataManager:
    """Builds train/test (and validation-fold) datasets
    (``dataset.py:150-272``)."""

    available_datasets = ["hbn", "euaims", "synthetic"]

    def __init__(self, dataset: str, datasetdir: str,
                 modalities: Sequence[str], transform=None,
                 on_the_fly_transform=None, test_size="defaults",
                 validation: Optional[int] = None, val_size: float = 0.2,
                 stratify="defaults", discretize="defaults", seed="defaults",
                 overwrite: bool = False, **fetcher_kwargs):
        if dataset not in self.available_datasets:
            raise ValueError(f"{dataset} dataset is not available")
        defaults = DEFAULTS[dataset]["multiblock"]
        if test_size == "defaults":
            test_size = defaults["test_size"]
        if not (test_size is None or 0 <= test_size < 1):
            raise ValueError("The test size must be in [0, 1) or None")
        if stratify == "defaults":
            stratify = defaults["stratify"]
        if discretize == "defaults":
            discretize = defaults["discretize"]
        if seed == "defaults":
            seed = defaults["seed"]
        if seed != int(seed):
            raise ValueError("The seed must be an integer")

        self.dataset = dataset
        self.modalities = list(modalities)
        self.test_size = test_size
        os.makedirs(datasetdir, exist_ok=True)

        fetch = make_fetcher(dataset, datasetdir)
        self.fetcher = fetch(blocks=self.modalities, seed=seed,
                             stratify=stratify, discretize=discretize,
                             test_size=test_size, overwrite=overwrite,
                             **fetcher_kwargs)

        idx_path = self.fetcher.train_input_path
        metadata_path = self.fetcher.train_metadata_path

        if validation is not None:
            assert isinstance(validation, int) and validation > 0
            idx_per_mod = np.load(idx_path, allow_pickle=True)
            metadata = pd.read_table(metadata_path)
            mods = list(idx_per_mod)
            full_indices, not_full_indices = [], []
            for idx in range(len(idx_per_mod[mods[0]])):
                if any(ind[idx] is None for ind in idx_per_mod.values()):
                    not_full_indices.append(idx)
                else:
                    full_indices.append(idx)
            self.train_dataset = {}
            if stratify is not None:
                splitter = MultilabelStratifiedShuffleSplit(
                    validation, test_size=val_size, random_state=seed)
                y = metadata[list(stratify)].iloc[full_indices].copy()
                for name in stratify:
                    if name in discretize:
                        y[name] = discretizer(y[name].values)
            else:
                splitter = ShuffleSplit(validation, test_size=val_size,
                                        random_state=seed)
                y = None
            for fold, (train_idx, valid_idx) in enumerate(
                    splitter.split(full_indices, y)):
                # positions are into full_indices; map back then append the
                # missing-block subjects to train only (dataset.py:240)
                train_idx = np.array(
                    [full_indices[i] for i in train_idx] + not_full_indices)
                valid_idx = np.array([full_indices[i] for i in valid_idx])
                self.train_dataset[fold] = {
                    "train": MultimodalDataset(
                        idx_path, metadata_path, train_idx, transform,
                        on_the_fly_transform, overwrite),
                    "valid": MultimodalDataset(
                        idx_path, metadata_path, valid_idx, transform,
                        on_the_fly_transform, overwrite),
                    "train_idx": train_idx,
                    "valid_idx": valid_idx,
                }
            self.train_dataset["all"] = MultimodalDataset(
                idx_path, metadata_path, None, transform,
                on_the_fly_transform, overwrite)
        else:
            self.train_dataset = MultimodalDataset(
                idx_path, metadata_path, None, transform,
                on_the_fly_transform, overwrite)

        if test_size is None or test_size > 0:
            self.test_dataset = MultimodalDataset(
                self.fetcher.test_input_path,
                self.fetcher.test_metadata_path, None, transform,
                on_the_fly_transform, overwrite)

    def __getitem__(self, key):
        if key not in ["train", "test"]:
            raise ValueError("The key must be 'train' or 'test'")
        if key == "test" and self.test_size == 0:
            raise ValueError("This dataset does not have test data")
        return self.train_dataset if key == "train" else self.test_dataset
