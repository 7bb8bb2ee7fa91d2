"""Subset-homogeneous batch sampling.

A copy of ``multivae_tpu/data/sampler.py``: the same index lists for the
same seed.

Reference: ``multimodal_cohort/dataset.py:275-354`` (``MissingModalitySampler``).
Every emitted batch contains samples sharing the same modality subset; batches
are drawn randomly within each subset group, full batches are yielded before
incomplete ones, and stratified within-subset batching is available. Batch
homogeneity is what keeps the number of compiled presence patterns tiny on
TPU.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from .stratify import MultilabelStratifiedKFold, discretizer


class MissingModalitySampler:
    """Yields lists of dataset indices, one list per batch."""

    def __init__(self, dataset, batch_size: int,
                 indices: Optional[np.ndarray] = None,
                 stratify: Optional[Sequence[str]] = None,
                 discretize: Optional[Sequence[str]] = None, seed: int = 42):
        self.dataset = dataset
        self.indices = indices
        self.batch_size = batch_size
        self.stratify = stratify
        self.discretize = discretize or []
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return sum(
            (len(group) + self.batch_size - 1) // self.batch_size
            for group in self.dataset.idx_per_modality_subset)

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        batches: List[np.ndarray] = []
        complete, incomplete = [], []
        for sub_idx, _ in enumerate(self.dataset.modality_subsets):
            group = list(self.dataset.idx_per_modality_subset[sub_idx])
            if not group:
                continue
            n_batches = (len(group) + self.batch_size - 1) // self.batch_size
            if self.stratify is not None and n_batches > 1:
                real = group
                if self.indices is not None:
                    real = self.indices[group].tolist()
                metadata = self.dataset.metadata.iloc[real]
                y = metadata[list(self.stratify)].copy()
                for name in self.stratify:
                    if name in self.discretize:
                        y[name] = discretizer(y[name].values)
                splitter = MultilabelStratifiedKFold(
                    n_batches, shuffle=True, random_state=self.seed)
                for _, fold_idx in splitter.split(group, y):
                    batch = np.asarray(group)[fold_idx]
                    (complete if len(batch) >= self.batch_size
                     else incomplete).append(len(batches))
                    batches.append(batch)
            else:
                perm = rng.permutation(group)
                for start in range(0, len(perm), self.batch_size):
                    batch = perm[start:start + self.batch_size]
                    (complete if len(batch) >= self.batch_size
                     else incomplete).append(len(batches))
                    batches.append(batch)
        order = (list(rng.permutation(complete)) if complete else []) + \
                (list(rng.permutation(incomplete)) if incomplete else [])
        return iter([batches[i].tolist() for i in order])


def simple_batches(n: int, batch_size: int,
                   rng: Optional[np.random.Generator] = None,
                   shuffle: bool = True) -> List[List[int]]:
    """Plain batching used for test loaders (``run_epochs.py:203``)."""
    idx = np.arange(n)
    if shuffle:
        rng = rng or np.random.default_rng(0)
        idx = rng.permutation(idx)
    return [idx[s:s + batch_size].tolist()
            for s in range(0, n, batch_size)]
