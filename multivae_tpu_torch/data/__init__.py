"""Data layer: fetchers, datasets, samplers, preprocessing, synthetic cohorts.

Counterpart of ``multivae_tpu/data``: numpy and pandas only (the scaler is
numpy, :mod:`.preprocess`), so it loads on a machine without scikit-learn.
"""

from .dataset import DataManager, MultimodalDataset
from .fetchers import DEFAULTS, Item, extract_and_order_by, fetch_multiblock, make_fetcher
from .preprocess import Residualizer, StandardScaler
from .sampler import MissingModalitySampler, simple_batches
from .stratify import (
    MultilabelStratifiedKFold,
    MultilabelStratifiedShuffleSplit,
    ShuffleSplit,
    discretizer,
)
from .synthetic import make_synthetic_cohort

__all__ = [
    "DEFAULTS",
    "DataManager",
    "Item",
    "MissingModalitySampler",
    "MultilabelStratifiedKFold",
    "MultilabelStratifiedShuffleSplit",
    "MultimodalDataset",
    "Residualizer",
    "ShuffleSplit",
    "StandardScaler",
    "discretizer",
    "extract_and_order_by",
    "fetch_multiblock",
    "make_fetcher",
    "make_synthetic_cohort",
    "simple_batches",
]
