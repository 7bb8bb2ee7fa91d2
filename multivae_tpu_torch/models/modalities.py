"""Modality descriptors: a copy of ``multivae_tpu/models/modalities.py``
(numpy only; that package's ``models/__init__`` loads flax).

The reference wraps each data block in a ``Modality`` object carrying its
name, encoder/decoder classes and likelihood family
(``experiments/modalities/modality.py:7-52``,
``experiments/modalities/multimodal_cohort.py:8-42``). Here a modality is a
lightweight spec consumed by the model and data layers; likelihood math lives
in the likelihood ops.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class ModalitySpec:
    name: str
    dim: int                 # feature width of the block
    style_dim: int           # modality-specific latent width
    likelihood: str          # normal | laplace | bernoulli | categorical
    names_file: str = ""     # e.g. clinical_names.npy (multimodal_cohort.py:14,36)


def clinical(n_scores: int, style_dim: int, likelihood: str) -> ModalitySpec:
    return ModalitySpec("clinical", n_scores, style_dim, likelihood,
                        "clinical_names.npy")


def rois(n_rois: int, style_dim: int, likelihood: str) -> ModalitySpec:
    return ModalitySpec("rois", n_rois, style_dim, likelihood,
                        "rois_names.npy")


# registry keyed by position, matching MultimodalExperiment.set_modalities
# (experiment.py:132-144): modality 0 is clinical, modality 1 is rois.
DEFAULT_FACTORIES = (clinical, rois)


def make_modalities(input_dims: Sequence[int], style_dims: Sequence[int],
                    likelihood: str,
                    names: Sequence[str] | None = None) -> Dict[str, ModalitySpec]:
    """Build the ordered modality dict for a cohort experiment."""
    mods = []
    for m, dim in enumerate(input_dims):
        if names is not None:
            mods.append(ModalitySpec(names[m], dim, style_dims[m], likelihood,
                                     f"{names[m]}_names.npy"))
        elif m < len(DEFAULT_FACTORIES):
            mods.append(DEFAULT_FACTORIES[m](dim, style_dims[m], likelihood))
        else:
            mods.append(ModalitySpec(f"mod{m}", dim, style_dims[m],
                                     likelihood, f"mod{m}_names.npy"))
    return {m.name: m for m in mods}


def powerset_subsets(mod_names: Sequence[str]) -> Dict[str, Tuple[str, ...]]:
    """All non-empty modality subsets keyed ``'_'.join(sorted(names))``.

    Mirrors ``BaseExperiment.set_subsets`` (``utils/BaseExperiment.py:58-79``):
    combinations of sizes 1..M over the modality list, key is the sorted
    underscore join.
    """
    subsets: Dict[str, Tuple[str, ...]] = {}
    for n in range(1, len(mod_names) + 1):
        for combo in combinations(mod_names, n):
            key = "_".join(sorted(combo))
            subsets[key] = tuple(combo)
    return subsets


def available_subsets(subsets: Dict[str, Tuple[str, ...]],
                      present: Sequence[str]) -> List[str]:
    """Subset keys whose members are all present (``BaseMMVae.py:196-213``)."""
    present_set = set(present)
    return [k for k, mods in subsets.items()
            if all(m in present_set for m in mods)]
