"""Backward-compat shim (``multivae_tpu/constants.py``); see
multivae_tpu_torch.data.cohorts."""

from .data.cohorts import (  # noqa: F401
    get_short_clinical_names,
    indices,
    modalities,
    short_clinical_names,
)
