"""Modality specs, encoder/decoder networks and the multimodal VAE."""

from .mmvae import MultimodalVAE, build_model
from .modalities import ModalitySpec, make_modalities, powerset_subsets

__all__ = ["ModalitySpec", "MultimodalVAE", "build_model", "make_modalities",
           "powerset_subsets"]
