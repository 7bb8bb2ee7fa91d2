"""Math primitives (``gaussian``, ``fusion``, ``divergences_extra``) and
the kernels' Python side (``fused_daa``, ``fused_step``, ... whose CUDA
kernels ``_build`` builds). Exports the auxiliary divergences as
``multivae_tpu/ops/__init__.py:55`` does."""

from .divergences_extra import (
    alpha_jsd_modalities_mixture,
    gaussian_scaling_factor,
    gaussian_scaling_factor_self,
    im_kernel_sum,
    kl_divergence_lb_gauss_mixture,
    kl_divergence_ub_gauss_mixture,
    mmd_loss,
    modality_divergence,
)

__all__ = [
    "alpha_jsd_modalities_mixture",
    "gaussian_scaling_factor",
    "gaussian_scaling_factor_self",
    "im_kernel_sum",
    "kl_divergence_lb_gauss_mixture",
    "kl_divergence_ub_gauss_mixture",
    "mmd_loss",
    "modality_divergence",
]
