"""Auxiliary divergence measures of the reference's inventory.

Counterpart of ``multivae_tpu/ops/divergences_extra.py``, the same
formulas on torch tensors: the Gaussian-mixture KL bounds of the
two-modality JSD variant (``experiments/divergence_measures/kl_div.py:
17-111``), the pairwise modality-divergence matrix (``mm_div.py:126-151``)
and the WAE-style inverse-multiquadratic MMD (``mmd.py:1-43``). No
training path calls them, in either package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .fusion import reweight_weights
from .gaussian import gaussian_entropy, kl_divergence

PI = math.pi


def _weights(alpha, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(reweight_weights(alpha), dtype=like.dtype,
                           device=like.device)


def gaussian_scaling_factor(mu1, logvar1, mu2=None, logvar2=None,
                            norm_value=None):
    """``kl_div.py:calc_gaussian_scaling_factor`` (``:17-35``)."""
    d = mu1.shape[1]
    if mu2 is None or logvar2 is None:
        s_pre = (1.0 / (2.0 * PI) ** (d / 2.0)) * torch.sqrt(
            torch.sum(torch.exp(logvar1) + 1.0, dim=1))
        s = s_pre * torch.sum(
            torch.exp(-0.5 * mu1.square() / (torch.exp(logvar1) + 1.0)),
            dim=1)
    else:
        s_pre = torch.sqrt(torch.sum(
            1.0 / ((2.0 * PI) ** (d / 2.0)
                   * (torch.exp(logvar1) + torch.exp(logvar2))), dim=1))
        s = s_pre * torch.sum(
            torch.exp(-0.5 * (mu1 - mu2).square()
                      / (torch.exp(logvar1) + torch.exp(logvar2))), dim=1)
    s = torch.sum(s)
    if norm_value is not None:
        s = s / float(norm_value)
    return s


def gaussian_scaling_factor_self(logvar1, norm_value=None):
    """``kl_div.py:calc_gaussian_scaling_factor_self`` (``:38-46``)."""
    d = logvar1.shape[1]
    s = (1.0 / (2.0 * PI) ** (d / 2.0)) * torch.sqrt(
        torch.sum(torch.exp(logvar1), dim=1))
    s = torch.sum(s)
    if norm_value is not None:
        s = s / float(norm_value)
    return s


def kl_divergence_lb_gauss_mixture(alpha_modalities: Sequence[float], index,
                                   mu1, logvar1, mus, logvars,
                                   norm_value=None):
    """Lower bound of KL to a Gaussian mixture
    (``kl_div.py:calc_kl_divergence_lb_gauss_mixture``, ``:64-80``)."""
    w = _weights(alpha_modalities, mu1)
    denom = w[0] * gaussian_scaling_factor(mu1, logvar1,
                                           norm_value=norm_value)
    for k in range(len(mus)):
        if index == k:
            denom = denom + w[k + 1] * gaussian_scaling_factor_self(
                logvar1, norm_value=norm_value)
        else:
            denom = denom + w[k + 1] * gaussian_scaling_factor(
                mu1, logvar1, mus[k], logvars[k], norm_value=norm_value)
    return -torch.log(denom)


def kl_divergence_ub_gauss_mixture(alpha_modalities: Sequence[float], index,
                                   mu1, logvar1, mus, logvars, entropy,
                                   norm_value=None):
    """Upper bound of KL to a Gaussian mixture
    (``kl_div.py:calc_kl_divergence_ub_gauss_mixture``, ``:83-103``)."""
    w = _weights(alpha_modalities, mu1)
    nom = gaussian_scaling_factor_self(logvar1, norm_value=norm_value)
    kl_uniform = kl_divergence(mu1, logvar1, norm_value=norm_value)
    denom = w[0] * torch.clamp(torch.exp(kl_uniform), max=1e5)
    for k in range(len(mus)):
        if index == k:
            denom = denom + w[k + 1]
        else:
            kl_k = kl_divergence(mu1, logvar1, mus[k], logvars[k],
                                 norm_value=norm_value)
            denom = denom + w[k + 1] * torch.clamp(torch.exp(kl_k), max=1e5)
    return torch.log(nom) - torch.log(denom) + entropy


def alpha_jsd_modalities_mixture(m1_mu, m1_logvar, m2_mu, m2_logvar,
                                 alpha_modalities, batch_size):
    """Two-modality JSD via averaged mixture-KL bounds
    (``mm_div.py:calc_alphaJSD_modalities_mixture``, ``:38-66``); returns
    ``(summed, klds [2], entropies [2])``."""
    w_modalities = _weights(alpha_modalities[1:], m1_mu)
    mus = [m1_mu, m2_mu]
    logvars = [m1_logvar, m2_logvar]
    klds, entropies = [], []
    for k in range(2):
        ent = gaussian_entropy(logvars[k], norm_value=batch_size)
        lb = kl_divergence_lb_gauss_mixture(
            alpha_modalities, k, mus[k], logvars[k], mus, logvars,
            norm_value=batch_size)
        ub = kl_divergence_ub_gauss_mixture(
            alpha_modalities, k, mus[k], logvars[k], mus, logvars, ent,
            norm_value=batch_size)
        entropies.append(ent)
        klds.append(0.5 * (lb + ub))
    klds = torch.stack(klds)
    return torch.sum(w_modalities * klds), klds, torch.stack(entropies)


def modality_divergence(m1_mu, m1_logvar, m2_mu, m2_logvar,
                        modality_poe: bool = False):
    """Pairwise KL matrix between modality posteriors
    (``mm_div.py:calc_modality_divergence``, ``:126-151``): the KL of the
    two modalities for poe, else ``(klds_sum, klds_modonly_sum)``."""
    n = len(m1_mu)
    if modality_poe:
        return kl_divergence(m1_mu, m1_logvar, m2_mu, m2_logvar,
                             norm_value=n)
    mus = [torch.zeros_like(m1_mu), m1_mu, m2_mu]
    logvars = [torch.zeros_like(m1_logvar), m1_logvar, m2_logvar]
    klds = torch.zeros((3, 3), dtype=m1_mu.dtype, device=m1_mu.device)
    for i in range(1, 3):
        for j in range(3):
            klds[i, j] = kl_divergence(mus[i], logvars[i], mus[j],
                                       logvars[j], norm_value=n)
    return torch.sum(klds) / (3 * 2), torch.sum(klds[1:, 1:]) / 4


def im_kernel_sum(z1, z2, zvar: float, exclude_diag: bool = True):
    """Inverse-multiquadratic kernel sum (``mmd.py:im_kernel_sum``)."""
    z_dim = z1.shape[1]
    c = 2.0 * z_dim * zvar
    d2 = torch.sum((z1[:, None, :] - z2[None, :, :]).square(), dim=-1)
    k = c / (c + d2)
    total = torch.sum(k)
    if exclude_diag:
        total = total - torch.trace(k)
    return total


def mmd_loss(sample_qz, sample_pz, zvar: float = 1.0):
    """WAE inverse-multiquadratic MMD (``mmd.py:mmd_loss``)."""
    n = sample_qz.shape[0]
    return (im_kernel_sum(sample_qz, sample_qz, zvar) / (n * (n - 1))
            + im_kernel_sum(sample_pz, sample_pz, zvar) / (n * (n - 1))
            - 2.0 * im_kernel_sum(sample_qz, sample_pz, zvar,
                                  exclude_diag=False) / (n * n))
