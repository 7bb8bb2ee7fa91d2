"""Gaussian math primitives (KL divergences, log-pdfs, reparameterization).

Counterpart of ``multivae_tpu/ops/gaussian.py``; same formulas on torch
tensors. Random draws take an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

LOG2PI = math.log(2.0 * math.pi)


def kl_divergence(mu0, logvar0, mu1=None, logvar1=None, norm_value=None):
    """Closed-form Gaussian KL summed over every element; divided by
    ``norm_value`` (the batch size) when given."""
    if mu1 is None or logvar1 is None:
        kld = -0.5 * torch.sum(1.0 - torch.exp(logvar0) - mu0.square()
                               + logvar0)
    else:
        kld = -0.5 * torch.sum(
            1.0
            - torch.exp(logvar0 - logvar1)
            - (mu0 - mu1).square() / torch.exp(logvar1)
            + logvar0
            - logvar1
        )
    if norm_value is not None:
        kld = kld / float(norm_value)
    return kld


def kl_divergence_per_sample(mu0, logvar0, mu1=None, logvar1=None):
    """Per-sample KL (summed over the trailing feature axis only)."""
    if mu1 is None or logvar1 is None:
        per_el = -0.5 * (1.0 - torch.exp(logvar0) - mu0.square() + logvar0)
    else:
        per_el = -0.5 * (
            1.0
            - torch.exp(logvar0 - logvar1)
            - (mu0 - mu1).square() / torch.exp(logvar1)
            + logvar0
            - logvar1
        )
    return per_el.sum(dim=-1)


def gaussian_entropy(logvar, norm_value=None):
    """Gaussian entropy summed over every element (``kl_div.py:
    calc_entropy_gauss``); divided by ``norm_value`` when given."""
    ent = 0.5 * torch.sum(LOG2PI + logvar + 1.0)
    if norm_value is not None:
        ent = ent / float(norm_value)
    return ent


def reparameterize(mu, logvar, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """``z = mu + eps * exp(0.5*logvar)``; ``eps`` is ``noise`` when given,
    else a standard-normal draw from ``generator``."""
    if noise is None:
        noise = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                            device=mu.device)
    return mu + noise * torch.exp(0.5 * logvar)


def gaussian_log_pdf(x, mu, logvar):
    """Diagonal Gaussian log-density summed over the last axis."""
    log_pdf = -0.5 * LOG2PI - logvar / 2.0 - (x - mu).square() / (
        2.0 * torch.exp(logvar))
    return log_pdf.sum(dim=-1)


def unit_gaussian_log_pdf(x):
    """Standard-normal log-density summed over the last axis."""
    return (-0.5 * LOG2PI - x.square() / 2.0).sum(dim=-1)


def log_mean_exp(x, axis=1):
    """``log(mean(exp(x)))`` along ``axis``, stabilized by the max; the axis
    is kept (size 1)."""
    m = x.amax(dim=axis, keepdim=True)
    return m + torch.log(torch.exp(x - m).mean(dim=axis, keepdim=True))
