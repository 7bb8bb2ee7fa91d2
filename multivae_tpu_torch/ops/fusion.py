"""Expert-fusion primitives: PoE, alpha-PoE, masked subset fusion, mixture
selection and the group divergences.

Counterpart of ``multivae_tpu/ops/fusion.py``. Mixture partitions and
subset masks are static numpy arrays, as there; the tensor math is torch.
They meet the tensors through :func:`device_constant`, which copies each
to the device once: a forward pass copies nothing from the host, so a CUDA
graph can capture it (``train/trainer.py``'s test pass).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .gaussian import kl_divergence, kl_divergence_per_sample

POE_EPS = 1e-8

# (value, dtype, device) -> tensor: the static arrays already on a device
_CONSTANTS: dict = {}


def device_constant(array, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """The static numpy ``array`` (a partition, subset masks, weights, row
    indices) as a tensor of ``dtype`` (``like``'s by default) on ``like``'s
    device, copied there once per value. A copy from the host to a card
    waits for the host, which a CUDA graph's capture refuses: the eager
    warm-up before a capture makes the constants, and the capture finds
    them here. Nothing writes to the tensors handed out."""
    array = np.ascontiguousarray(array)
    dtype = like.dtype if dtype is None else dtype
    key = (array.dtype.str, array.shape, array.tobytes(), dtype, like.device)
    out = _CONSTANTS.get(key)
    if out is None:
        out = _CONSTANTS[key] = torch.tensor(array, dtype=dtype,
                                             device=like.device)
    return out


class Rows(NamedTuple):
    """The rows a slice holds of a whole batch: its first row's index in
    the batch and the batch's row count. A data shard computes the whole
    batch's function on its slice: rows are assigned by their index in the
    batch (:func:`mixture_component_selection`) and every mean over rows
    divides by ``total`` (``models/mmvae.py``, ``train/losses.py``), so the
    shards' results sum to the batch's."""
    offset: int
    total: int


def row_count(b: int, rows: Optional[Rows]) -> int:
    """The row count a mean over a batch slice of ``b`` rows divides by:
    the whole batch's when the slice is a shard's."""
    return b if rows is None else rows.total


def poe(mus, logvars, eps: float = POE_EPS):
    """Precision-weighted product of Gaussian experts over axis 0."""
    t = 1.0 / (torch.exp(logvars) + eps)
    t_sum = t.sum(dim=0)
    pd_mu = (mus * t).sum(dim=0) / t_sum
    return pd_mu, torch.log(1.0 / t_sum)


def alpha_poe(alpha, mus, logvars, eps: float = POE_EPS):
    """Weighted PoE used as the JSD dynamic prior."""
    t = 1.0 / (torch.exp(logvars) + eps)
    if not isinstance(alpha, torch.Tensor):
        alpha = device_constant(np.asarray(alpha, dtype=np.float32), mus)
    alpha = alpha.to(mus).reshape((-1,) + (1,) * (mus.dim() - 1))
    pd_var = 1.0 / (alpha * t).sum(dim=0)
    pd_mu = pd_var * (alpha * mus * t).sum(dim=0)
    return pd_mu, torch.log(pd_var)


def masked_poe_all_subsets(mus, logvars, subset_mask, prior_expert,
                           eps: float = POE_EPS):
    """All subset posteriors at once from stacked ``[M, B, D]`` experts.

    ``subset_mask`` ``[S, M]`` selects each subset's experts;
    ``prior_expert`` ``[S]`` adds the unit-Gaussian expert. Up to 16 static
    subsets are summed term by term (the JAX package's order of addition);
    more go through one einsum, as in the JAX package.
    Returns ``(pd_mu, pd_logvar)`` each ``[S, B, D]``.
    """
    t = 1.0 / (torch.exp(logvars) + eps)
    prior_t = 1.0 / (1.0 + eps)
    mu_t = mus * t
    if isinstance(subset_mask, np.ndarray) and subset_mask.shape[0] <= 16:
        rows_t, rows_mu = [], []
        prior_np = np.asarray(prior_expert)
        for s_row in range(subset_mask.shape[0]):
            members = [m for m in range(subset_mask.shape[1])
                       if subset_mask[s_row, m]]
            ts, ms = t[members[0]], mu_t[members[0]]
            for m in members[1:]:
                ts = ts + t[m]
                ms = ms + mu_t[m]
            if prior_np[s_row]:
                ts = ts + prior_t
            rows_t.append(ts)
            rows_mu.append(ms)
        t_sum = torch.stack(rows_t)
        mu_sum = torch.stack(rows_mu)
    else:
        mask = device_constant(subset_mask, mus)
        prior = device_constant(prior_expert, mus)
        t_sum = torch.einsum("sm,mbd->sbd", mask, t)
        t_sum = t_sum + prior[:, None, None] * prior_t
        mu_sum = torch.einsum("sm,mbd->sbd", mask, mu_t)
    return mu_sum / t_sum, -torch.log(t_sum)


def mixture_partition(num_components: int, num_samples: int,
                      weights: Sequence[float] | None = None) -> np.ndarray:
    """Owner component of every row of a stratified mixture: component k
    owns ``floor(num_samples * w_k)`` consecutive rows, the last one the
    remainder (``utils/utils.py:63-85`` arithmetic)."""
    if weights is None:
        weights = [1.0 / num_components] * num_components
    weights = [float(w) for w in weights]
    total = sum(weights)
    weights = [w / total for w in weights]
    owner = np.zeros(num_samples, dtype=np.int64)
    start = 0
    for k in range(num_components):
        if k == num_components - 1:
            end = num_samples
        else:
            end = start + int(math.floor(num_samples * weights[k]))
        owner[start:end] = k
        start = end
    return owner


def mixture_component_selection(mus, logvars, weights=None,
                                rows: Optional[Rows] = None):
    """Stratified MoE sample selection: each row of ``[K, B, D]`` experts
    takes its owning component's (mu, logvar). ``rows``: the experts are
    rows ``[offset, offset + B)`` of a batch of ``total``, whose partition
    they take."""
    k, b = mus.shape[0], mus.shape[1]
    owner = mixture_partition(k, row_count(b, rows), weights)
    if rows is not None:
        owner = owner[rows.offset:rows.offset + b]
    owner = device_constant(owner, mus, torch.int64)
    rows = torch.arange(b, device=mus.device)
    return mus[owner, rows], logvars[owner, rows]


def group_divergence_moe(mus, logvars, weights, normalization=None):
    """Weighted sum of per-component KLs to the unit prior."""
    weights = device_constant(np.asarray(weights, dtype=np.float32), mus)
    if normalization is not None:
        klds = torch.stack([
            kl_divergence(mus[k], logvars[k], norm_value=normalization)
            for k in range(mus.shape[0])
        ])
        return (weights * klds).sum(), klds
    klds = kl_divergence_per_sample(mus, logvars)
    return (weights[:, None] * klds).sum(dim=0), klds


def alpha_jsd_divergence(mus, logvars, weights, normalization=None):
    """JSD dynamic-prior divergence: each expert's KL against the alpha-PoE
    of all experts. Returns ``(group_div, klds, (prior_mu, prior_logvar))``.
    """
    weights = device_constant(np.asarray(weights, dtype=np.float32), mus)
    prior_mu, prior_logvar = alpha_poe(weights, mus, logvars)
    klds_ps = kl_divergence_per_sample(mus, logvars, prior_mu[None],
                                       prior_logvar[None])
    if normalization is not None:
        klds = klds_ps.sum(dim=1) / float(normalization)
        group_div = (weights * klds).sum()
    else:
        klds = klds_ps
        group_div = (weights[:, None] * klds).sum(dim=0)
    return group_div, klds, (prior_mu, prior_logvar)


def reweight_weights(w):
    """Normalize static weights to sum to one."""
    w = np.asarray(w, dtype=np.float32)
    return w / np.sum(w)
