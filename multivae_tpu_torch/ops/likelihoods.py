"""Output-likelihood log-probabilities.

Counterpart of ``multivae_tpu/ops/likelihoods.py``: each family is a
function of the decoder's ``(loc, scale)``, with ``scale = exp(logvar / 2)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG2PI = math.log(2.0 * math.pi)

LIKELIHOODS = ("normal", "laplace", "bernoulli", "categorical")


def tie_sign(r):
    """``sign(r)`` with ``+1`` at ``r == 0`` (``-0.0`` too): the derivative
    of ``|r|`` that ``jax.grad(jnp.abs)`` takes everywhere, ties included."""
    return torch.where(r >= 0, 1.0, -1.0).to(r.dtype)


def abs_jax_grad(r):
    """``|r|`` whose autograd gradient is :func:`tie_sign` (torch's
    ``abs`` has gradient 0 at 0)."""
    return r * tie_sign(r).detach()


def log_prob(name: str, x, loc, scale):
    """Elementwise log-probabilities (categorical: class-reduced)."""
    if name == "normal":
        var = torch.square(scale)
        return -0.5 * (LOG2PI + torch.log(var)) - torch.square(x - loc) / (
            2.0 * var)
    if name == "laplace":
        return -torch.log(2.0 * scale) - abs_jax_grad(x - loc) / scale
    if name == "bernoulli":
        return x * F.logsigmoid(loc) + (1.0 - x) * F.logsigmoid(-loc)
    if name == "categorical":
        return torch.sum(x * F.log_softmax(loc, dim=-1), dim=-1)
    raise ValueError(f"likelihood not implemented: {name}")


def calc_log_prob(name: str, x, loc, scale, norm_value):
    """``log_prob(x).sum() / norm_value``."""
    return torch.sum(log_prob(name, x, loc, scale)) / norm_value
