"""Output-likelihood log-probabilities.

Counterpart of ``multivae_tpu/ops/likelihoods.py``: each family is a
function of the decoder's ``(loc, scale)``, with ``scale = exp(logvar / 2)``.
:func:`sample` takes its randomness from an explicit ``torch.Generator`` or
from the uniform / normal draws given as ``noise``.
"""

from __future__ import annotations

import math
from typing import Optional

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


def sample_noise(name: str, shape, generator: Optional[torch.Generator] =
                 None, device=None, dtype=torch.float32):
    """The draws :func:`sample` consumes for ``name``: standard normals for
    normal, uniforms in ``[0, 1)`` for the three others (categorical: one
    per row and class, for the Gumbel-max trick), drawn on the generator's
    device (the CPU without one) and moved to ``device``."""
    where = generator.device if generator is not None else "cpu"
    if name == "normal":
        draw = torch.randn(shape, generator=generator, dtype=dtype,
                           device=where)
    elif name in ("laplace", "bernoulli", "categorical"):
        draw = torch.rand(shape, generator=generator, dtype=dtype,
                          device=where)
    else:
        raise ValueError(f"likelihood not implemented: {name}")
    return draw.to(device) if device is not None else draw


def sample(name: str, loc, scale, noise: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None):
    """A draw from the output distribution. ``noise`` (shape of ``loc``) is
    the family's base draw, :func:`sample_noise`'s law; without it one is
    drawn from ``generator``. Laplace clips the uniform to ``[1e-7, 1 -
    1e-7]`` before the inverse CDF, as the JAX package draws it; categorical
    takes the Gumbel-max of the logits."""
    if noise is None:
        noise = sample_noise(name, loc.shape, generator, loc.device,
                             loc.dtype)
    if name == "normal":
        return loc + scale * noise
    if name == "laplace":
        u = noise.clamp(1e-7, 1.0 - 1e-7) - 0.5
        return loc - scale * torch.sign(u) * torch.log1p(-2.0 * u.abs())
    if name == "bernoulli":
        return (noise < torch.sigmoid(loc)).to(loc.dtype)
    if name == "categorical":
        gumbel = -torch.log(-torch.log(noise.clamp_min(
            torch.finfo(loc.dtype).tiny)))
        idx = torch.argmax(loc + gumbel, dim=-1)
        return F.one_hot(idx, loc.shape[-1]).to(loc.dtype)
    raise ValueError(f"likelihood not implemented: {name}")
