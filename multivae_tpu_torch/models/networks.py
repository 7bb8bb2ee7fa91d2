"""Per-modality encoder/decoder MLPs (``nn.Module``).

Counterpart of ``multivae_tpu/models/networks.py``:

* Encoder: ``input -> [Linear(hidden) + ReLU + dropout] *
  num_hidden_layers`` then ONE fused head projection to ``(class_mu,
  class_logvar, style_mu, style_logvar)`` columns, in that order (the JAX
  package's ``heads``).
* Decoder: ``concat(style_z, class_z) -> [Linear(hidden) + ReLU + dropout] *
  num_hidden_layers -> out_mu``; the output log-variance is a per-sample
  head (``out_heads``) or a per-feature parameter ``out_logvar [1, D]``.
  Returns ``(loc, scale = exp(0.5 * logvar))``.

Submodule and parameter names follow the flax tree (``hidden_0``,
``heads``, ``out_mu``, ``out_logvar``), so the weights bridge
(:mod:`multivae_tpu_torch.params`) is a rename plus a transpose.

Dropout is an explicit input: ``forward`` takes an optional list of
pre-scaled keep masks (values in ``{0, 1 / (1 - rate)}``, ``[B, hidden]``),
one per hidden layer, and multiplies each in after its layer's ReLU, where
flax's ``nn.Dropout`` sits. There is no ``nn.Dropout`` and no global RNG:
the caller draws the masks (:func:`multivae_tpu_torch.train.trainer.
mask_generator`), so the kernel routes and the general step take the same
ones. Without masks (inference, the test pass) dropout is the identity.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class Linear(nn.Linear):
    """``nn.Linear`` whose weights are drawn by :func:`init_linear` from an
    explicit generator instead of the global RNG at construction."""

    def reset_parameters(self) -> None:
        pass


def init_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    """torch ``nn.Linear``'s default law: weight and bias ``U(±1/sqrt(
    fan_in))`` (Kaiming-uniform with a=sqrt(5)), the JAX package's init."""
    bound = 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)


def hidden_stack(module: nn.Module, h, masks=None):
    """``relu(hidden_i(h)) [* masks[i]]`` through the module's hidden
    layers; ``masks`` holds one keep mask per layer, or is None."""
    n = module.num_hidden_layers
    if masks is not None and len(masks) != n:
        raise ValueError(f"{n} hidden layers take {n} dropout masks, got "
                         f"{len(masks)}")
    for i in range(n):
        h = torch.relu(getattr(module, f"hidden_{i}")(h))
        if masks is not None:
            h = h * masks[i]
    return h


class Encoder(nn.Module):
    """Shared-trunk encoder with content (class) and optional style heads."""

    def __init__(self, input_dim: int, class_dim: int, style_dim: int,
                 hidden_dim: int = 256, num_hidden_layers: int = 1,
                 factorized: bool = True):
        super().__init__()
        self.class_dim = class_dim
        self.style_dim = style_dim if (factorized and style_dim > 0) else 0
        self.num_hidden_layers = num_hidden_layers
        width = input_dim
        for i in range(num_hidden_layers):
            self.add_module(f"hidden_{i}", Linear(width, hidden_dim))
            width = hidden_dim
        self.heads = Linear(width, 2 * class_dim + 2 * self.style_dim)

    def forward(self, x, masks: Optional[Sequence[torch.Tensor]] = None):
        return self.split_heads(self.heads(hidden_stack(self, x, masks)))

    def split_heads(self, heads):
        """``(style_mu, style_logvar, class_mu, class_logvar)`` from the
        head projection's columns."""
        cd, s = self.class_dim, self.style_dim
        class_mu = heads[..., :cd]
        class_logvar = heads[..., cd:2 * cd]
        style_mu = style_logvar = None
        if s:
            style_mu = heads[..., 2 * cd:2 * cd + s]
            style_logvar = heads[..., 2 * cd + s:]
        return style_mu, style_logvar, class_mu, class_logvar


class Decoder(nn.Module):
    """Decoder from (style, class) latents to output sufficient statistics."""

    def __init__(self, output_dim: int, class_dim: int, style_dim: int,
                 hidden_dim: int = 256, num_hidden_layers: int = 0,
                 factorized: bool = True, initial_out_logvar: float = -3.0,
                 learn_output_scale: bool = True,
                 learn_output_sample_scale: bool = False):
        super().__init__()
        self.output_dim = output_dim
        self.has_style = factorized and style_dim > 0
        self.num_hidden_layers = num_hidden_layers
        self.learn_output_sample_scale = learn_output_sample_scale
        width = class_dim + (style_dim if self.has_style else 0)
        for i in range(num_hidden_layers):
            self.add_module(f"hidden_{i}", Linear(width, hidden_dim))
            width = hidden_dim
        if learn_output_sample_scale:
            self.out_heads = Linear(width, 2 * output_dim)
        else:
            self.out_mu = Linear(width, output_dim)
            self.out_logvar = nn.Parameter(
                torch.full((1, output_dim), float(initial_out_logvar)),
                requires_grad=learn_output_scale)

    def forward(self, style_z: Optional[torch.Tensor], class_z: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None):
        h = hidden_stack(self, self.latent_input(style_z, class_z), masks)
        if self.learn_output_sample_scale:
            return self.outputs(self.out_heads(h))
        return self.outputs(self.out_mu(h), self.out_logvar)

    def latent_input(self, style_z, class_z):
        """The first layer's input: ``concat(style_z, class_z)``, or
        ``class_z`` without a style latent."""
        return torch.cat([style_z, class_z], dim=-1) if self.has_style \
            else class_z

    def outputs(self, out, out_logvar=None):
        """``(loc, scale)`` from the output projection: ``out_heads``'
        columns, or ``out_mu``'s beside the per-feature ``out_logvar``."""
        if out_logvar is None:
            loc = out[..., :self.output_dim]
            logvar = out[..., self.output_dim:]
        else:
            loc = out
            logvar = out_logvar.expand_as(loc)
        return loc, torch.exp(0.5 * logvar)
