"""The general train step, the eval step and the train state.

Counterpart of ``multivae_tpu/train/train_step.py:71-91, 250-292, 388-406``.
The train state of one model is a flat params buffer and an
:class:`~multivae_tpu_torch.ops.adam.AdamState`, both in the split layout
(:mod:`multivae_tpu_torch.params`). :func:`general_step` is the JAX
package's ``_member_step``: torch autograd of the model and
:func:`~multivae_tpu_torch.train.losses.total_loss`, then flat Adam. It is
what ``fused_training=False`` runs; the fused routes take the kernels
(:mod:`multivae_tpu_torch.train.trainer`). Noise is explicit:
``[B, batch_noise_width]`` with the model's draw first (``cd`` then each
present modality's style) and, for poe, one unimodal draw
(``cd + s_m``) per present modality in model order.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.adam import AdamHyper, AdamState, adam_update, init_adam_state
from ..params import (
    FusedDims,
    flatten_params,
    flatten_split,
    load_flat_params,
    model_flat_params,
    split_params,
    state_dict_to_tree,
)
from .losses import total_loss


def batch_noise_width(cfg, model, present) -> int:
    """Noise columns per sample of a batch with modalities ``present``."""
    width = model.noise_width(present)
    if cfg.method == "poe" and cfg.poe_unimodal_elbos:
        width += sum(model.noise_width((m.name,)) for m in model.modalities
                     if m.name in present)
    return width


def split_batch_noise(cfg, model, batch, noise):
    """``(main noise, {mod: unimodal noise} or None)`` of a batch's noise."""
    main = model.noise_width(batch)
    uni = None
    if cfg.method == "poe" and cfg.poe_unimodal_elbos:
        uni, off = {}, main
        for m in model.modalities:
            if m.name in batch:
                w = model.noise_width((m.name,))
                uni[m.name] = noise[:, off:off + w]
                off += w
    return noise[:, :main], uni


def loss_and_metrics(cfg, model, batch, noise):
    """``(loss, metrics)`` of the model on a batch with explicit noise."""
    main, uni = split_batch_noise(cfg, model, batch, noise)
    out = model(batch, noise=main)
    return total_loss(cfg, model, batch, out, noise_uni=uni)


def grads_flat(model, dims: FusedDims) -> torch.Tensor:
    """The model's ``.grad`` s as a flat buffer of the split layout (zero
    where a parameter has none, e.g. a frozen output scale)."""
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    tree = state_dict_to_tree(grads, as_numpy=False)
    return flatten_split(split_params(flatten_params(tree, model.mod_names),
                                      dims)).detach()


def general_step(cfg, model, params: torch.Tensor, opt: AdamState,
                 batch: Dict[str, torch.Tensor], noise: torch.Tensor,
                 dims: FusedDims, hyper: AdamHyper):
    """One step of the general path, in place on ``params`` and ``opt``'s
    moments: ``(opt with count + 1, loss, metrics)``. ``model`` is used as
    scratch: its weights are overwritten with ``params``."""
    load_flat_params(model, params, dims)
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, metrics = loss_and_metrics(cfg, model, batch, noise)
        loss.backward()
    g = grads_flat(model, dims)
    adam_update(params, opt.mu, opt.nu, g, opt.count + 1, hyper)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return AdamState(opt.count + 1, opt.mu, opt.nu), loss.detach(), metrics


@torch.no_grad()
def eval_step(cfg, model, batch, noise):
    """Test-time loss and metrics (``make_eval_step``)."""
    return loss_and_metrics(cfg, model, batch, noise)


def init_train_state(model, dims: FusedDims):
    """``(params, opt_state)`` of a fresh run from the model's weights."""
    params = model_flat_params(model, dims)
    return params, init_adam_state(params)


def param_count(model) -> int:
    return sum(p.numel() for p in model.parameters())
