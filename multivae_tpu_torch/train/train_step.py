"""The general train step, the eval step and the train state.

Counterpart of ``multivae_tpu/train/train_step.py:71-91, 250-292, 388-406``.
The train state of one model is a flat params buffer and an
:class:`~multivae_tpu_torch.ops.adam.AdamState`, both in the layout of the
config's dims (the split layout or the general one,
:mod:`multivae_tpu_torch.params`). :func:`general_step` is the JAX
package's ``_member_step``: torch autograd of the model and
:func:`~multivae_tpu_torch.train.losses.total_loss`, then flat Adam. It is
what ``fused_training=False`` runs; the fused routes take the kernels
(:mod:`multivae_tpu_torch.train.trainer`). Noise is explicit:
``[B, batch_noise_width]`` with the model's draw first (``cd`` then each
present modality's style) and, for poe, one unimodal draw
(``cd + s_m``) per present modality in model order. Dropout is explicit
too: pre-scaled keep masks ``[general_mask_count, B, hidden]``, one per
hidden layer, in the kernel routes' order: the main pass's encoder layers of
each present modality in model order, then its decoder layers, then for poe
the unimodal re-runs' masks in the same order. On a complete batch these
are the masks of the method step and of the layer-stack step, so the
routes can be held to each other. None is no dropout (the test pass).

Data parallel (``make_train_step(mesh=...)``, ``make_scan_train_step(
mesh=...)`` and ``mesh_for_rows`` there, ``:94-118, 202-248``):
:func:`dp_general_step` splits a batch's rows over a data mesh; each shard
runs :func:`loss_and_metrics` on its rows as a slice of the whole batch
(:class:`~multivae_tpu_torch.ops.fusion.Rows`: the batch's mixture
partition and batch size, as GSPMD computes the whole batch's function),
and the shards' gradients and metrics are summed in shard order by
``ops.fused_sharded._dp_update``, which then runs Adam once.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from ..ops import fused_sharded
from ..ops.adam import AdamHyper, AdamState, adam_update, init_adam_state
from ..ops.fusion import Rows
from ..params import grads_to_flat as grads_flat
from ..params import load_flat_params, model_flat_params
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


def general_mask_count(cfg, present) -> int:
    """Keep masks one general step of a batch with modalities ``present``
    takes: one per hidden layer of every present modality's encoder and
    decoder, and as many again for poe's unimodal re-runs (0 without
    dropout)."""
    if cfg.dropout_rate <= 0.0:
        return 0
    per_pass = len(present) * (cfg.num_hidden_layer_encoder
                               + cfg.num_hidden_layer_decoder)
    poe = cfg.method == "poe" and cfg.poe_unimodal_elbos
    return per_pass * (2 if poe else 1)


def split_batch_masks(cfg, model, batch, masks):
    """``(main masks, {mod: masks of its unimodal re-run} or None)`` of a
    batch's keep masks ``[general_mask_count, B, hidden]``, each in the
    model's form ``{mod: (encoder masks, decoder masks)}``; ``(None,
    None)`` without masks."""
    if masks is None:
        return None, None
    present = [m.name for m in model.modalities if m.name in batch]
    n_enc, n_dec = cfg.num_hidden_layer_encoder, cfg.num_hidden_layer_decoder
    per_pass = len(present) * (n_enc + n_dec)

    def one_pass(block):
        enc, dec = block[:len(present) * n_enc], block[len(present) * n_enc:]
        return {name: (list(enc[k * n_enc:(k + 1) * n_enc]),
                       list(dec[k * n_dec:(k + 1) * n_dec]))
                for k, name in enumerate(present)}

    want = general_mask_count(cfg, present)
    if len(masks) != want:
        raise ValueError(f"a {cfg.method} step of {present} takes {want} "
                         f"dropout masks, got {len(masks)}")
    main = one_pass(masks[:per_pass])
    uni = None
    if len(masks) > per_pass:
        second = one_pass(masks[per_pass:])
        uni = {name: {name: second[name]} for name in present}
    return main, uni


def loss_and_metrics(cfg, model, batch, noise, masks=None,
                     rows: Optional[Rows] = None):
    """``(loss, metrics)`` of the model on a batch with explicit noise and,
    under dropout, explicit keep masks; ``rows``: the batch is a data
    shard's slice (the loss and metrics are then its share of the whole
    batch's)."""
    main, uni = split_batch_noise(cfg, model, batch, noise)
    masks_main, masks_uni = split_batch_masks(cfg, model, batch, masks)
    out = model(batch, noise=main, masks=masks_main, rows=rows)
    return total_loss(cfg, model, batch, out, noise_uni=uni,
                      masks_uni=masks_uni, rows=rows)


def general_grads(cfg, model, params: torch.Tensor, batch, noise, dims,
                  masks=None, rows: Optional[Rows] = None):
    """``(loss, metrics, flat gradient)`` of the model at ``params`` by
    autograd; ``model`` is scratch (its weights are overwritten)."""
    load_flat_params(model, params, dims)
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, metrics = loss_and_metrics(cfg, model, batch, noise, masks,
                                         rows)
        loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads_flat(model, dims)


def general_step(cfg, model, params: torch.Tensor, opt: AdamState,
                 batch: Dict[str, torch.Tensor], noise: torch.Tensor,
                 dims, hyper: AdamHyper, masks=None):
    """One step of the general path, in place on ``params`` and ``opt``'s
    moments: ``(opt with count + 1, loss, metrics)``. ``model`` is used as
    scratch: its weights are overwritten with ``params``. ``dims`` names
    the buffers' layout; ``masks`` as in the module's docstring."""
    loss, metrics, g = general_grads(cfg, model, params, batch, noise, dims,
                                     masks)
    adam_update(params, opt.mu, opt.nu, g, opt.count + 1, hyper)
    return AdamState(opt.count + 1, opt.mu, opt.nu), loss, metrics


def mesh_for_rows(mesh, rows: int):
    """The data mesh a batch of ``rows`` rows shards over: ``mesh`` when
    its rows divide the ``data`` axis, else None, the batch running
    unsharded (``train_step.py:202-211``: padding would change the
    update)."""
    if mesh is None or rows % mesh.shape["data"]:
        return None
    return mesh


def model_replicas(model):
    """``on(device)``: ``model`` itself on its own device, a copy of it on
    any other (made once), the scratch module of a shard there."""
    home = next(model.parameters()).device
    copies = {home: model}

    def on(device):
        device = torch.device(device)
        if device not in copies:
            copies[device] = copy.deepcopy(model).to(device)
        return copies[device]
    return on


def sharded_step(shard_grads, params: torch.Tensor, opt: AdamState, batch,
                 noise, hyper: AdamHyper, devices, masks=None):
    """One step of a batch whose rows split evenly over ``devices`` (the
    first holds the train state), in place: shard ``k`` gets rows ``[k
    local_b, (k + 1) local_b)`` of the batch, noise and masks, on its
    device, and ``shard_grads(params, batch, noise, masks, rows, k) ->
    (metrics, flat gradient)`` gives its share of the whole batch's;
    ``ops.fused_sharded._dp_update`` sums the shares in shard order and
    runs Adam once. Returns ``(opt with count + 1, loss, metrics)``."""
    b = len(next(iter(batch.values())))
    local_b = b // len(devices)
    names = []

    def shard_step(pk, sl, offset, dev):
        shard = {k: v[sl].to(dev) for k, v in batch.items()}
        shard_masks = None if masks is None else masks[:, sl].to(dev)
        rows = Rows(offset, b) if len(devices) > 1 else None
        metrics, g = shard_grads(pk, shard, noise[sl].to(dev), shard_masks,
                                 rows, offset // local_b)
        names[:] = list(metrics)
        return torch.stack([metrics[k] for k in names]), g

    mvec = fused_sharded._dp_update(shard_step, params, opt.mu, opt.nu,
                                    opt.count + 1, devices, local_b, hyper,
                                    rescale=None)
    metrics = dict(zip(names, mvec))
    return AdamState(opt.count + 1, opt.mu, opt.nu), metrics["loss"], metrics


def dp_general_step(cfg, replicas, params: torch.Tensor, opt: AdamState,
                    batch: Dict[str, torch.Tensor], noise: torch.Tensor,
                    dims, hyper: AdamHyper, mesh, masks=None):
    """One data-parallel general step over the ``data`` axis of ``mesh``
    (its rows must divide it), in place: the counterpart of the JAX
    package's ``make_train_step(mesh=mesh)``. ``replicas``
    (:func:`model_replicas`) gives each shard's scratch model. Returns
    ``(opt with count + 1, loss, metrics)``, the whole batch's."""
    def shard_grads(pk, shard, eps, shard_masks, rows, k):
        _, metrics, g = general_grads(cfg, replicas(pk.device), pk, shard,
                                      eps, dims, shard_masks, rows)
        return metrics, g
    return sharded_step(shard_grads, params, opt, batch, noise, hyper,
                        mesh.axis_devices("data"), masks)


@torch.no_grad()
def eval_step(cfg, model, batch, noise):
    """Test-time loss and metrics (``make_eval_step``)."""
    return loss_and_metrics(cfg, model, batch, noise)


def init_train_state(model, dims):
    """``(params, opt_state)`` of a fresh run from the model's weights."""
    params = model_flat_params(model, dims)
    return params, init_adam_state(params)


def param_count(model) -> int:
    return sum(p.numel() for p in model.parameters())
