"""ELBO losses for the four training methods.

Counterpart of ``multivae_tpu/train/losses.py``: ``total_loss`` on the
port's model output (:meth:`MultimodalVAE.forward`), with the same metric
families. For poe the unimodal ELBOs re-run the model on each present
modality alone with fresh noise: ``noise_uni`` gives it explicitly
(``{mod: [B, cd + s_m]}``), else ``generator`` draws it; under dropout each
re-run takes keep masks of its own (``masks_uni``: per modality the model's
``masks`` for that modality alone).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops import gaussian
from ..ops.fusion import row_count
from ..ops.likelihoods import calc_log_prob


def calc_log_probs(model, batch, rec, rows=None
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Per-modality negative log-likelihoods and their sum (all
    reconstruction weights are 1)."""
    log_probs = {}
    weighted = 0.0
    for mod in model.modalities:
        if mod.name not in batch:
            continue
        loc, scale = rec[mod.name]
        b = row_count(batch[mod.name].shape[0], rows)
        lp = -calc_log_prob(mod.likelihood, batch[mod.name], loc, scale,
                            norm_value=b)
        log_probs[mod.name] = lp
        weighted = weighted + lp
    return log_probs, weighted


def calc_klds(results, model, rows=None) -> Dict[str, torch.Tensor]:
    """Subset-posterior KLs to the unit prior, from the stacked
    ``[S, B, D]`` subset posteriors (rows in the model's powerset order)."""
    subsets = results["latents"]["subsets"]
    mus, logvars = results["latents"]["subset_stack"]
    keys = [k for k in model.subsets if k in subsets]
    b = row_count(mus.shape[1], rows)
    per_subset = torch.sum(gaussian.kl_divergence_per_sample(mus, logvars),
                     dim=1) / b
    return {key: per_subset[i] for i, key in enumerate(keys)}


def calc_klds_style(results, rows=None) -> Dict[str, torch.Tensor]:
    klds = {}
    for key, val in results["latents"]["modalities"].items():
        if key.endswith("_style") and val[0] is not None:
            mu, logvar = val
            klds[key] = gaussian.kl_divergence(
                mu, logvar, norm_value=row_count(mu.shape[0], rows))
    return klds


def _weighted_style_kld(model, cfg, klds_style):
    total = 0.0
    for mod in model.modalities:
        key = mod.name + "_style"
        if key in klds_style:
            total = total + cfg.beta_style * klds_style[key]
    return total


def _row_mean(x, rows):
    """The mean of every element of the whole batch that ``x`` is a slice
    of (``rows``, :class:`~multivae_tpu_torch.ops.fusion.Rows`)."""
    if rows is None:
        return torch.mean(x)
    return torch.sum(x) / float(rows.total * x[0].numel())


def total_loss(cfg, model, batch, results, *,
               noise_uni: Optional[Dict[str, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None,
               masks_uni=None, rows=None):
    """Method-dispatched total loss; returns ``(loss, metrics)``. ``rows``
    (:class:`~multivae_tpu_torch.ops.fusion.Rows`): the batch is a data
    shard's slice, ``results`` its forward with the same ``rows``; the loss
    and every metric are then the slice's share of the whole batch's, and
    the shards' sum is the batch's."""
    log_probs, weighted_log_prob = calc_log_probs(model, batch,
                                                  results["rec"], rows)
    group_divergence = results["joint_divergence"]
    klds = calc_klds(results, model, rows)
    klds_style = (calc_klds_style(results, rows)
                  if cfg.factorized_representation else {})

    metrics = {"joint_divergence": group_divergence}
    for key, val in results["latents"]["modalities"].items():
        if val[0] is not None:
            metrics[f"latent_mu/{key}"] = _row_mean(val[0], rows)
            metrics[f"latent_logvar/{key}"] = _row_mean(val[1], rows)
    for k, v in log_probs.items():
        metrics[f"log_prob/{k}"] = v
    for k, v in klds.items():
        metrics[f"kld/{k}"] = v
    for k, v in klds_style.items():
        metrics[f"kld_style/{k}"] = v

    if cfg.method in ("moe", "jsd", "joint_elbo"):
        kld_style = (_weighted_style_kld(model, cfg, klds_style)
                     if cfg.factorized_representation else 0.0)
        kld_weighted = cfg.beta_style * kld_style + \
            cfg.beta_content * group_divergence
        loss = weighted_log_prob + cfg.beta * kld_weighted
    else:  # poe
        elbos = {}
        for mod in model.modalities:
            if mod.name not in batch:
                continue
            kld_style_m = klds_style.get(mod.name + "_style", 0.0)
            if cfg.poe_unimodal_elbos:
                uni_batch = {mod.name: batch[mod.name]}
                noise = None if noise_uni is None else noise_uni[mod.name]
                r_mod = model(
                    uni_batch, noise=noise, generator=generator,
                    masks=None if masks_uni is None else masks_uni[mod.name],
                    rows=rows)
                loc, scale = r_mod["rec"][mod.name]
                b = row_count(batch[mod.name].shape[0], rows)
                rec_mod = -calc_log_prob(mod.likelihood, batch[mod.name],
                                         loc, scale, norm_value=b)
                div = cfg.beta_content * klds[mod.name] + \
                    cfg.beta_style * (cfg.beta_style * kld_style_m)
                elbos[mod.name] = rec_mod + cfg.beta * div
                metrics[f"log_prob_uni/{mod.name}"] = rec_mod
        w_style_kld = _weighted_style_kld(model, cfg, klds_style)
        div = cfg.beta_content * group_divergence + \
            cfg.beta_style * w_style_kld
        elbos["joint"] = weighted_log_prob + cfg.beta * div
        loss = sum(elbos.values())

    metrics["loss"] = loss
    return loss, metrics
