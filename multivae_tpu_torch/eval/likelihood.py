"""IWAE-style log-likelihood estimation.

Counterpart of ``multivae_tpu/eval/likelihood.py``: per modality-subset
posterior, ``num_imp_samples`` importance samples estimate ``log p(x_m)``
for each modality the batch carries, plus the joint ``log p(x)``. The
documented decisions against the upstream estimator are kept
(``docs/PARITY.md``, "Known intentional deviations"): each datum's
importance weights are grouped ``[K, B]`` (targets tiled samples-major, the
log-mean-exp over K); a subset's estimate conditions the styles only on
its member modalities, non-members draw from the unit prior.

Noise: :func:`batch_likelihoods` takes its standard-normal draws as
``noise`` (:func:`importance_noise`'s layout) or from ``generator``. The
order of the draws: for each subset the batch can form, in powerset order,
the content draw ``[K, B, class_dim]``, then one style draw ``[K, B,
style_dim]`` per modality with a style latent, in modality order.
:func:`estimate_likelihoods` draws them for every batch, in batch order,
from one CPU generator seeded ``cfg.seed + 99`` and copies them to the
model's device, so a card run and a CPU run see the same noise. No JAX
stream is reproduced.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.gaussian import gaussian_log_pdf, log_mean_exp, \
    unit_gaussian_log_pdf
from ..ops.likelihoods import log_prob


def _available_subsets(model, batch):
    return [key for key, mods in model.subsets.items()
            if all(m in batch for m in mods)]


def importance_noise(model, batch, num_imp_samples: int = 12,
                     generator: Optional[torch.Generator] = None):
    """The draws of :func:`batch_likelihoods` for ``batch``: ``{subset:
    {"content": [K, B, class_dim], "style": {modality: [K, B, style_dim]
    or None}}}``, in the module's order, on the generator's device (the CPU
    without one)."""
    k = num_imp_samples
    b = next(iter(batch.values())).shape[0]
    where = generator.device if generator is not None else "cpu"

    def normal(width):
        return torch.randn((k, b, width), generator=generator, device=where)

    out = {}
    for s_key in _available_subsets(model, batch):
        content = normal(model.class_dim)
        style = {mod.name: normal(mod.style_dim) if model._has_style(mod)
                 else None for mod in model.modalities}
        out[s_key] = {"content": content, "style": style}
    return out


@torch.no_grad()
def batch_likelihoods(model, batch, generator: Optional[torch.Generator] =
                      None, num_imp_samples: int = 12, noise=None):
    """All-subset IWAE estimates for one batch: ``{subset: {modality: ll,
    'joint': ll}}`` of scalar means over the batch, keys sorted. ``noise``
    (:func:`importance_noise`) or ``generator`` gives the importance
    draws."""
    if noise is None:
        noise = importance_noise(model, batch, num_imp_samples, generator)
    k = num_imp_samples
    dev = next(model.parameters()).device
    latents = model.inference(batch)
    present_mods = [m for m in model.modalities if m.name in batch]
    b = batch[present_mods[0].name].shape[0]

    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for s_key in _available_subsets(model, batch):
        s_mu, s_lv = latents["subsets"][s_key]
        draws = noise[s_key]
        z = s_mu[None] + draws["content"].to(dev) * torch.exp(
            0.5 * s_lv)[None]
        members = set(model.subsets[s_key])

        # per-subset style distributions: the encoded posterior for a
        # member modality, the unit prior for the others
        style_mu, style_lv, style_z = {}, {}, {}
        for mod in model.modalities:
            if not model._has_style(mod):
                style_mu[mod.name] = style_lv[mod.name] = None
                style_z[mod.name] = None
                continue
            mu, lv = latents["modalities"][mod.name + "_style"]
            if mod.name not in members or mu is None:
                mu = torch.zeros(b, mod.style_dim, device=dev)
                lv = torch.zeros(b, mod.style_dim, device=dev)
            style_mu[mod.name], style_lv[mod.name] = mu, lv
            style_z[mod.name] = mu[None] + draws["style"][mod.name].to(
                dev) * torch.exp(0.5 * lv)[None]

        # decode every present modality from (style, content), all K draws
        log_px_z = {}
        for mod in present_mods:
            sz = style_z[mod.name]
            loc, scale = model.decoders[mod.name](
                None if sz is None else sz.reshape(k * b, -1),
                z.reshape(k * b, -1))
            # samples-major targets: row i * b + j is datum j's draw i
            lp = log_prob(mod.likelihood, batch[mod.name].repeat(k, 1), loc,
                          scale)
            log_px_z[mod.name] = (lp.reshape(k, b, -1).sum(-1) if lp.ndim > 1
                                  else lp.reshape(k, b))

        log_q_c = gaussian_log_pdf(z, s_mu[None], s_lv[None])      # [K, B]
        log_p_c = unit_gaussian_log_pdf(z)

        def style_term(name):
            sz = style_z[name]
            return unit_gaussian_log_pdf(sz) - gaussian_log_pdf(
                sz, style_mu[name][None], style_lv[name][None])

        lls = {}
        for mod in present_mods:
            log_w = log_px_z[mod.name] + log_p_c - log_q_c
            if mod.name in members and style_z[mod.name] is not None:
                log_w = log_w + style_term(mod.name)
            lls[mod.name] = log_mean_exp(log_w.T, axis=1).mean()

        log_w = sum(log_px_z[m.name] for m in present_mods) + log_p_c \
            - log_q_c
        for mod in model.modalities:
            if style_z[mod.name] is not None:
                log_w = log_w + style_term(mod.name)
        lls["joint"] = log_mean_exp(log_w.T, axis=1).mean()
        out[s_key] = lls
    # key-sorted, as the jitted JAX function returns its dicts
    return {s: dict(sorted(out[s].items())) for s in sorted(out)}


def estimate_likelihoods(exp, model_idx: int = 0, num_imp_samples: int = 12,
                         batch_size: int = 64,
                         generator: Optional[torch.Generator] = None):
    """Dataset-level IWAE estimates: the mean of the per-batch estimates over
    the test split's complete samples, in ``default_rng(cfg.seed)``'s
    permutation, batches of ``batch_size``. ``generator`` (default: a CPU
    generator seeded ``cfg.seed + 99``) draws every batch's noise in batch
    order."""
    cfg = exp.cfg
    model = exp.models[model_idx]
    dev = next(model.parameters()).device
    dataset = exp.member_datasets(model_idx)[1]
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed + 99)
    complete = dataset.idx_per_modality_subset[-1]
    lhoods: Dict[str, Dict[str, list]] = {}
    order = np.random.default_rng(cfg.seed).permutation(complete)
    for start in range(0, len(order), batch_size):
        data, _, _ = dataset.gather(order[start:start + batch_size])
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        ll = batch_likelihoods(model, batch, generator, num_imp_samples)
        for s_key, vals in ll.items():
            for m_key, v in vals.items():
                lhoods.setdefault(s_key, {}).setdefault(m_key, []).append(
                    float(v))
    return {s: {m: float(np.mean(v)) for m, v in d.items()}
            for s, d in lhoods.items()}
