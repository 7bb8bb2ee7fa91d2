"""The multimodal VAE (MVAE/PoE, MMVAE/MoE, MoPoE, JSD) as one ``nn.Module``.

Counterpart of ``multivae_tpu/models/mmvae.py:84-278``: ``encode``, the
presence-masked ``inference`` and the forward pass with explicit noise, for
all four methods. Modalities present in a batch are the batch dict's keys;
subset posteriors come from one masked PoE over the stacked present experts
(:func:`multivae_tpu_torch.ops.fusion.masked_poe_all_subsets`). Dropout is
an explicit input (``masks``: per modality the encoder's and the decoder's
lists of keep masks, :mod:`.networks`); without it the pass is the
inference pass.

Generation (``:281-340`` there): ``get_random_styles``, ``generate`` and
``cond_generation`` take their standard-normal draws as ``noise`` (the
tensors themselves) or from ``generator``, drawn on the generator's device
and moved to the model's. Order of the draws with a generator:
``get_random_styles`` one ``[n, style_dim]`` draw per modality with a
style latent, in modality order; ``generate`` the content ``[n,
class_dim]`` first, then the styles; ``cond_generation`` the styles
first, then one content draw per subset posterior in the dict's order.
These are the JAX package's orders of ``make_rng("sample")`` calls, so a
test can feed it the JAX draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import fusion
from .modalities import ModalitySpec, powerset_subsets
from .networks import Decoder, Encoder, init_linear


class MultimodalVAE(nn.Module):
    """Presence-masked multimodal VAE over an ordered set of modalities.

    Submodules are named ``enc_<modality>`` / ``dec_<modality>`` as in the
    flax param tree."""

    def __init__(self, modalities: Tuple[ModalitySpec, ...],
                 method: str = "joint_elbo", class_dim: int = 20,
                 hidden_dim: int = 256, num_hidden_layer_encoder: int = 1,
                 num_hidden_layer_decoder: int = 0,
                 factorized_representation: bool = True,
                 initial_out_logvar: float = -3.0,
                 learn_output_scale: bool = True,
                 learn_output_sample_scale: bool = False):
        super().__init__()
        self.modalities = tuple(modalities)
        self.method = method
        self.class_dim = class_dim
        self.factorized_representation = factorized_representation
        self.encoders: Dict[str, Encoder] = {}
        self.decoders: Dict[str, Decoder] = {}
        for mod in self.modalities:
            enc = Encoder(mod.dim, class_dim, mod.style_dim, hidden_dim,
                          num_hidden_layer_encoder,
                          factorized_representation)
            dec = Decoder(mod.dim, class_dim, mod.style_dim, hidden_dim,
                          num_hidden_layer_decoder,
                          factorized_representation, initial_out_logvar,
                          learn_output_scale, learn_output_sample_scale)
            self.add_module(f"enc_{mod.name}", enc)
            self.add_module(f"dec_{mod.name}", dec)
            self.encoders[mod.name] = enc
            self.decoders[mod.name] = dec

    @property
    def mod_names(self) -> Tuple[str, ...]:
        return tuple(m.name for m in self.modalities)

    @property
    def subsets(self) -> Dict[str, Tuple[str, ...]]:
        return powerset_subsets(self.mod_names)

    # ---------------------------------------------------------------- encode
    def encode(self, batch: Dict[str, torch.Tensor], masks=None):
        """Per-modality posteriors; absent modalities map to (None, None).
        ``masks``: ``{modality: (encoder masks, decoder masks)}`` or None."""
        latents = {}
        for mod in self.modalities:
            if mod.name in batch:
                s_mu, s_lv, c_mu, c_lv = self.encoders[mod.name](
                    batch[mod.name],
                    None if masks is None else masks[mod.name][0])
                latents[mod.name + "_style"] = (s_mu, s_lv)
                latents[mod.name] = (c_mu, c_lv)
            else:
                latents[mod.name + "_style"] = (None, None)
                latents[mod.name] = (None, None)
        return latents

    # ----------------------------------------------------------- subset fuse
    def _fuse_available_subsets(self, enc_mods, present: Tuple[str, ...],
                                rows=None):
        """``(subset_keys, sub_mus [S,B,D], sub_logvars [S,B,D])`` for every
        fully-available subset, in powerset order (``rows``:
        :class:`~multivae_tpu_torch.ops.fusion.Rows`)."""
        present_set = set(present)
        avail = [(key, mods) for key, mods in self.subsets.items()
                 if all(m in present_set for m in mods)]
        keys = [k for k, _ in avail]
        mus = torch.stack([enc_mods[m][0] for m in present])
        logvars = torch.stack([enc_mods[m][1] for m in present])
        col = {m: i for i, m in enumerate(present)}

        if self.method in ("poe", "joint_elbo"):
            mask = np.zeros((len(avail), len(present)), np.float32)
            prior = np.zeros(len(avail), np.float32)
            for s, (_, mods) in enumerate(avail):
                for m in mods:
                    mask[s, col[m]] = 1.0
                # the unit prior expert joins every poe subset and the full
                # modality set (BaseMMVae.py:109-118)
                if self.method == "poe" or len(mods) == len(self.modalities):
                    prior[s] = 1.0
            sub_mus, sub_logvars = fusion.masked_poe_all_subsets(
                mus, logvars, mask, prior)
        else:  # moe / jsd: mixture selection within each subset
            rows_mu, rows_lv = [], []
            for _, mods in avail:
                if len(mods) == 1:
                    rows_mu.append(mus[col[mods[0]]])
                    rows_lv.append(logvars[col[mods[0]]])
                else:
                    idx = fusion.device_constant(
                        [col[m] for m in mods], mus, torch.int64)
                    mu_s, lv_s = fusion.mixture_component_selection(
                        mus[idx], logvars[idx], rows=rows)
                    rows_mu.append(mu_s)
                    rows_lv.append(lv_s)
            sub_mus = torch.stack(rows_mu)
            sub_logvars = torch.stack(rows_lv)
        return keys, sub_mus, sub_logvars

    def _fusion_condition(self, mods: Tuple[str, ...],
                          present: Tuple[str, ...]) -> bool:
        """Which subsets join the joint mixture (``BaseMMVae.py:125-134``)."""
        if self.method in ("moe", "jsd"):
            return len(mods) == 1
        if self.method == "poe":
            return len(mods) == len(present)
        return True  # joint_elbo

    # -------------------------------------------------------------- inference
    def inference(self, batch: Dict[str, torch.Tensor], *,
                  sample: bool = True, use_expert: Optional[str] = None,
                  masks=None, rows=None):
        """Reference ``BaseMMVae.inference`` (``:181-239``); ``rows`` as
        in :meth:`forward`."""
        present = tuple(m.name for m in self.modalities if m.name in batch)
        if not present:
            raise ValueError("empty batch: no known modality present")
        enc_mods = self.encode(batch, masks)
        keys, sub_mus, sub_logvars = self._fuse_available_subsets(
            enc_mods, present, rows)
        distr_subsets = {k: (sub_mus[i], sub_logvars[i])
                         for i, k in enumerate(keys)}
        sel = fusion.device_constant(
            [i for i, k in enumerate(keys)
             if self._fusion_condition(self.subsets[k], present)],
            sub_mus, torch.int64)
        mus = sub_mus[sel]
        logvars = sub_logvars[sel]
        if self.method == "jsd":
            # the unit expert joins the mixture (BaseMMVae.py:217-223)
            zero = torch.zeros_like(mus[:1])
            mus = torch.cat([mus, zero])
            logvars = torch.cat([logvars, zero])
        k = mus.shape[0]
        weights = np.full((k,), 1.0 / k, dtype=np.float32)
        if use_expert is not None:
            joint = distr_subsets[use_expert]
        elif sample:
            joint = fusion.mixture_component_selection(mus, logvars,
                                                       rows=rows)
        else:
            joint = (mus.mean(dim=0), logvars.mean(dim=0))
        return {
            "modalities": enc_mods,
            "mus": mus,
            "logvars": logvars,
            "weights": weights,
            "joint": joint,
            "subsets": distr_subsets,
            "subset_stack": (sub_mus, sub_logvars),
        }

    # ------------------------------------------------------------- divergence
    def _calc_joint_divergence(self, mus, logvars, weights, rows=None):
        """Group divergence normalized by the batch size
        (``BaseMMVae.py:64-93``)."""
        weights = fusion.reweight_weights(weights)
        norm = fusion.row_count(mus.shape[1], rows)
        if self.method == "jsd":
            group_div, klds, dyn_prior = fusion.alpha_jsd_divergence(
                mus, logvars, weights, normalization=norm)
            return {"joint_divergence": group_div, "individual_divs": klds,
                    "dyn_prior": dyn_prior}
        group_div, klds = fusion.group_divergence_moe(
            mus, logvars, weights, normalization=norm)
        return {"joint_divergence": group_div, "individual_divs": klds,
                "dyn_prior": None}

    # ---------------------------------------------------------------- forward
    def noise_width(self, present) -> int:
        """Width of the fused normal draw for a presence pattern: the
        content latent, then each present modality's style latent."""
        total = self.class_dim
        for mod in self.modalities:
            if (mod.name in present and self.factorized_representation
                    and mod.style_dim > 0):
                total += mod.style_dim
        return total

    def forward(self, batch: Dict[str, torch.Tensor], *,
                sample_latents: bool = True,
                use_expert: Optional[str] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                masks=None, rows=None):
        """Full forward pass (``BaseMMVae.forward``, ``:137-165``).

        With ``sample_latents`` the reparameterization noise
        ``[B, noise_width(batch)]`` is ``noise`` when given, else a draw from
        ``generator``. ``masks`` (``{modality: (encoder masks, decoder
        masks)}``, one pre-scaled keep mask per hidden layer) applies
        dropout; None is the inference pass. ``rows``
        (:class:`~multivae_tpu_torch.ops.fusion.Rows`): the batch is a
        data shard's slice of a larger one, whose mixture partition and
        batch size the pass takes.
        """
        latents = self.inference(batch, sample=sample_latents,
                                 use_expert=use_expert, masks=masks,
                                 rows=rows)
        joint_mu, joint_logvar = latents["joint"]
        eps = None
        if sample_latents:
            eps = noise
            if eps is None:
                eps = torch.randn(
                    (joint_mu.shape[0], self.noise_width(batch)),
                    generator=generator, dtype=joint_mu.dtype,
                    device=joint_mu.device)
            class_z = joint_mu + eps[:, :self.class_dim] * torch.exp(
                0.5 * joint_logvar)
        else:
            class_z = joint_mu
        divs = self._calc_joint_divergence(
            latents["mus"], latents["logvars"], latents["weights"], rows)

        rec = {}
        offset = self.class_dim
        for mod in self.modalities:
            if mod.name not in batch:
                continue
            s_mu, s_lv = latents["modalities"][mod.name + "_style"]
            if (self.factorized_representation and sample_latents
                    and mod.style_dim > 0):
                style_z = s_mu + eps[:, offset:offset + mod.style_dim] \
                    * torch.exp(0.5 * s_lv)
                offset += mod.style_dim
            else:
                style_z = s_mu
            rec[mod.name] = self.decoders[mod.name](
                style_z, class_z,
                None if masks is None else masks[mod.name][1])

        out = {"latents": latents, "group_distr": latents["joint"],
               "rec": rec}
        out.update(divs)
        return out

    # -------------------------------------------------------------- generation
    def _device(self) -> torch.device:
        return next(self.parameters()).device

    def _has_style(self, mod: ModalitySpec) -> bool:
        return self.factorized_representation and mod.style_dim > 0

    def get_random_styles(self, num_samples: int, noise=None,
                          generator: Optional[torch.Generator] = None):
        """Unit-normal style draws per modality, None for a modality
        without a style latent (``BaseMMVae.py:302-312``). ``noise``:
        ``{modality: [num_samples, style_dim]}``."""
        styles = {}
        for mod in self.modalities:
            if not self._has_style(mod):
                styles[mod.name] = None
            elif noise is not None:
                styles[mod.name] = noise[mod.name].to(self._device())
            else:
                styles[mod.name] = _normal((num_samples, mod.style_dim),
                                           generator, self._device())
        return styles

    def get_random_style_dists(self, num_samples: int):
        """Unit-Gaussian style distributions ``(mu, logvar)``, zeros of
        ``[num_samples, style_dim]`` (``BaseMMVae.py:290-299``)."""
        dev = self._device()
        return {mod.name: (torch.zeros(num_samples, mod.style_dim,
                                       device=dev),
                           torch.zeros(num_samples, mod.style_dim,
                                       device=dev))
                for mod in self.modalities}

    def generate_sufficient_statistics_from_latents(self, latents):
        """Decode ``{"content": z, "style": {modality: z or None}}`` to each
        modality's ``(loc, scale)`` (``BaseMMVae.py:257-264``)."""
        content = latents["content"]
        return {mod.name: self.decoders[mod.name](
            latents["style"][mod.name], content) for mod in self.modalities}

    def generate_from_latents(self, latents):
        """Distribution means per modality (``BaseMMVae.py:267-273``)."""
        suff = self.generate_sufficient_statistics_from_latents(latents)
        return {m: loc for m, (loc, _) in suff.items()}

    def generate(self, num_samples: int, noise=None,
                 generator: Optional[torch.Generator] = None):
        """Unconditional generation from the unit prior
        (``BaseMMVae.py:242-254``). ``noise``: ``{"content": [n,
        class_dim], "style": {modality: [n, style_dim]}}``."""
        if noise is not None:
            content = noise["content"].to(self._device())
        else:
            content = _normal((num_samples, self.class_dim), generator,
                              self._device())
        styles = self.get_random_styles(
            num_samples, None if noise is None else noise["style"],
            generator)
        return self.generate_from_latents({"content": content,
                                           "style": styles})

    def cond_generation(self, latent_distributions, num_samples=None,
                        noise=None,
                        generator: Optional[torch.Generator] = None):
        """Conditional generation from subset posteriors ``{key: (mu,
        logvar)}`` (``BaseMMVae.py:276-287``): one style draw shared by
        every subset, one content draw per subset. ``noise``: ``{"style":
        {modality: [n, style_dim]}, "content": {key: [n, class_dim]}}``."""
        if num_samples is None:
            num_samples = next(iter(latent_distributions.values()))[0].shape[0]
        styles = self.get_random_styles(
            num_samples, None if noise is None else noise["style"],
            generator)
        out = {}
        for key, (mu, logvar) in latent_distributions.items():
            eps = (noise["content"][key].to(mu.device) if noise is not None
                   else _normal(mu.shape, generator, mu.device))
            out[key] = self.generate_from_latents(
                {"content": mu + eps * torch.exp(0.5 * logvar),
                 "style": styles})
        return out


def _normal(shape, generator: Optional[torch.Generator], device):
    """A float32 standard-normal draw from ``generator`` on its own device
    (the CPU without one), moved to ``device``."""
    where = generator.device if generator is not None else "cpu"
    return torch.randn(shape, generator=generator, device=where).to(device)


def init_params(model: MultimodalVAE, generator: torch.Generator) -> None:
    """Draw every ``Linear`` of ``model`` with ``generator`` (torch
    ``nn.Linear``'s default law); ``out_logvar`` keeps its constant."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            init_linear(module, generator)


def build_model(cfg, modalities: Dict[str, ModalitySpec],
                device: torch.device | str, seed: Optional[int] = None
                ) -> MultimodalVAE:
    """Construct the model from a :class:`multivae_tpu.train.config.Config`
    on ``device``, its weights drawn from a generator seeded with ``seed``
    (default ``cfg.seed``)."""
    model = MultimodalVAE(
        modalities=tuple(modalities.values()),
        method=cfg.method,
        class_dim=cfg.class_dim,
        hidden_dim=cfg.hidden_dim,
        num_hidden_layer_encoder=cfg.num_hidden_layer_encoder,
        num_hidden_layer_decoder=cfg.num_hidden_layer_decoder,
        factorized_representation=cfg.factorized_representation,
        initial_out_logvar=cfg.initial_out_logvar,
        learn_output_scale=cfg.learn_output_scale,
        learn_output_sample_scale=cfg.learn_output_sample_scale,
    )
    generator = torch.Generator().manual_seed(
        cfg.seed if seed is None else int(seed))
    init_params(model, generator)
    return model.to(device).eval()
