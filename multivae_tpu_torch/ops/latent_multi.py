"""The methods' latent math of a complete-batch step for any modality count:
the plain version of ``csrc/latent_multi.cuh``, forward and hand-derived
backward.

Counterpart of what ``multivae_tpu/models/mmvae.py`` (``inference``,
``_calc_joint_divergence``) and ``multivae_tpu/train/losses.py``
(``total_loss``) compute between the encoders' heads and the decoders'
inputs for ``M >= 2`` modalities, every one present. The two-modality
shortcuts of :func:`.fused_methods.latent_fwd_bwd` are not taken; this
follows the JAX model:

* joint_elbo mixes all ``2^M - 1`` subsets in ``powerset_subsets`` order,
  each the PoE of its experts, the unit prior expert joining only the full
  set; rows go to components by ``mixture_partition(2^M - 1, B)`` (when
  ``2^M - 1 > B`` every component but the last is empty), and the
  divergence is the mean of every subset's KL over every row;
* moe mixes the M unimodal posteriors (an M-way partition); a subset of
  several modalities has, as a metric, the KL of its members' mixture;
* jsd mixes the M unimodal posteriors and the unit expert, and takes the
  KLs of those M + 1 against their alpha-PoE with static weights
  ``1 / (M + 1)``;
* poe takes the PoE of the prior and all M experts; with its unimodal ELBOs
  one more ELBO per modality, which decodes its own modality from the
  prior's PoE with that modality's expert (under dropout from a second
  encoding with its own masks). Without them those terms go.

Noise ``[B, w]``: ``cd | s_1 .. s_M``, then for poe with its unimodal ELBOs
``cd | s_m`` per modality in model order. The metric vector is in the order
of :func:`step_metric_names`; at M = 2 with poe's unimodal ELBOs that is
:func:`.fused_methods.method_metric_names`.
"""

from __future__ import annotations

from itertools import combinations
from typing import List, Sequence, Tuple

import torch

from .fused_methods import (
    METHODS,
    jsd_prior,
    kl_grads,
    kl_sum,
    mean_or_zero,
    poe_with_prior,
    poe_with_prior_bwd,
    reparam_bwd,
)
from .fused_step import POE_EPS
from .fusion import mixture_partition


def powerset(m: int) -> List[Tuple[int, ...]]:
    """The non-empty subsets of ``range(m)`` in ``powerset_subsets`` order:
    by size, then in ``itertools.combinations`` order."""
    return [c for r in range(1, m + 1) for c in combinations(range(m), r)]


def with_unimodal_elbos(method: str, unimodal_elbos: bool) -> bool:
    """Whether a step of ``method`` has poe's unimodal ELBOs."""
    return method == "poe" and bool(unimodal_elbos)


def step_metric_names(names: Sequence[str], method: str,
                      unimodal_elbos: bool = True) -> Tuple[str, ...]:
    """A step's scalar families for modalities ``names`` (model order):
    ``loss``, ``joint_divergence``, the NLLs, the KL of every subset in
    powerset order, the style KLs, per modality the four latent means,
    then poe's unimodal NLLs."""
    out = ["loss", "joint_divergence"]
    out += [f"log_prob/{n}" for n in names]
    out += ["kld/" + "_".join(sorted(names[i] for i in s))
            for s in powerset(len(names))]
    out += [f"kld_style/{n}_style" for n in names]
    for n in names:
        out += [f"latent_mu/{n}", f"latent_logvar/{n}",
                f"latent_mu/{n}_style", f"latent_logvar/{n}_style"]
    if with_unimodal_elbos(method, unimodal_elbos):
        out += [f"log_prob_uni/{n}" for n in names]
    return tuple(out)


def n_step_metrics(m: int, method: str, unimodal_elbos: bool = True) -> int:
    return (2 + 6 * m + 2 ** m - 1
            + (m if with_unimodal_elbos(method, unimodal_elbos) else 0))


def noise_width(method: str, cd: int, ss: Sequence[int],
                unimodal_elbos: bool = True) -> int:
    """Noise columns of one step: ``cd + sum(ss)``, then ``cd + s_m`` per
    modality for poe's unimodal draws."""
    w = cd + sum(ss)
    if with_unimodal_elbos(method, unimodal_elbos):
        w += len(ss) * cd + sum(ss)
    return w


def owner_rows(k: int, b: int, device) -> torch.Tensor:
    """The component of each of ``b`` rows under the ``k``-way uniform
    stratified partition (``mixture_partition``)."""
    return torch.as_tensor(mixture_partition(k, b), dtype=torch.long,
                           device=device)


def _poe_of(mods, cmu, t, prior: bool):
    """``(mu, lv, ts)`` of the PoE of the experts ``mods`` (and the unit
    prior expert), summed in model order, the prior last."""
    ts = t[mods[0]]
    for m in mods[1:]:
        ts = ts + t[m]
    if prior:
        ts = ts + 1.0 / (1.0 + POE_EPS)
    num = cmu[mods[0]] * t[mods[0]]
    for m in mods[1:]:
        num = num + cmu[m] * t[m]
    return num / ts, -torch.log(ts), ts


def _select(owner, parts):
    """Row ``i`` of ``parts[owner[i]]``."""
    stacked = torch.stack(parts)
    return stacked[owner, torch.arange(owner.numel(), device=owner.device)]


def latent_fwd_bwd(method: str, nets, noise, b: int, cd: int,
                   ss: Sequence[int], consts, unimodal_elbos: bool = True):
    """The loss of one complete step of ``M = len(ss)`` modalities around
    any encoders and decoders: ``(loss, metrics)`` in
    :func:`step_metric_names` order, the networks' gradients left in
    ``nets`` (the interface of :func:`.fused_methods.latent_fwd_bwd`)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    m_count = len(ss)
    uni = with_unimodal_elbos(method, unimodal_elbos)
    beta, beta_style, beta_content = consts
    bf = float(b)
    device = noise.device
    subsets = powerset(m_count)
    n_sub = len(subsets)

    enc = [nets.encode(e, 0) for e in range(m_count)]
    cmu = [h[0] for _, h in enc]
    clv = [h[1] for _, h in enc]
    smu = [h[2] for _, h in enc]
    slv = [h[3] for _, h in enc]
    ev = [torch.exp(v) for v in clv]
    t = [1.0 / (v + POE_EPS) for v in ev]
    ej = noise[:, :cd]
    es, off = [], cd
    for s in ss:
        es.append(noise[:, off:off + s])
        off += s

    # ---------------- subsets, joint, group divergence ----------------
    post = None
    if method in ("joint_elbo", "poe"):
        post = [_poe_of(mods, cmu, t, method == "poe"
                        or len(mods) == m_count) for mods in subsets]
        klds = [kl_sum(mu, lv, bf) for mu, lv, _ in post]
    else:
        klds = []
        for mods in subsets:
            if len(mods) == 1:
                klds.append(kl_sum(cmu[mods[0]], clv[mods[0]], bf))
            else:
                own = owner_rows(len(mods), b, device)
                klds.append(kl_sum(_select(own, [cmu[m] for m in mods]),
                                   _select(own, [clv[m] for m in mods]), bf))
    if method == "joint_elbo":
        owner = owner_rows(n_sub, b, device)
        joint_mu = _select(owner, [p[0] for p in post])
        joint_lv = _select(owner, [p[1] for p in post])
        group_div = sum(klds[1:], klds[0]) / float(n_sub)
    elif method == "moe":
        owner = owner_rows(m_count, b, device)
        joint_mu, joint_lv = _select(owner, cmu), _select(owner, clv)
        group_div = sum(klds[1:m_count], klds[0]) / float(m_count)
    elif method == "jsd":
        owner = owner_rows(m_count + 1, b, device)
        zero = torch.zeros_like(cmu[0])  # the unit expert's rows
        joint_mu = _select(owner, cmu + [zero])
        joint_lv = _select(owner, clv + [zero])
        jsd_sum, jsd_grads = jsd_prior(
            list(zip(cmu, clv, t)), bf,
            beta * beta_content / ((m_count + 1) * bf))
        group_div = jsd_sum / float(m_count + 1)
    else:  # poe: the full set with the prior
        joint_mu, joint_lv = post[-1][0], post[-1][1]
        group_div = klds[-1]

    # ---------------- reparameterize, decode, loss ----------------
    zc = joint_mu + ej * torch.exp(0.5 * joint_lv)
    zs = [smu[e] + es[e] * torch.exp(0.5 * slv[e]) for e in range(m_count)]
    dec = [nets.decode(e, 0, zs[e], zc) for e in range(m_count)]
    nll = [d[0] for d in dec]
    kld_style = [kl_sum(smu[e], slv[e], bf) for e in range(m_count)]
    style = beta_style * beta_style * sum(kld_style[1:], kld_style[0])
    nll_sum = sum(nll[1:], nll[0])
    unis = []
    if uni:
        off = cd + sum(ss)
        for e in range(m_count):
            uj = noise[:, off:off + cd]
            us = noise[:, off + cd:off + cd + ss[e]]
            off += cd + ss[e]
            cache = None
            heads = (cmu[e], clv[e], smu[e], slv[e])
            t_u, (mu_u, lv_u, ts_u) = t[e], post[e]
            if nets.reencode:
                cache, heads = nets.encode(e, 1)
                t_u = 1.0 / (torch.exp(heads[1]) + POE_EPS)
                mu_u, lv_u, ts_u = poe_with_prior(heads[0], t_u)
            zcu = mu_u + uj * torch.exp(0.5 * lv_u)
            zsu = heads[2] + us * torch.exp(0.5 * heads[3])
            nll_u, dec_u = nets.decode(e, 1, zsu, zcu)
            unis.append(dict(cache=cache, cmu=heads[0], clv=heads[1],
                             slv=heads[3], t=t_u, mu=mu_u, lv=lv_u, ts=ts_u,
                             nll=nll_u, dec=dec_u, uj=uj, us=us))
        uni_sum = sum((u["nll"] for u in unis[1:]), unis[0]["nll"])
        single = sum(klds[1:m_count], klds[0])
        loss = uni_sum + nll_sum + beta * (
            beta_content * (single + group_div) + 2.0 * style)
    elif method == "poe":
        loss = nll_sum + beta * (beta_content * group_div + style)
    else:
        loss = nll_sum + beta * (style + beta_content * group_div)

    means = []
    for e in range(m_count):
        means += [mean_or_zero(v) for v in (cmu[e], clv[e], smu[e], slv[e])]
    metrics = torch.stack([loss, group_div] + nll + klds + kld_style + means
                          + [u["nll"] for u in unis])

    # ---------------- backward ----------------
    g_zs, g_zc = [], None
    for e in range(m_count):
        g_s, g_c = nets.decode_bwd(e, dec[e][1])
        g_zs.append(g_s)
        g_zc = g_c if g_zc is None else g_zc + g_c
    g_jmu, g_jlv = reparam_bwd(g_zc, ej, joint_lv)
    zeros = [torch.zeros_like(cmu[0]) for _ in range(m_count)]
    g_cmu, g_t, g_clv = list(zeros), list(zeros), list(zeros)

    def through_poe(mods, mu, lv, ts, g_mu, g_lv):
        # mu = sum(cmu t) / ts, lv = -log(ts), ts = sum(t) [+ prior]
        for m in mods:
            g_cmu[m] = g_cmu[m] + g_mu * (t[m] / ts)
            g_t[m] = g_t[m] + g_mu * (cmu[m] - mu) / ts - g_lv / ts

    if method == "joint_elbo":
        cg = beta * beta_content / (n_sub * bf)
        for k, (mods, (mu, lv, ts)) in enumerate(zip(subsets, post)):
            own = (owner == k).float()[:, None]
            k_mu, k_lv = kl_grads(mu, lv, cg)
            through_poe(mods, mu, lv, ts, own * g_jmu + k_mu,
                        own * g_jlv + k_lv)
    elif method in ("moe", "jsd"):
        cg = beta * beta_content / (m_count * bf)
        for m in range(m_count):
            own = (owner == m).float()[:, None]
            if method == "moe":
                k_mu, k_lv = kl_grads(cmu[m], clv[m], cg)
            else:
                k_mu, k_lv = jsd_grads[m]
            g_cmu[m] = own * g_jmu + k_mu
            g_clv[m] = own * g_jlv + k_lv
    else:  # poe
        cg = beta * beta_content / bf
        mu_c, lv_c, ts_c = post[-1]
        k_mu, k_lv = kl_grads(mu_c, lv_c, cg)
        through_poe(range(m_count), mu_c, lv_c, ts_c, g_jmu + k_mu,
                    g_jlv + k_lv)
    g_style_uni = [None] * m_count
    for e, u in enumerate(unis):
        g_zsu, g_zcu = nets.decode_bwd(e, u["dec"])
        g_mu_u, g_lv_u = reparam_bwd(g_zcu, u["uj"], u["lv"])
        g_smuu, g_slvu = reparam_bwd(g_zsu, u["us"], u["slv"])
        mu_s, lv_s, ts_s = post[e]
        # the unimodal ELBO's KL is the first encoding's subset {e}
        g_mu_s, g_lv_s = kl_grads(mu_s, lv_s, cg)
        if nets.reencode:
            # the second encoding takes the unimodal NLL's gradient alone
            gc, gt = poe_with_prior_bwd(u["cmu"], u["t"], u["ts"], u["mu"],
                                        g_mu_u, g_lv_u)
            nets.encode_bwd(e, u["cache"],
                            (gc, -gt * torch.exp(u["clv"]) * u["t"] * u["t"],
                             g_smuu, g_slvu))
        else:
            g_mu_s, g_lv_s = g_mu_s + g_mu_u, g_lv_s + g_lv_u
            g_style_uni[e] = (g_smuu, g_slvu)
        through_poe((e,), mu_s, lv_s, ts_s, g_mu_s, g_lv_s)

    cs = beta * beta_style * beta_style / bf * (2.0 if uni else 1.0)
    for e in range(m_count):
        # d t / d clv = -exp(clv) t^2
        g_clv[e] = g_clv[e] - g_t[e] * ev[e] * t[e] * t[e]
        g_smu, g_slv = reparam_bwd(g_zs[e], es[e], slv[e])
        k_mu, k_lv = kl_grads(smu[e], slv[e], cs)
        g_smu, g_slv = g_smu + k_mu, g_slv + k_lv
        if g_style_uni[e] is not None:
            g_smu = g_smu + g_style_uni[e][0]
            g_slv = g_slv + g_style_uni[e][1]
        nets.encode_bwd(e, enc[e][0], (g_cmu[e], g_clv[e], g_smu, g_slv))
    return loss, metrics
