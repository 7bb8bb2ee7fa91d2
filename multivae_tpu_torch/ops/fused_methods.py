"""Method-dispatched train steps of complete batches: a hand-written CUDA
kernel and its plain PyTorch version.

Counterpart of ``multivae_tpu/ops/fused_methods.py``. The TPU kernel
``_method_epoch_kernel`` trains complete batches of any row count for the
four methods, with optional streamed dropout masks, and gets its backward
from ``jax.value_and_grad`` of ``method_loss_split`` inside the kernel.
The port derives the backward by hand: :func:`method_fwd_bwd_reference`
(plain) and ``csrc/method_step.cu`` (kernel), for moe, jsd, poe and
``joint_elbo``. ``joint_elbo`` without dropout keeps its route to the MoPoE
step of :mod:`.fused_step` (the trainer decides, as the JAX package keeps
``fused_step`` for it); with dropout it takes this step.

Noise ``[B, noise_width]``: ``cd | s1 | s2``; poe appends the unimodal
draws ``cd | s1`` and ``cd | s2``. Dropout masks are pre-scaled keep masks
``[B, hidden]`` (values in ``{0, 1 / (1 - rate)}``) applied after the
encoders' ReLU: ``(dm1, dm2)``, for poe ``(dm1, dm2, dm1u, dm2u)``, whose
unimodal ELBOs re-encode with the fresh masks. On CUDA tensors a step
launches the kernel, on CPU tensors it runs the plain version; a kernel
that does not build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..params import (
    SPLIT_NAMES,
    FusedDims,
    flat_size,
    flat_views,
    flatten_split,
)
from .adam import AdamHyper, adam_update
from .fused_step import (
    LOG2PI,
    POE_EPS,
    FusedConsts,
    _uniform_bounds,
    check_inputs,
    split_layout_ok,
    workspace,
)

METHODS = ("joint_elbo", "moe", "jsd", "poe")
PORTED_METHODS = METHODS

# launches of each kernel in this module; a caller resets and reads it
KERNEL_LAUNCHES: Dict[str, int] = {"method_step": 0}


def method_metric_names(model, method: str) -> Tuple[str, ...]:
    """Scalar families per step: ``fused_step.metric_names`` plus, for poe,
    the unimodal reconstruction terms."""
    m1, m2 = (m.name for m in model.modalities)
    joint = "_".join(sorted([m1, m2]))
    names = [
        "loss", "joint_divergence",
        f"log_prob/{m1}", f"log_prob/{m2}",
        f"kld/{m1}", f"kld/{m2}", f"kld/{joint}",
        f"kld_style/{m1}_style", f"kld_style/{m2}_style",
        f"latent_mu/{m1}", f"latent_logvar/{m1}",
        f"latent_mu/{m1}_style", f"latent_logvar/{m1}_style",
        f"latent_mu/{m2}", f"latent_logvar/{m2}",
        f"latent_mu/{m2}_style", f"latent_logvar/{m2}_style",
    ]
    if method == "poe":
        names += [f"log_prob_uni/{m1}", f"log_prob_uni/{m2}"]
    return tuple(names)


def n_method_metrics(method: str) -> int:
    return 19 if method == "poe" else 17


def noise_width(cfg) -> int:
    """Noise columns per sample: ``cd | s1 | s2``, plus for poe one
    unimodal draw per modality."""
    cd, (s1, s2) = cfg.class_dim, cfg.style_dim
    w = cd + s1 + s2
    if cfg.method == "poe":
        w += (cd + s1) + (cd + s2)
    return w


def n_dropout_masks(method: str, rate: float) -> int:
    """Keep masks streamed per complete step: one per encoder pass."""
    if rate <= 0.0:
        return 0
    return 4 if method == "poe" else 2


def supports_method_fused(cfg, model, batch) -> bool:
    """The TPU kernel's eligibility (``multivae_tpu``
    ``supports_method_fused`` less its VMEM guard): the split-layout
    architecture with any of the four methods, every modality present."""
    names = [m.name for m in model.modalities]
    return (cfg.method in METHODS
            and split_layout_ok(cfg, model)
            and all(n in batch for n in names)
            and (cfg.method != "poe" or cfg.poe_unimodal_elbos))


# ---------------------------------------------- pieces of the plain versions
# Shared by :func:`method_fwd_bwd_reference` and
# ``fused_presence.presence_fwd_bwd_reference``. ``g`` is the dict of split
# gradients; the backward pieces add into it.
def encode(sp, e: str, x, dm=None):
    """``(h, cmu, clv, smu, slv)`` of encoder ``e``; ``h`` is the hidden
    activation after ReLU and the keep mask ``dm``."""
    h = torch.relu(x @ sp[f"{e}_Wh"] + sp[f"{e}_bh"])
    if dm is not None:
        h = h * dm
    return (h,) + tuple(h @ sp[f"{e}_W{k}"] + sp[f"{e}_b{k}"]
                        for k in ("cmu", "clv", "smu", "slv"))


def encode_bwd(sp, g, e: str, x, h, dm, head_grads) -> None:
    """Backward of :func:`encode` from the four heads' gradients. Where
    ``dm`` is 0 the unit's gradient is 0; elsewhere ``h > 0`` is the
    ReLU's mask."""
    g_h = torch.zeros_like(h)
    for k, gh in zip(("cmu", "clv", "smu", "slv"), head_grads):
        g[f"{e}_W{k}"] += h.T @ gh
        g[f"{e}_b{k}"] += gh.sum(0)
        g_h = g_h + gh @ sp[f"{e}_W{k}"].T
    g_h = g_h * (h > 0.0).float()
    if dm is not None:
        g_h = g_h * dm
    g[f"{e}_Wh"] += x.T @ g_h
    g[f"{e}_bh"] += g_h.sum(0)


def decode_nll(sp, d: str, x, zs, zc, b: float):
    """``(nll, r, iv)``: the decoder's Gaussian NLL summed over features
    and divided by ``b``, the residual and the inverse output variance."""
    olv = sp[f"{d}_olv"]
    loc = zs @ sp[f"{d}_Wds"] + zc @ sp[f"{d}_Wdc"] + sp[f"{d}_bd"]
    r = x - loc
    iv = torch.exp(-olv)
    nll = torch.sum(0.5 * LOG2PI + 0.5 * olv
                    + 0.5 * torch.square(r) * iv) / b
    return nll, r, iv


def decode_bwd(sp, g, d: str, r, iv, zs, zc, b: float, learn_scale: bool):
    """Backward of :func:`decode_nll`; returns ``(g_zs, g_zc)``."""
    g_loc = -r * iv / b
    g[f"{d}_Wds"] += zs.T @ g_loc
    g[f"{d}_Wdc"] += zc.T @ g_loc
    g[f"{d}_bd"] += g_loc.sum(0)
    if learn_scale:
        g[f"{d}_olv"] += torch.sum(0.5 - 0.5 * torch.square(r) * iv, 0,
                                   keepdim=True) / b
    return g_loc @ sp[f"{d}_Wds"].T, g_loc @ sp[f"{d}_Wdc"].T


def kl_sum(mu, lv, b: float):
    return -0.5 * torch.sum(1.0 - torch.exp(lv) - torch.square(mu) + lv) / b


def kl_grads(mu, lv, c: float):
    """Gradients of ``c b kl_sum(mu, lv)`` w.r.t. ``mu`` and ``lv``."""
    return c * mu, c * 0.5 * (torch.exp(lv) - 1.0)


def poe_with_prior(cmu, t):
    """PoE of one expert (precision ``t``) with the unit prior expert:
    ``(mu, lv, ts)``."""
    ts = t + 1.0 / (1.0 + POE_EPS)
    return cmu * t / ts, -torch.log(ts), ts


def poe_with_prior_bwd(cmu, t, ts, mu, g_mu, g_lv):
    """``(g_cmu, g_t)`` of :func:`poe_with_prior`."""
    return g_mu * t / ts, g_mu * (cmu - mu) / ts - g_lv / ts


def jsd_prior(experts, b: float, c: float):
    """The alpha-JSD of ``experts`` (``(cmu, clv, t)`` each) and a unit
    expert against their uniform-alpha PoE prior: ``(sum of the KLs / b,
    per-expert (g_cmu, g_clv))`` with the gradients of ``c b`` times that
    sum. The prior has precision ``S / n`` and mean ``sum(cmu t) / S``,
    ``S = sum(t) + 1 / (1 + eps)``, ``n = len(experts) + 1``."""
    n = len(experts) + 1
    big_s = sum(t for _, _, t in experts) + 1.0 / (1.0 + POE_EPS)
    pm = sum(cmu * t for cmu, _, t in experts) / big_s
    ipv = big_s / n  # exp(-plv)
    plv = -torch.log(ipv)
    total = 0.0
    g_pm = torch.zeros_like(pm)
    g_plv = torch.zeros_like(pm)
    direct = []
    zero = torch.zeros_like(pm)
    for cmu, clv in [(cmu, clv) for cmu, clv, _ in experts] + [(zero, zero)]:
        diff = cmu - pm
        ratio = torch.exp(clv - plv)
        total = total - 0.5 * torch.sum(
            1.0 - ratio - torch.square(diff) * ipv + clv - plv) / b
        g_pm = g_pm - c * diff * ipv
        g_plv = g_plv - c * 0.5 * (ratio + torch.square(diff) * ipv - 1.0)
        direct.append((c * diff * ipv, c * 0.5 * (ratio - 1.0)))
    grads = []
    for (cmu, clv, t), (d_mu, d_lv) in zip(experts, direct):
        g_t = g_pm * (cmu - pm) / big_s - g_plv / big_s
        grads.append((d_mu + g_pm * t / big_s,
                      d_lv - g_t * torch.exp(clv) * t * t))
    return total, grads


def reparam_bwd(g_z, eps, lv):
    """Gradients of ``z = mu + eps exp(lv / 2)`` w.r.t. ``(mu, lv)``."""
    return g_z, g_z * eps * 0.5 * torch.exp(0.5 * lv)


def row_masks(b: int, k: int, device):
    """The k-way uniform stratified row partition as float masks
    ``[b, 1]``."""
    rows = torch.arange(b, device=device)[:, None]
    edges = [0] + _uniform_bounds(b, k) + [b]
    return [((rows >= lo) & (rows < hi)).float()
            for lo, hi in zip(edges[:-1], edges[1:])]


# ------------------------------------------------------------ plain version
def method_fwd_bwd_reference(method: str, sp, x1, x2, noise, dims: FusedDims,
                             consts: FusedConsts, learn_scale: bool = True,
                             dropout_masks: Optional[Sequence] = None):
    """Plain PyTorch version of the kernel: ``(loss, metrics[17 | 19],
    grads)`` of ``method_loss_split`` with a hand-derived backward;
    ``grads`` a dict of the split tensors' gradients."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    n_masks = 0 if dropout_masks is None else len(dropout_masks)
    if n_masks not in (0, 4 if method == "poe" else 2):
        raise ValueError(f"{method} takes {4 if method == 'poe' else 2} "
                         f"dropout masks, got {n_masks}")
    b = float(dims.b)
    cd, s1, s2 = dims.cd, dims.s1, dims.s2
    beta, beta_style, beta_content = consts
    xs = (x1, x2)
    dm = dropout_masks if n_masks else (None, None)
    g = {n: torch.zeros_like(v) for n, v in sp.items()}

    (h1, cmu1, clv1, smu1, slv1), (h2, cmu2, clv2, smu2, slv2) = (
        encode(sp, f"enc{e + 1}", xs[e], dm[e]) for e in range(2))
    ev1, ev2 = torch.exp(clv1), torch.exp(clv2)
    t1, t2 = 1.0 / (ev1 + POE_EPS), 1.0 / (ev2 + POE_EPS)
    tp = 1.0 / (1.0 + POE_EPS)
    ej = noise[:, :cd]
    es = (noise[:, cd:cd + s1], noise[:, cd + s1:cd + s1 + s2])

    # ---------------- subsets, joint, group divergence ----------------
    if method in ("joint_elbo", "poe"):
        ts_c = t1 + t2 + tp
        mu_c = (cmu1 * t1 + cmu2 * t2) / ts_c
        lv_c = -torch.log(ts_c)
    if method == "joint_elbo":
        m_a, m_b, m_c = row_masks(dims.b, 3, x1.device)
        lv_a, lv_b = -torch.log(t1), -torch.log(t2)
        joint_mu = m_a * cmu1 + m_b * cmu2 + m_c * mu_c
        joint_lv = m_a * lv_a + m_b * lv_b + m_c * lv_c
        kld_a, kld_b, kld_c = (kl_sum(cmu1, lv_a, b), kl_sum(cmu2, lv_b, b),
                               kl_sum(mu_c, lv_c, b))
        group_div = (kld_a + kld_b + kld_c) / 3.0
    elif method == "moe":
        m_a, m_b = row_masks(dims.b, 2, x1.device)
        joint_mu = m_a * cmu1 + m_b * cmu2
        joint_lv = m_a * clv1 + m_b * clv2
        kld_a, kld_b = kl_sum(cmu1, clv1, b), kl_sum(cmu2, clv2, b)
        kld_c = kl_sum(joint_mu, joint_lv, b)  # a metric only
        group_div = (kld_a + kld_b) / 2.0
    elif method == "jsd":
        m_a, m_b, _ = row_masks(dims.b, 3, x1.device)
        joint_mu = m_a * cmu1 + m_b * cmu2  # unit rows: mu = 0
        joint_lv = m_a * clv1 + m_b * clv2  # unit rows: logvar = 0
        pm_a, pm_b = row_masks(dims.b, 2, x1.device)
        # metrics only
        kld_a, kld_b = kl_sum(cmu1, clv1, b), kl_sum(cmu2, clv2, b)
        kld_c = kl_sum(pm_a * cmu1 + pm_b * cmu2, pm_a * clv1 + pm_b * clv2,
                       b)
        jsd_sum, jsd_grads = jsd_prior(
            [(cmu1, clv1, t1), (cmu2, clv2, t2)], b,
            beta * beta_content / (3.0 * b))
        group_div = jsd_sum / 3.0
    else:  # poe
        mu_a, lv_a, ts_a = poe_with_prior(cmu1, t1)
        mu_b, lv_b, ts_b = poe_with_prior(cmu2, t2)
        joint_mu, joint_lv = mu_c, lv_c
        kld_a, kld_b, kld_c = (kl_sum(mu_a, lv_a, b), kl_sum(mu_b, lv_b, b),
                               kl_sum(mu_c, lv_c, b))
        group_div = kld_c

    # ---------------- reparameterize, decode, loss ----------------
    zc = joint_mu + ej * torch.exp(0.5 * joint_lv)
    zs1 = smu1 + es[0] * torch.exp(0.5 * slv1)
    zs2 = smu2 + es[1] * torch.exp(0.5 * slv2)
    nll1, r1, iv1 = decode_nll(sp, "dec1", x1, zs1, zc, b)
    nll2, r2, iv2 = decode_nll(sp, "dec2", x2, zs2, zc, b)
    kld_s1, kld_s2 = kl_sum(smu1, slv1, b), kl_sum(smu2, slv2, b)
    style = beta_style * beta_style * (kld_s1 + kld_s2)
    extra = []
    if method != "poe":
        loss = nll1 + nll2 + beta * (style + beta_content * group_div)
    else:
        off = cd + s1 + s2
        uj = (noise[:, off:off + cd],
              noise[:, off + cd + s1:off + 2 * cd + s1])
        us = (noise[:, off + cd:off + cd + s1],
              noise[:, off + 2 * cd + s1:off + 2 * cd + s1 + s2])
        # the unimodal passes: the first pass's posteriors, or under
        # dropout a second encoding with fresh masks
        uni = []
        for e, (first, t, post) in enumerate((
                ((h1, cmu1, clv1, smu1, slv1), t1, (mu_a, lv_a, ts_a)),
                ((h2, cmu2, clv2, smu2, slv2), t2, (mu_b, lv_b, ts_b)))):
            if n_masks:
                first = encode(sp, f"enc{e + 1}", xs[e], dm[2 + e])
                t = 1.0 / (torch.exp(first[2]) + POE_EPS)
                post = poe_with_prior(first[1], t)
            hu, cmuu, clvu, smuu, slvu = first
            mu_u, lv_u, ts_u = post
            zcu = mu_u + uj[e] * torch.exp(0.5 * lv_u)
            zsu = smuu + us[e] * torch.exp(0.5 * slvu)
            nll_u, r_u, iv_u = decode_nll(sp, f"dec{e + 1}", xs[e], zsu, zcu,
                                          b)
            uni.append(dict(h=hu, cmu=cmuu, clv=clvu, smu=smuu, slv=slvu,
                            t=t, mu=mu_u, lv=lv_u, ts=ts_u, zc=zcu, zs=zsu,
                            nll=nll_u, r=r_u, iv=iv_u))
        loss = (uni[0]["nll"] + uni[1]["nll"] + nll1 + nll2
                + beta * (beta_content * (kld_a + kld_b + group_div)
                          + 2.0 * style))
        extra = [uni[0]["nll"], uni[1]["nll"]]

    metrics = torch.stack([
        loss, group_div, nll1, nll2, kld_a, kld_b, kld_c, kld_s1, kld_s2,
        cmu1.mean(), clv1.mean(), smu1.mean(), slv1.mean(),
        cmu2.mean(), clv2.mean(), smu2.mean(), slv2.mean()] + extra)

    # ---------------- backward ----------------
    g_zs1, g_zc1 = decode_bwd(sp, g, "dec1", r1, iv1, zs1, zc, b,
                              learn_scale)
    g_zs2, g_zc2 = decode_bwd(sp, g, "dec2", r2, iv2, zs2, zc, b,
                              learn_scale)
    g_jmu, g_jlv = reparam_bwd(g_zc1 + g_zc2, ej, joint_lv)
    if method == "joint_elbo":
        cg = beta * beta_content / (3.0 * b)
        (k_mu_a, k_lv_a), (k_mu_b, k_lv_b), (k_mu_c, k_lv_c) = (
            kl_grads(cmu1, lv_a, cg), kl_grads(cmu2, lv_b, cg),
            kl_grads(mu_c, lv_c, cg))
        g_mu_c = m_c * g_jmu + k_mu_c
        g_lv_c = m_c * g_jlv + k_lv_c
        g_cmu1 = m_a * g_jmu + k_mu_a + g_mu_c * (t1 / ts_c)
        g_cmu2 = m_b * g_jmu + k_mu_b + g_mu_c * (t2 / ts_c)
        g_t1 = g_mu_c * (cmu1 - mu_c) / ts_c - g_lv_c / ts_c
        g_t2 = g_mu_c * (cmu2 - mu_c) / ts_c - g_lv_c / ts_c
        # d(-log t)/d clv = exp(clv) t
        g_clv1 = (m_a * g_jlv + k_lv_a) * ev1 * t1 - g_t1 * ev1 * t1 * t1
        g_clv2 = (m_b * g_jlv + k_lv_b) * ev2 * t2 - g_t2 * ev2 * t2 * t2
    elif method == "moe":
        cg = beta * beta_content / (2.0 * b)
        (k_mu_a, k_lv_a), (k_mu_b, k_lv_b) = (kl_grads(cmu1, clv1, cg),
                                              kl_grads(cmu2, clv2, cg))
        g_cmu1, g_clv1 = m_a * g_jmu + k_mu_a, m_a * g_jlv + k_lv_a
        g_cmu2, g_clv2 = m_b * g_jmu + k_mu_b, m_b * g_jlv + k_lv_b
    elif method == "jsd":
        (j_mu1, j_lv1), (j_mu2, j_lv2) = jsd_grads
        g_cmu1, g_clv1 = m_a * g_jmu + j_mu1, m_a * g_jlv + j_lv1
        g_cmu2, g_clv2 = m_b * g_jmu + j_mu2, m_b * g_jlv + j_lv2
    else:  # poe
        cg = beta * beta_content / b
        k_mu_c, k_lv_c = kl_grads(mu_c, lv_c, cg)
        g_mu_c, g_lv_c = g_jmu + k_mu_c, g_jlv + k_lv_c
        g_cmu = [g_mu_c * (t1 / ts_c), g_mu_c * (t2 / ts_c)]
        g_t = [g_mu_c * (cmu1 - mu_c) / ts_c - g_lv_c / ts_c,
               g_mu_c * (cmu2 - mu_c) / ts_c - g_lv_c / ts_c]
        g_style_uni = [None, None]
        first = ((cmu1, t1, mu_a, lv_a, ts_a), (cmu2, t2, mu_b, lv_b, ts_b))
        for e, u in enumerate(uni):
            d = f"dec{e + 1}"
            g_zsu, g_zcu = decode_bwd(sp, g, d, u["r"], u["iv"], u["zs"],
                                      u["zc"], b, learn_scale)
            g_mu_u, g_lv_u = reparam_bwd(g_zcu, uj[e], u["lv"])
            g_smuu, g_slvu = reparam_bwd(g_zsu, us[e], u["slv"])
            cmu, t, mu_s, lv_s, ts_s = first[e]
            # the subset KL is the first pass's, in both cases
            g_mu_s, g_lv_s = kl_grads(mu_s, lv_s, cg)
            if n_masks:
                # the second pass takes the unimodal NLL's gradient alone
                gc, gt = poe_with_prior_bwd(u["cmu"], u["t"], u["ts"],
                                            u["mu"], g_mu_u, g_lv_u)
                encode_bwd(sp, g, f"enc{e + 1}", xs[e], u["h"], dm[2 + e],
                           (gc, -gt * torch.exp(u["clv"]) * u["t"] * u["t"],
                            g_smuu, g_slvu))
            else:
                g_mu_s, g_lv_s = g_mu_s + g_mu_u, g_lv_s + g_lv_u
                g_style_uni[e] = (g_smuu, g_slvu)
            gc, gt = poe_with_prior_bwd(cmu, t, ts_s, mu_s, g_mu_s, g_lv_s)
            g_cmu[e] = g_cmu[e] + gc
            g_t[e] = g_t[e] + gt
        g_cmu1, g_cmu2 = g_cmu
        g_clv1 = -g_t[0] * ev1 * t1 * t1
        g_clv2 = -g_t[1] * ev2 * t2 * t2

    cs = beta * beta_style * beta_style / b
    if method == "poe":
        cs = 2.0 * cs  # each style KL is in the unimodal and the joint ELBO
    heads = []
    for e, (g_zs, smu, slv) in enumerate(((g_zs1, smu1, slv1),
                                          (g_zs2, smu2, slv2))):
        g_smu, g_slv = reparam_bwd(g_zs, es[e], slv)
        k_mu, k_lv = kl_grads(smu, slv, cs)
        g_smu, g_slv = g_smu + k_mu, g_slv + k_lv
        if method == "poe" and g_style_uni[e] is not None:
            g_smu = g_smu + g_style_uni[e][0]
            g_slv = g_slv + g_style_uni[e][1]
        heads.append((g_smu, g_slv))
    encode_bwd(sp, g, "enc1", x1, h1, dm[0], (g_cmu1, g_clv1) + heads[0])
    encode_bwd(sp, g, "enc2", x2, h2, dm[1], (g_cmu2, g_clv2) + heads[1])
    return loss, metrics, {n: g[n] for n in SPLIT_NAMES}


# ------------------------------------------------------------------ kernel
def _method_library():
    from ._build import load_kernel

    lib = load_kernel("method_step")
    if lib.method_step_launch.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.method_step_launch.argtypes = (
            [ptr] * 6 + [i32] + [ptr] * 4 + [i32, ptr] + [i32] * 8
            + [f32] * 3 + [i32, ptr])
        lib.method_step_launch.restype = i32
        lib.method_step_workspace_floats.argtypes = [i32] * 9
        lib.method_step_workspace_floats.restype = ctypes.c_longlong
        lib.method_step_error_string.argtypes = [i32]
        lib.method_step_error_string.restype = ctypes.c_char_p
    return lib


def check_masks(name: str, masks, n_expected: int, b: int, h: int, device):
    """The masks as a list of ``n_expected`` row-contiguous ``[b, h]``
    tensors sharing one row stride (or ``[]``)."""
    masks = [] if masks is None else list(masks)
    if len(masks) not in (0, n_expected):
        raise ValueError(f"{name} takes {n_expected} dropout masks, got "
                         f"{len(masks)}")
    check_inputs(name, device, [(m, (b, h)) for m in masks])
    if len({m.stride(0) for m in masks}) > 1:
        raise ValueError(f"{name} takes masks of one row stride")
    return masks


def _launch_method(method: str, p, x1, x2, noise, dims: FusedDims,
                   consts: FusedConsts, learn_scale: bool, masks, metrics,
                   grads):
    device = p.device
    b = dims.b
    width = dims.cd + dims.s1 + dims.s2
    if method == "poe":
        width += 2 * dims.cd + dims.s1 + dims.s2
    check_inputs("method_step", device, [
        (p, (flat_size(dims),)), (grads, (flat_size(dims),)),
        (metrics, (n_method_metrics(method),)),
        (x1, (b, dims.d1)), (x2, (b, dims.d2)), (noise, (b, width))])
    for t in (x1, x2):
        if not t.is_contiguous():
            raise ValueError("method_step takes contiguous batches")
    masks = check_masks("method_step", masks, 4 if method == "poe" else 2,
                        b, dims.h, device)
    mask_ptrs = [m.data_ptr() for m in masks] + [None] * (4 - len(masks))
    ld_mask = masks[0].stride(0) if masks else 0
    lib = _method_library()
    widths = (dims.d1, dims.d2, dims.h, dims.cd, dims.s1, dims.s2)
    method_idx = METHODS.index(method)
    work = workspace(lib, "method_step", device, method_idx,
                     int(bool(masks)), b, *widths)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.method_step_launch(
            p.data_ptr(), grads.data_ptr(), metrics.data_ptr(),
            x1.data_ptr(), x2.data_ptr(), noise.data_ptr(), noise.stride(0),
            *mask_ptrs, ld_mask, work.data_ptr(), method_idx, b, *widths,
            *(float(c) for c in consts), int(bool(learn_scale)), stream)
    if rc != 0:
        raise RuntimeError("method_step launch failed: "
                           + lib.method_step_error_string(rc).decode())
    KERNEL_LAUNCHES["method_step"] += 1


def method_step_flat(method: str, p, x1, x2, noise, dims: FusedDims,
                     consts: FusedConsts, learn_scale: bool = True,
                     dropout_masks=None):
    """One step on a flat params buffer: ``(metrics[17 | 19], grads)``,
    ``grads`` a new flat buffer of the split layout. The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if p.device.type == "cuda":
        metrics = torch.empty(n_method_metrics(method), dtype=torch.float32,
                              device=p.device)
        grads = torch.empty_like(p)
        _launch_method(method, p, x1, x2, noise, dims, consts, learn_scale,
                       dropout_masks, metrics, grads)
        return metrics, grads
    if p.device.type == "cpu":
        _, metrics, g = method_fwd_bwd_reference(
            method, flat_views(p, dims), x1, x2, noise, dims, consts,
            learn_scale, dropout_masks)
        return metrics, flatten_split(g)
    raise ValueError(f"method_step: no kernel for {p.device}")


def method_epoch_flat(method: str, p, mu, nu, count: int, x1s, x2s, noise,
                      dims: FusedDims, consts: FusedConsts, hyper: AdamHyper,
                      learn_scale: bool = True, masks=None):
    """``n`` steps on flat buffers, each followed by Adam at
    ``t = count + step + 1``; ``p``, ``mu`` and ``nu`` are updated in place.
    ``noise [n, B, noise_width]``, ``masks [n, 2 | 4, B, hidden]`` or None.
    Returns ``metrics [n, 17 | 19]`` (on the buffers' device)."""
    steps = []
    for i in range(x1s.shape[0]):
        metrics, grads = method_step_flat(
            method, p, x1s[i], x2s[i], noise[i], dims, consts, learn_scale,
            None if masks is None else masks[i])
        adam_update(p, mu, nu, grads, count + i + 1, hyper)
        steps.append(metrics)
    return torch.stack(steps)


def method_epoch(method: str, sp, mu, nu, count: int, x1s, x2s, noise,
                 dims: FusedDims, consts: FusedConsts, hyper: AdamHyper,
                 learn_scale: bool = True, masks=None):
    """``(sp, mu, nu, metrics[n, 17 | 19])`` of an epoch over complete
    batches from split params and moments (dicts), the contract of
    ``build_method_epoch`` with the noise and masks as inputs; the inputs
    are not modified."""
    p, m, v = (flatten_split(t) for t in (sp, mu, nu))
    metrics = method_epoch_flat(method, p, m, v, count, x1s, x2s, noise,
                                dims, consts, hyper, learn_scale, masks)
    return (flat_views(p, dims), flat_views(m, dims), flat_views(v, dims),
            metrics)
