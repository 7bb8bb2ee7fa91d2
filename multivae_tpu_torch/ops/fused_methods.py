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
``fused_step`` for it); with dropout it takes this step. The kernel is
persistent: on CUDA tensors :func:`method_epoch_flat` runs a whole group of
steps with Adam inside in ONE cooperative launch (the TPU kernel's epoch
contract), and one step is the same kernel with ``n = 1`` and Adam off.

Noise ``[B, noise_width]``: ``cd | s1 | s2``; poe appends the unimodal
draws ``cd | s1`` and ``cd | s2``. Dropout masks are pre-scaled keep masks
``[B, hidden]`` (values in ``{0, 1 / (1 - rate)}``) applied after the
encoders' ReLU: ``(dm1, dm2)``, for poe ``(dm1, dm2, dm1u, dm2u)``, whose
unimodal ELBOs re-encode with the fresh masks. On CUDA tensors a step
launches the kernel, on CPU tensors it runs the plain version; a kernel
that does not build or launch raises.

With ``row_offset`` and ``b_total`` the step runs on one shard's row slice
of a batch (the TPU kernel ``fused_sharded._dp_method_kernel``): every row
partition and normalization is the whole batch's, the outputs are partial
sums. :func:`slice_method_step_flat` launches the kernel's row-slice entry
point and counts under ``dp_method_step``.
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
from .adam import AdamHyper, adam_scalars, adam_update
from .fused_step import (
    LOG2PI,
    POE_EPS,
    FusedConsts,
    _uniform_bounds,
    argtypes_of,
    check_inputs,
    check_phase_times,
    check_slice,
    check_stack,
    split_layout_ok,
    workspace,
)

METHODS = ("joint_elbo", "moe", "jsd", "poe")
PORTED_METHODS = METHODS

# launches of each kernel in this module; a caller resets and reads it
KERNEL_LAUNCHES: Dict[str, int] = {"method_step": 0, "dp_method_step": 0}
# train steps run by those launches (one launch may run a group of steps)
KERNEL_STEPS: Dict[str, int] = {"method_step": 0, "dp_method_step": 0}


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


def mean_or_zero(t):
    """The mean of ``t``, 0 for an empty tensor (a style latent of width
    0, whose metric the step still carries)."""
    return t.mean() if t.numel() else t.new_zeros(())


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


def row_masks(b: int, k: int, device, row_offset: int = 0, b_total=None):
    """The k-way uniform stratified row partition as float masks
    ``[b, 1]``; with ``b_total`` the partition of a batch of ``b_total``
    rows restricted to its rows ``[row_offset, row_offset + b)``."""
    total = b if b_total is None else b_total
    rows = torch.arange(b, device=device)[:, None] + row_offset
    edges = [0] + _uniform_bounds(total, k) + [total]
    return [((rows >= lo) & (rows < hi)).float()
            for lo, hi in zip(edges[:-1], edges[1:])]


# ------------------------------------------------------------ plain version
class SplitNets:
    """The split layout's networks as :func:`latent_fwd_bwd` takes them:
    one hidden layer per encoder (keep masks ``(dm1, dm2)``, for poe
    ``(dm1, dm2, dm1u, dm2u)``, or none) and linear decoders. ``g`` holds
    the gradient of every split tensor; the backward pieces add into it."""

    def __init__(self, sp, xs, b: float, learn_scale: bool, masks=None):
        self.sp, self.xs, self.b = sp, xs, b
        self.learn_scale = learn_scale
        self.masks = masks
        # poe's unimodal pass re-encodes under masks of its own
        self.reencode = masks is not None
        self.g = {n: torch.zeros_like(v) for n, v in sp.items()}

    def encode(self, e: int, p: int):
        """``(cache, (cmu, clv, smu, slv))`` of encoder ``e`` in pass ``p``
        (0 the main pass, 1 poe's unimodal one)."""
        dm = None if self.masks is None else self.masks[2 * p + e]
        h, *heads = encode(self.sp, f"enc{e + 1}", self.xs[e], dm)
        return (h, dm), tuple(heads)

    def encode_bwd(self, e: int, cache, head_grads) -> None:
        h, dm = cache
        encode_bwd(self.sp, self.g, f"enc{e + 1}", self.xs[e], h, dm,
                   head_grads)

    def decode(self, e: int, p: int, zs, zc):
        """``(nll, cache)`` of decoder ``e`` in pass ``p``."""
        nll, r, iv = decode_nll(self.sp, f"dec{e + 1}", self.xs[e], zs, zc,
                                self.b)
        return nll, (r, iv, zs, zc)

    def decode_bwd(self, e: int, cache):
        """``(g_zs, g_zc)``; the decoder's gradients add into ``g``."""
        r, iv, zs, zc = cache
        return decode_bwd(self.sp, self.g, f"dec{e + 1}", r, iv, zs, zc,
                          self.b, self.learn_scale)


def latent_fwd_bwd(method: str, nets, noise, rows: int, cd: int, s1: int,
                   s2: int, consts: FusedConsts, row_offset: int = 0,
                   b_total=None):
    """The loss of one complete step around any encoders and decoders:
    ``(loss, metrics[17 | 19])``, the networks' gradients left in ``nets``.

    ``nets`` gives ``encode(e, p)``, ``encode_bwd(e, cache, head_grads)``,
    ``decode(e, p, zs, zc)``, ``decode_bwd(e, cache)`` and ``reencode``
    (:class:`SplitNets`); between them stands the method's latent math,
    forward and hand-derived backward: the subset posteriors, the joint
    selection, the reparameterization with ``noise``, the divergence, the
    style KLs and, for poe, the unimodal ELBOs. The rows at hand are rows
    ``[row_offset, row_offset + rows)`` of a batch of ``b_total``."""
    bt = rows if b_total is None else b_total
    b = float(bt)

    def masks_of(k):
        return row_masks(rows, k, noise.device, row_offset, bt)

    beta, beta_style, beta_content = consts
    (c1, (cmu1, clv1, smu1, slv1)), (c2, (cmu2, clv2, smu2, slv2)) = (
        nets.encode(e, 0) for e in range(2))
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
        m_a, m_b, m_c = masks_of(3)
        lv_a, lv_b = -torch.log(t1), -torch.log(t2)
        joint_mu = m_a * cmu1 + m_b * cmu2 + m_c * mu_c
        joint_lv = m_a * lv_a + m_b * lv_b + m_c * lv_c
        kld_a, kld_b, kld_c = (kl_sum(cmu1, lv_a, b), kl_sum(cmu2, lv_b, b),
                               kl_sum(mu_c, lv_c, b))
        group_div = (kld_a + kld_b + kld_c) / 3.0
    elif method == "moe":
        m_a, m_b = masks_of(2)
        joint_mu = m_a * cmu1 + m_b * cmu2
        joint_lv = m_a * clv1 + m_b * clv2
        kld_a, kld_b = kl_sum(cmu1, clv1, b), kl_sum(cmu2, clv2, b)
        kld_c = kl_sum(joint_mu, joint_lv, b)  # a metric only
        group_div = (kld_a + kld_b) / 2.0
    elif method == "jsd":
        m_a, m_b, _ = masks_of(3)
        joint_mu = m_a * cmu1 + m_b * cmu2  # unit rows: mu = 0
        joint_lv = m_a * clv1 + m_b * clv2  # unit rows: logvar = 0
        pm_a, pm_b = masks_of(2)
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
    nll1, d1 = nets.decode(0, 0, zs1, zc)
    nll2, d2 = nets.decode(1, 0, zs2, zc)
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
        for e, (heads, t, post) in enumerate((
                ((cmu1, clv1, smu1, slv1), t1, (mu_a, lv_a, ts_a)),
                ((cmu2, clv2, smu2, slv2), t2, (mu_b, lv_b, ts_b)))):
            cache = None
            if nets.reencode:
                cache, heads = nets.encode(e, 1)
                t = 1.0 / (torch.exp(heads[1]) + POE_EPS)
                post = poe_with_prior(heads[0], t)
            cmuu, clvu, smuu, slvu = heads
            mu_u, lv_u, ts_u = post
            zcu = mu_u + uj[e] * torch.exp(0.5 * lv_u)
            zsu = smuu + us[e] * torch.exp(0.5 * slvu)
            nll_u, dec_u = nets.decode(e, 1, zsu, zcu)
            uni.append(dict(cache=cache, cmu=cmuu, clv=clvu, slv=slvu, t=t,
                            mu=mu_u, lv=lv_u, ts=ts_u, nll=nll_u, dec=dec_u))
        loss = (uni[0]["nll"] + uni[1]["nll"] + nll1 + nll2
                + beta * (beta_content * (kld_a + kld_b + group_div)
                          + 2.0 * style))
        extra = [uni[0]["nll"], uni[1]["nll"]]

    metrics = torch.stack([
        loss, group_div, nll1, nll2, kld_a, kld_b, kld_c, kld_s1, kld_s2]
        + [mean_or_zero(t) for t in (cmu1, clv1, smu1, slv1,
                                     cmu2, clv2, smu2, slv2)] + extra)

    # ---------------- backward ----------------
    g_zs1, g_zc1 = nets.decode_bwd(0, d1)
    g_zs2, g_zc2 = nets.decode_bwd(1, d2)
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
            g_zsu, g_zcu = nets.decode_bwd(e, u["dec"])
            g_mu_u, g_lv_u = reparam_bwd(g_zcu, uj[e], u["lv"])
            g_smuu, g_slvu = reparam_bwd(g_zsu, us[e], u["slv"])
            cmu, t, mu_s, lv_s, ts_s = first[e]
            # the subset KL is the first pass's, in both cases
            g_mu_s, g_lv_s = kl_grads(mu_s, lv_s, cg)
            if nets.reencode:
                # the second pass takes the unimodal NLL's gradient alone
                gc, gt = poe_with_prior_bwd(u["cmu"], u["t"], u["ts"],
                                            u["mu"], g_mu_u, g_lv_u)
                nets.encode_bwd(
                    e, u["cache"],
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
    nets.encode_bwd(0, c1, (g_cmu1, g_clv1) + heads[0])
    nets.encode_bwd(1, c2, (g_cmu2, g_clv2) + heads[1])
    return loss, metrics


def method_fwd_bwd_reference(method: str, sp, x1, x2, noise, dims: FusedDims,
                             consts: FusedConsts, learn_scale: bool = True,
                             dropout_masks: Optional[Sequence] = None,
                             row_offset: int = 0, b_total=None):
    """Plain PyTorch version of the kernel: ``(loss, metrics[17 | 19],
    grads)`` of ``method_loss_split`` with a hand-derived backward;
    ``grads`` a dict of the split tensors' gradients. ``row_offset`` /
    ``b_total`` as there: the inputs (noise and masks too) are rows
    ``[row_offset, row_offset + dims.b)`` of a batch of ``b_total``; the
    partitions use global row indices, the sums are divided by ``b_total``
    and the latent means stay local."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    n_masks = 0 if dropout_masks is None else len(dropout_masks)
    if n_masks not in (0, 4 if method == "poe" else 2):
        raise ValueError(f"{method} takes {4 if method == 'poe' else 2} "
                         f"dropout masks, got {n_masks}")
    row_offset, bt = check_slice("method_fwd_bwd_reference", dims.b,
                                 row_offset, b_total)
    nets = SplitNets(sp, (x1, x2), float(bt), learn_scale,
                     dropout_masks if n_masks else None)
    loss, metrics = latent_fwd_bwd(method, nets, noise, dims.b, dims.cd,
                                   dims.s1, dims.s2, consts, row_offset, bt)
    return loss, metrics, {n: nets.g[n] for n in SPLIT_NAMES}


# ------------------------------------------------------------------ kernel
# The C arguments of ``method_epoch_launch`` in order: (name, kind), kinds
# as in ``fused_step.EPOCH_ARGS``.
EPOCH_ARGS = (
    ("params", "ptr"), ("mu", "ptr"), ("nu", "ptr"), ("grads", "ptr"),
    ("metrics", "ptr"), ("x1s", "ptr"), ("x2s", "ptr"), ("noise", "ptr"),
    ("masks", "ptr"), ("work", "ptr"),
    ("n", "i32"), ("method", "i32"), ("b", "i32"), ("d1", "i32"),
    ("d2", "i32"), ("h", "i32"), ("cd", "i32"), ("s1", "i32"), ("s2", "i32"),
    ("beta", "f32"), ("beta_style", "f32"), ("beta_content", "f32"),
    ("learn_scale", "i32"), ("count", "i64"),
    ("lr", "f32"), ("b1", "f32"), ("b2", "f32"), ("one_minus_b1", "f32"),
    ("one_minus_b2", "f32"), ("log_b1", "f32"), ("log_b2", "f32"),
    ("eps", "f32"),
    ("phase_times", "ptr"), ("stream", "ptr"),
)


def pack_epoch_args(p, mu, nu, grads, metrics, x1s, x2s, noise, masks, work,
                    method: str, dims: FusedDims, consts: FusedConsts,
                    learn_scale: bool, count: int, hyper: AdamHyper,
                    stream: int, phase_times=None) -> tuple:
    """The arguments of ``method_epoch_launch`` in :data:`EPOCH_ARGS` order
    (``masks`` None becomes a null pointer). Pure: it reads only addresses
    and shapes."""
    return (
        p.data_ptr(), mu.data_ptr(), nu.data_ptr(), grads.data_ptr(),
        metrics.data_ptr(), x1s.data_ptr(), x2s.data_ptr(),
        noise.data_ptr(), None if masks is None else masks.data_ptr(),
        work.data_ptr(), int(x1s.shape[0]), METHODS.index(method), dims.b,
        dims.d1, dims.d2, dims.h, dims.cd, dims.s1, dims.s2,
        *(float(c) for c in consts), int(bool(learn_scale)), int(count),
        *adam_scalars(hyper),
        None if phase_times is None else phase_times.data_ptr(), int(stream))


def _method_library():
    from ._build import load_kernel

    lib = load_kernel("method_step")
    if lib.method_step_launch.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.method_step_launch.argtypes = (
            [ptr] * 6 + [i32] + [ptr] * 4 + [i32, ptr] + [i32] * 8
            + [f32] * 3 + [i32, ptr])
        lib.method_step_launch.restype = i32
        lib.method_step_slice_launch.argtypes = (
            [ptr] * 6 + [i32] + [ptr] * 4 + [i32, ptr] + [i32] * 10
            + [f32] * 3 + [i32, ptr])
        lib.method_step_slice_launch.restype = i32
        lib.method_epoch_launch.argtypes = argtypes_of(EPOCH_ARGS)
        lib.method_epoch_launch.restype = i32
        lib.method_step_workspace_floats.argtypes = [i32] * 9
        lib.method_step_workspace_floats.restype = ctypes.c_longlong
        lib.method_step_grid_blocks.argtypes = [i32] * 9
        lib.method_step_grid_blocks.restype = i32
        lib.method_step_barriers.argtypes = [i32]
        lib.method_step_barriers.restype = i32
        lib.method_step_error_string.argtypes = [i32]
        lib.method_step_error_string.restype = ctypes.c_char_p
    return lib


def launch_geometry(dims: FusedDims, device, method: str,
                    has_masks: bool = False) -> Dict[str, int]:
    """Of the persistent kernel at these sizes on ``device``: the blocks of
    its cooperative grid and the grid barriers of one step with and without
    the in-kernel Adam update."""
    lib = _method_library()
    with torch.cuda.device(device):
        blocks = lib.method_step_grid_blocks(
            METHODS.index(method), int(has_masks), dims.b, dims.d1, dims.d2,
            dims.h, dims.cd, dims.s1, dims.s2)
    if blocks < 0:
        raise RuntimeError("method_step: "
                           + lib.method_step_error_string(-blocks).decode())
    return {"grid_blocks": blocks,
            "barriers_per_step_adam": lib.method_step_barriers(1),
            "barriers_per_step": lib.method_step_barriers(0)}


def step_noise_width(method: str, dims: FusedDims) -> int:
    """Noise columns of one step: ``cd | s1 | s2``, poe's unimodal draws
    after them."""
    width = dims.cd + dims.s1 + dims.s2
    if method == "poe":
        width += 2 * dims.cd + dims.s1 + dims.s2
    return width


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
                   grads, row_slice=None):
    """Launch the step (``row_slice=None``, counted as ``method_step``) or
    its row-slice entry point (``row_slice=(row_offset, b_total)``, counted
    as ``dp_method_step``)."""
    device = p.device
    b = dims.b
    check_inputs("method_step", device, [
        (p, (flat_size(dims),)), (grads, (flat_size(dims),)),
        (metrics, (n_method_metrics(method),)),
        (x1, (b, dims.d1)), (x2, (b, dims.d2)),
        (noise, (b, step_noise_width(method, dims)))])
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
    launch, counter, rows = lib.method_step_launch, "method_step", (b,)
    if row_slice is not None:
        launch, counter = lib.method_step_slice_launch, "dp_method_step"
        rows = (b,) + tuple(row_slice)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = launch(
            p.data_ptr(), grads.data_ptr(), metrics.data_ptr(),
            x1.data_ptr(), x2.data_ptr(), noise.data_ptr(), noise.stride(0),
            *mask_ptrs, ld_mask, work.data_ptr(), method_idx, *rows, *widths,
            *(float(c) for c in consts), int(bool(learn_scale)), stream)
    if rc != 0:
        raise RuntimeError(f"{counter} launch failed: "
                           + lib.method_step_error_string(rc).decode())
    KERNEL_LAUNCHES[counter] += 1
    KERNEL_STEPS[counter] += 1


def _check_epoch_stacks(p, x1s, x2s, noise, masks, dims: FusedDims,
                        method: str) -> None:
    """The stacked inputs of a group of steps: contiguous float32 on the
    params' device, ``x1s [n, B, d1]``, ``x2s [n, B, d2]``, ``noise [n, B,
    w]``, ``masks [n, 2 | 4, B, hidden]`` or None."""
    n, b = int(x1s.shape[0]), dims.b
    check_stack("method_step", p.device, x1s, (n, b, dims.d1))
    check_stack("method_step", p.device, x2s, (n, b, dims.d2))
    check_stack("method_step", p.device, noise,
                (n, b, step_noise_width(method, dims)))
    if masks is not None:
        check_stack("method_step", p.device, masks,
                    (n, 4 if method == "poe" else 2, b, dims.h))


def _launch_method_epoch(method: str, p, mu, nu, count, x1s, x2s, noise,
                         dims: FusedDims, consts: FusedConsts,
                         hyper: AdamHyper, learn_scale: bool, masks,
                         phase_times=None):
    """ONE launch for the whole group of steps (its stacks checked by the
    caller); returns ``metrics [n, 17 | 19]``."""
    device = p.device
    n, b = int(x1s.shape[0]), dims.b
    check_inputs("method_step", device, [
        (t, (flat_size(dims),)) for t in (p, mu, nu)])
    check_phase_times("method_step", device, phase_times, n)
    metrics = torch.empty(n, n_method_metrics(method), dtype=torch.float32,
                          device=device)
    if n == 0:
        return metrics
    grads = torch.empty_like(p)
    lib = _method_library()
    work = workspace(lib, "method_step", device, METHODS.index(method),
                     int(masks is not None), b, dims.d1, dims.d2, dims.h,
                     dims.cd, dims.s1, dims.s2)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.method_epoch_launch(*pack_epoch_args(
            p, mu, nu, grads, metrics, x1s, x2s, noise, masks, work, method,
            dims, consts, learn_scale, count, hyper, stream, phase_times))
    if rc != 0:
        raise RuntimeError("method_step epoch launch failed: "
                           + lib.method_step_error_string(rc).decode())
    KERNEL_LAUNCHES["method_step"] += 1
    KERNEL_STEPS["method_step"] += n
    return metrics


def _method_step_flat(method, p, x1, x2, noise, dims, consts, learn_scale,
                      dropout_masks, row_slice):
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if p.device.type == "cuda":
        metrics = torch.empty(n_method_metrics(method), dtype=torch.float32,
                              device=p.device)
        grads = torch.empty_like(p)
        _launch_method(method, p, x1, x2, noise, dims, consts, learn_scale,
                       dropout_masks, metrics, grads, row_slice)
        return metrics, grads
    if p.device.type == "cpu":
        row_offset, b_total = row_slice or (0, None)
        _, metrics, g = method_fwd_bwd_reference(
            method, flat_views(p, dims), x1, x2, noise, dims, consts,
            learn_scale, dropout_masks, row_offset, b_total)
        return metrics, flatten_split(g)
    raise ValueError(f"method_step: no kernel for {p.device}")


def method_step_flat(method: str, p, x1, x2, noise, dims: FusedDims,
                     consts: FusedConsts, learn_scale: bool = True,
                     dropout_masks=None):
    """One step on a flat params buffer: ``(metrics[17 | 19], grads)``,
    ``grads`` a new flat buffer of the split layout. The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    return _method_step_flat(method, p, x1, x2, noise, dims, consts,
                             learn_scale, dropout_masks, None)


def slice_method_step_flat(method: str, p, x1, x2, noise, dims: FusedDims,
                           consts: FusedConsts, learn_scale: bool,
                           dropout_masks, row_offset: int, b_total: int):
    """:func:`method_step_flat` on rows ``[row_offset, row_offset +
    dims.b)`` of a batch of ``b_total`` (noise and masks row-sliced
    alike): partial ``(metrics, grads)`` whose sum over the shards is the
    whole batch's (the latent means after ``mean_rescale``). The kernel's
    row-slice entry point for CUDA tensors, the plain version for CPU
    tensors."""
    return _method_step_flat(
        method, p, x1, x2, noise, dims, consts, learn_scale, dropout_masks,
        check_slice("dp_method_step", dims.b, row_offset, b_total))


def method_epoch_flat(method: str, p, mu, nu, count: int, x1s, x2s, noise,
                      dims: FusedDims, consts: FusedConsts, hyper: AdamHyper,
                      learn_scale: bool = True, masks=None, phase_times=None):
    """``n`` steps on flat buffers, each followed by Adam at
    ``t = count + step + 1``; ``p``, ``mu`` and ``nu`` are updated in place.
    ``noise [n, B, noise_width]``, ``masks [n, 2 | 4, B, hidden]`` or None.
    Returns ``metrics [n, 17 | 19]`` (on the buffers' device; nothing is
    fetched). On CUDA tensors the whole group is ONE launch of the
    persistent kernel (stacks contiguous float32 on the params' device,
    else it raises); on CPU tensors the host loops the plain step and the
    plain Adam. ``phase_times``: tracing, as in ``fused_step.epoch_flat``
    (the kernel has the same eight phases)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if p.device.type not in ("cuda", "cpu"):
        raise ValueError(f"method_step: no kernel for {p.device}")
    _check_epoch_stacks(p, x1s, x2s, noise, masks, dims, method)
    if p.device.type == "cuda":
        return _launch_method_epoch(method, p, mu, nu, count, x1s, x2s,
                                    noise, dims, consts, hyper, learn_scale,
                                    masks, phase_times)
    if phase_times is not None:
        raise ValueError("method_step: phase_times traces the kernel; the "
                         "plain version has no phases")
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
