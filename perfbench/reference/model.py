"""The multimodal VAE in plain PyTorch, from its equations.

Weights are a dict in the model's naming (``enc_<mod>.hidden_<i>.weight``
``[out, in]`` ...). Per modality ``m`` present in a batch:

* encoder: ``h = relu(x W_i^T + b_i)`` per hidden layer, then one head
  projection split into ``(content mu, content logvar, style mu, style
  logvar)``;
* every subset of the present modalities (sizes 1.. in combination order)
  has the product-of-experts posterior ``T = sum_m 1 / (exp(lv_m) + 1e-8)``
  (plus the unit prior's ``1 / (1 + 1e-8)`` on the subset of every
  modality), ``mu = sum_m mu_m / (exp(lv_m) + 1e-8) / T``, ``lv = -log T``;
* MoPoE (``joint_elbo``): the joint posterior of row ``b`` is the subset
  that owns it in the stratified partition (subset ``k`` of ``K`` owns
  ``floor(B / K)`` consecutive rows, the last the rest); the divergence is
  ``sum_k KL(subset k || N(0, I)) / (K B)``;
* ``z = mu + eps exp(lv / 2)`` with ``eps`` the batch's noise, content
  columns first, then each present modality's style in model order;
* decoder: ``concat(style z, content z)`` through its hidden layers, then
  the output mean and either the per-feature log-variance or a per-sample
  head's;
* loss: the normal negative log-likelihoods summed over elements over
  ``B``, plus ``beta (beta_style sum_m beta_style KL(style_m) / B +
  beta_content divergence)``.

``tf32=True`` rounds both operands of every product to TF32's 10-bit
mantissa first (round to nearest even): the precision one step below the
float32 the configurations state, used as the comparison's control.
"""

from __future__ import annotations

import math
from itertools import combinations
from typing import Dict, List, Sequence

import torch

LOG2PI = math.log(2.0 * math.pi)
POE_EPS = 1e-8
MOD_NAMES = ("clinical", "rois")


def mod_names(cfg: dict) -> List[str]:
    n = len(cfg["input_dim"])
    return [MOD_NAMES[m] if m < len(MOD_NAMES) else f"mod{m}"
            for m in range(n)]


def style_dims(cfg: dict) -> List[int]:
    if not cfg["factorized_representation"]:
        return [0] * len(cfg["input_dim"])
    return list(cfg["style_dim"])


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, nearest even), float32."""
    i = x.detach().contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    return torch.bitwise_and(i + 0x0FFF + lsb, ~0x1FFF).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``x @ w^T`` as a TF32 product: every operand of the forward and of
    the two backward products rounded to TF32, the sums in float32."""

    @staticmethod
    def forward(ctx, x, w):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.transpose(-1, -2)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_tf32(g)
        gw = gr.reshape(-1, gr.shape[-1]).transpose(0, 1) @ xr.reshape(
            -1, xr.shape[-1])
        return gr @ wr, gw


def linear(x, w, b, tf32: bool):
    if tf32:
        return _TF32Product.apply(x, w) + b
    return x @ w.transpose(-1, -2) + b


def encode(p: Dict[str, torch.Tensor], cfg: dict, mod: str, s: int, x,
           tf32: bool = False):
    """``(content mu, content logvar, style mu, style logvar)``."""
    h = x
    for i in range(cfg["num_hidden_layer_encoder"]):
        h = torch.relu(linear(h, p[f"enc_{mod}.hidden_{i}.weight"],
                              p[f"enc_{mod}.hidden_{i}.bias"], tf32))
    heads = linear(h, p[f"enc_{mod}.heads.weight"],
                   p[f"enc_{mod}.heads.bias"], tf32)
    cd = cfg["class_dim"]
    return (heads[..., :cd], heads[..., cd:2 * cd],
            heads[..., 2 * cd:2 * cd + s], heads[..., 2 * cd + s:])


def decode(p, cfg: dict, mod: str, d: int, zs, zc, tf32: bool = False):
    """``(loc, logvar)``; ``zs`` is None without a style latent. A
    per-feature log-variance is broadcast over the rows."""
    h = zc if zs is None else torch.cat([zs, zc], dim=-1)
    for i in range(cfg["num_hidden_layer_decoder"]):
        h = torch.relu(linear(h, p[f"dec_{mod}.hidden_{i}.weight"],
                              p[f"dec_{mod}.hidden_{i}.bias"], tf32))
    if cfg["learn_output_sample_scale"]:
        out = linear(h, p[f"dec_{mod}.out_heads.weight"],
                     p[f"dec_{mod}.out_heads.bias"], tf32)
        return out[..., :d], out[..., d:]
    loc = linear(h, p[f"dec_{mod}.out_mu.weight"],
                 p[f"dec_{mod}.out_mu.bias"], tf32)
    return loc, p[f"dec_{mod}.out_logvar"].expand_as(loc)


def subsets(names: Sequence[str], present: Sequence[str]):
    """The subsets of ``names`` whose members are all present, in
    combination order (sizes 1, 2, ...)."""
    out = []
    for n in range(1, len(names) + 1):
        for combo in combinations(names, n):
            if all(m in present for m in combo):
                out.append(combo)
    return out


def poe(mus, logvars, with_prior: bool):
    t = [1.0 / (torch.exp(lv) + POE_EPS) for lv in logvars]
    t_sum = sum(t[1:], t[0])
    if with_prior:
        t_sum = t_sum + 1.0 / (1.0 + POE_EPS)
    mu = sum((m * ti for m, ti in zip(mus[1:], t[1:])), mus[0] * t[0])
    return mu / t_sum, -torch.log(t_sum)


def partition(k: int, b: int) -> List[int]:
    """Owner subset of every row: ``floor(b / k)`` consecutive rows each,
    the last subset the rest."""
    per = b // k
    return [min(r // per, k - 1) if per else k - 1 for r in range(b)]


def kl_unit(mu, logvar):
    """``KL(N(mu, exp(logvar)) || N(0, I))`` summed over the last axis."""
    return -0.5 * (1.0 - torch.exp(logvar) - mu * mu + logvar).sum(dim=-1)


def posteriors(p, cfg: dict, batch: Dict[str, torch.Tensor],
               tf32: bool = False):
    """Per present modality its encoder outputs, and the subsets'
    ``(mu, logvar)`` stacked ``[K, ..., B, cd]`` (MoPoE: every subset
    joins the mixture)."""
    if cfg["method"] != "joint_elbo":
        raise NotImplementedError("the reference covers joint_elbo")
    names = mod_names(cfg)
    present = [m for m in names if m in batch]
    enc = {m: encode(p, cfg, m, s, batch[m], tf32)
           for m, s in zip(names, style_dims(cfg)) if m in batch}
    mus, lvs = [], []
    for combo in subsets(names, present):
        if len(combo) == 1:
            # a one-expert product: mu t / t, log(exp(lv) + eps)
            mu, lv = poe([enc[combo[0]][0]], [enc[combo[0]][1]], False)
        else:
            mu, lv = poe([enc[m][0] for m in combo],
                         [enc[m][1] for m in combo],
                         len(combo) == len(names))
        mus.append(mu)
        lvs.append(lv)
    return enc, torch.stack(mus), torch.stack(lvs)


def select_rows(stack, owner):
    """Row ``b`` of the subset that owns it: ``stack [K, ..., B, D]``."""
    k, b = stack.shape[0], stack.shape[-2]
    idx = torch.as_tensor(owner, device=stack.device)
    onehot = torch.nn.functional.one_hot(idx, k).to(stack.dtype)  # [B, K]
    return torch.einsum("k...bd,bk->...bd", stack, onehot)


def forward(p, cfg: dict, batch, eps, tf32: bool = False,
            sample: bool = True):
    """The model's pass: ``{"rec": {mod: (loc, logvar)}, "enc": ...,
    "subset_mu", "subset_lv", "joint": (mu, lv)}``. ``eps [..., B, w]``:
    content columns, then each present modality's style."""
    names = mod_names(cfg)
    cd = cfg["class_dim"]
    enc, smu, slv = posteriors(p, cfg, batch, tf32)
    b = smu.shape[-2]
    owner = partition(smu.shape[0], b)
    jmu, jlv = select_rows(smu, owner), select_rows(slv, owner)
    zc = jmu + eps[..., :cd] * torch.exp(0.5 * jlv) if sample else jmu
    rec, off = {}, cd
    for m, d, s in zip(names, cfg["input_dim"], style_dims(cfg)):
        if m not in batch:
            continue
        zs = None
        if s:
            zs = enc[m][2]
            if sample:
                zs = zs + eps[..., off:off + s] * torch.exp(0.5 * enc[m][3])
                off += s
        rec[m] = decode(p, cfg, m, d, zs, zc, tf32)
    return {"rec": rec, "enc": enc, "subset_mu": smu, "subset_lv": slv,
            "joint": (jmu, jlv)}


def loss(p, cfg: dict, batch, eps, tf32: bool = False) -> torch.Tensor:
    """The MoPoE ELBO loss of one batch."""
    out = forward(p, cfg, batch, eps, tf32)
    b = next(iter(batch.values())).shape[0]
    nll = 0.0
    for m, (loc, logvar) in out["rec"].items():
        var = torch.square(torch.exp(0.5 * logvar))
        lp = -0.5 * (LOG2PI + torch.log(var)) \
            - torch.square(batch[m] - loc) / (2.0 * var)
        nll = nll - lp.sum() / b
    k = out["subset_mu"].shape[0]
    div = sum(kl_unit(out["subset_mu"][i], out["subset_lv"][i]).sum() / b
              for i in range(k)) / k
    style = 0.0
    for m, s in zip(mod_names(cfg), style_dims(cfg)):
        if m in batch and s:
            style = style + cfg["beta_style"] * kl_unit(
                out["enc"][m][2], out["enc"][m][3]).sum() / b
    return nll + cfg["beta"] * (cfg["beta_style"] * style
                                + cfg["beta_content"] * div)
