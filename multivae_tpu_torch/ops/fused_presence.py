"""Train steps of batches where only one modality is present: a
hand-written CUDA kernel (``joint_elbo``) and its plain PyTorch version.

Counterpart of ``multivae_tpu/ops/fused_presence.py``. With
``allow_missing_blocks`` about a fifth of the flagship cohort has no ROI
block, so every epoch has clinical-only batches. The TPU kernel
(``_presence_epoch_kernel``) differentiates ``presence_loss_split`` inside
the kernel for four methods; the port ports its ``joint_elbo`` branch with
a hand-derived backward: :func:`presence_fwd_bwd_reference` (plain) and
``csrc/presence_step.cu`` (kernel), for ``mod_idx`` 0 or 1 and any row
count. The absent modality's parameters get zero gradients and still take
the Adam update (their moments decay and a nonzero ``mu`` still moves
them), as in the JAX package. The other methods' branches and dropout
masks stay with the TPU kernel (ROADMAP Queue 2) and raise here.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..params import FusedDims, flat_size, flat_views, flatten_split
from .adam import AdamHyper, adam_update
from .fused_methods import METHODS
from .fused_step import (
    LOG2PI,
    POE_EPS,
    FusedConsts,
    check_inputs,
    split_layout_ok,
    workspace,
)

# launches of each kernel in this module; a caller resets and reads it
KERNEL_LAUNCHES: Dict[str, int] = {"presence_step": 0}

PORTED_METHODS = ("joint_elbo",)
N_PRESENCE_METRICS = 9


def presence_metric_names(model, method: str, mod_idx: int) -> Tuple[str, ...]:
    """Scalar families of a single-present batch (the general path's
    ``total_loss`` restricted to the present modality)."""
    m = model.modalities[mod_idx].name
    names = [
        "loss", "joint_divergence",
        f"log_prob/{m}", f"kld/{m}", f"kld_style/{m}_style",
        f"latent_mu/{m}", f"latent_logvar/{m}",
        f"latent_mu/{m}_style", f"latent_logvar/{m}_style",
    ]
    if method == "poe":
        names.append(f"log_prob_uni/{m}")
    return tuple(names)


def presence_noise_width(cfg, mod_idx: int) -> int:
    """Noise columns per sample: ``cd | s_i`` (twice for poe)."""
    w = cfg.class_dim + cfg.style_dim[mod_idx]
    if cfg.method == "poe":
        w *= 2
    return w


def supports_presence_fused(cfg, model, batch) -> bool:
    """The TPU kernel's eligibility (``multivae_tpu``
    ``supports_presence_fused`` less its VMEM guard): the split-layout
    architecture, any of the four methods, exactly one of the two
    modalities present. Only ``joint_elbo`` without dropout has a kernel
    in the port."""
    names = [m.name for m in model.modalities]
    present = [n for n in names if n in batch]
    return (cfg.method in METHODS
            and split_layout_ok(cfg, model)
            and len(present) == 1
            and (cfg.method != "poe" or cfg.poe_unimodal_elbos))


def presence_fwd_bwd_reference(sp, x, ej, es, dims: FusedDims,
                               consts: FusedConsts, learn_scale: bool,
                               mod_idx: int):
    """Plain PyTorch version of the kernel: ``(loss, metrics[9], grads)``
    of the ``joint_elbo`` branch of ``presence_loss_split`` with its hand
    backward; ``grads`` holds all 28 split tensors, the absent modality's
    zero."""
    torch.backends.cuda.matmul.allow_tf32 = False
    e, d = f"enc{mod_idx + 1}", f"dec{mod_idx + 1}"
    b = float(dims.b)
    beta, beta_style, beta_content = consts

    h = torch.relu(x @ sp[f"{e}_Wh"] + sp[f"{e}_bh"])
    cmu = h @ sp[f"{e}_Wcmu"] + sp[f"{e}_bcmu"]
    clv = h @ sp[f"{e}_Wclv"] + sp[f"{e}_bclv"]
    smu = h @ sp[f"{e}_Wsmu"] + sp[f"{e}_bsmu"]
    slv = h @ sp[f"{e}_Wslv"] + sp[f"{e}_bslv"]
    ev = torch.exp(clv)
    t = 1.0 / (ev + POE_EPS)
    # masked PoE of the bare expert: mu unchanged, logvar = -log t
    lv = -torch.log(t)
    sj, ss = torch.exp(0.5 * lv), torch.exp(0.5 * slv)
    zc = cmu + ej * sj
    zs = smu + es * ss
    olv = sp[f"{d}_olv"]
    loc = zs @ sp[f"{d}_Wds"] + zc @ sp[f"{d}_Wdc"] + sp[f"{d}_bd"]
    r = x - loc
    iv = torch.exp(-olv)
    nll = torch.sum(0.5 * LOG2PI + 0.5 * olv + 0.5 * torch.square(r) * iv) / b

    def kl_sum(mu, logvar):
        return -0.5 * torch.sum(1.0 - torch.exp(logvar) - torch.square(mu)
                                + logvar) / b

    kld_m, kld_s = kl_sum(cmu, lv), kl_sum(smu, slv)
    group_div = kld_m
    loss = nll + beta * (beta_style * beta_style * kld_s
                         + beta_content * group_div)
    metrics = torch.stack([loss, group_div, nll, kld_m, kld_s, cmu.mean(),
                           clv.mean(), smu.mean(), slv.mean()])

    g = {n: torch.zeros_like(v) for n, v in sp.items()}
    g_loc = -r * iv / b
    g[f"{d}_Wds"] = zs.T @ g_loc
    g[f"{d}_Wdc"] = zc.T @ g_loc
    g[f"{d}_bd"] = g_loc.sum(0)
    if learn_scale:
        g[f"{d}_olv"] = torch.sum(0.5 - 0.5 * torch.square(r) * iv, 0,
                                  keepdim=True) / b
    g_zs = g_loc @ sp[f"{d}_Wds"].T
    g_zc = g_loc @ sp[f"{d}_Wdc"].T
    cg = beta * beta_content / b
    cs = beta * beta_style * beta_style / b
    g_cmu = g_zc + cg * cmu
    g_lv = g_zc * ej * 0.5 * sj + cg * 0.5 * (torch.exp(lv) - 1.0)
    g_clv = g_lv * ev * t  # d(-log t)/d clv = exp(clv) t
    g_smu = g_zs + cs * smu
    g_slv = g_zs * es * 0.5 * ss + cs * 0.5 * (torch.exp(slv) - 1.0)
    g_h = torch.zeros_like(h)
    for part, gh in (("cmu", g_cmu), ("clv", g_clv), ("smu", g_smu),
                     ("slv", g_slv)):
        g[f"{e}_W{part}"] = h.T @ gh
        g[f"{e}_b{part}"] = gh.sum(0)
        g_h = g_h + gh @ sp[f"{e}_W{part}"].T
    g_h = g_h * (h > 0.0).float()
    g[f"{e}_Wh"] = x.T @ g_h
    g[f"{e}_bh"] = g_h.sum(0)
    return loss, metrics, g


def _presence_library():
    from ._build import load_kernel

    lib = load_kernel("presence_step")
    if lib.presence_step_launch.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.presence_step_launch.argtypes = (
            [ptr] * 5 + [i32, ptr, i32, ptr] + [i32] * 8 + [f32] * 3
            + [i32, ptr])
        lib.presence_step_launch.restype = i32
        lib.presence_step_workspace_floats.argtypes = [i32] * 5
        lib.presence_step_workspace_floats.restype = ctypes.c_longlong
        lib.presence_step_error_string.argtypes = [i32]
        lib.presence_step_error_string.restype = ctypes.c_char_p
    return lib


def _launch_presence(p, x, ej, es, dims: FusedDims, consts: FusedConsts,
                     learn_scale: bool, mod_idx: int, metrics, grads):
    device = p.device
    b = dims.b
    d = dims.d1 if mod_idx == 0 else dims.d2
    s = dims.s1 if mod_idx == 0 else dims.s2
    check_inputs("presence_step", device, [
        (p, (flat_size(dims),)), (grads, (flat_size(dims),)),
        (metrics, (N_PRESENCE_METRICS,)), (x, (b, d)), (ej, (b, dims.cd)),
        (es, (b, s))])
    if not x.is_contiguous():
        raise ValueError("presence_step takes a contiguous batch")
    lib = _presence_library()
    work = workspace(lib, "presence_step", device, b, d, dims.h, dims.cd, s)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.presence_step_launch(
            p.data_ptr(), grads.data_ptr(), metrics.data_ptr(),
            x.data_ptr(), ej.data_ptr(), ej.stride(0), es.data_ptr(),
            es.stride(0), work.data_ptr(), int(mod_idx), b, dims.d1,
            dims.d2, dims.h, dims.cd, dims.s1, dims.s2,
            *(float(c) for c in consts), int(bool(learn_scale)), stream)
    if rc != 0:
        raise RuntimeError("presence_step launch failed: "
                           + lib.presence_step_error_string(rc).decode())
    KERNEL_LAUNCHES["presence_step"] += 1


def presence_step_flat(p, x, ej, es, dims: FusedDims, consts: FusedConsts,
                       learn_scale: bool, mod_idx: int):
    """One presence step on a flat params buffer: ``(metrics[9], grads)``.
    The kernel for CUDA tensors, the plain version for CPU tensors."""
    if mod_idx not in (0, 1):
        raise ValueError(f"mod_idx must be 0 or 1, got {mod_idx}")
    if p.device.type == "cuda":
        metrics = torch.empty(N_PRESENCE_METRICS, dtype=torch.float32,
                              device=p.device)
        grads = torch.empty_like(p)
        _launch_presence(p, x, ej, es, dims, consts, learn_scale, mod_idx,
                         metrics, grads)
        return metrics, grads
    if p.device.type == "cpu":
        _, metrics, g = presence_fwd_bwd_reference(
            flat_views(p, dims), x, ej, es, dims, consts, learn_scale,
            mod_idx)
        return metrics, flatten_split(g)
    raise ValueError(f"presence_step: no kernel for {p.device}")


def presence_epoch_flat(p, mu, nu, count: int, xs, noise, dims: FusedDims,
                        consts: FusedConsts, hyper: AdamHyper,
                        learn_scale: bool, mod_idx: int):
    """``n`` presence steps on flat buffers, each followed by Adam over all
    28 tensors; ``noise [n, B, cd + s_i]`` (layout ``cd | s_i``). Returns
    ``metrics [n, 9]``."""
    cd = dims.cd
    steps = []
    for i in range(xs.shape[0]):
        metrics, grads = presence_step_flat(
            p, xs[i], noise[i][:, :cd], noise[i][:, cd:], dims, consts,
            learn_scale, mod_idx)
        adam_update(p, mu, nu, grads, count + i + 1, hyper)
        steps.append(metrics)
    return torch.stack(steps)


def presence_epoch(sp, mu, nu, count: int, xs, noise, dims: FusedDims,
                   consts: FusedConsts, hyper: AdamHyper, learn_scale: bool,
                   mod_idx: int):
    """``(sp, mu, nu, metrics[n, 9])`` of an epoch over single-present
    batches (the ``joint_elbo`` branch of ``build_presence_epoch``); the
    inputs are not modified."""
    p, m, v = (flatten_split(t) for t in (sp, mu, nu))
    metrics = presence_epoch_flat(p, m, v, count, xs, noise, dims, consts,
                                  hyper, learn_scale, mod_idx)
    return (flat_views(p, dims), flat_views(m, dims), flat_views(v, dims),
            metrics)
