"""Train steps of batches where only one modality is present: a
hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``multivae_tpu/ops/fused_presence.py``. With
``allow_missing_blocks`` about a fifth of the flagship cohort has no ROI
block, so every epoch has clinical-only batches. The TPU kernel
(``_presence_epoch_kernel``) differentiates ``presence_loss_split`` inside
the kernel for the four methods, with optional streamed dropout masks; the
port derives the backward by hand: :func:`presence_fwd_bwd_reference`
(plain) and ``csrc/presence_step.cu`` (kernel), for ``mod_idx`` 0 or 1 and
any row count; on CUDA tensors a whole group of steps with their Adam
updates is ONE persistent cooperative launch
(:func:`presence_epoch_flat`). Noise ``[B, presence_noise_width]``: ``cd | s_i``, twice
for poe (the unimodal re-run's draw); masks ``(dm,)``, for poe
``(dm, dm_uni)``. The absent modality's parameters get zero gradients and
still take the Adam update (their moments decay and a nonzero ``mu`` still
moves them), as in the JAX package. Every entry point takes ``bf16``: the
``matmul_bf16`` branch under the TPU kernel's autodiff (scheme B of
:mod:`.bf16`); on CUDA tensors the kernel's bfloat16 instance, counted
under ``presence_step_bf16``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..params import FusedDims, flat_size, flat_views, flatten_split
from .adam import AdamHyper, adam_scalars, adam_update
from .fused_methods import (
    METHODS,
    check_masks,
    decode_bwd,
    decode_nll,
    encode,
    encode_bwd,
    jsd_prior,
    kl_grads,
    kl_sum,
    poe_with_prior,
    poe_with_prior_bwd,
    reparam_bwd,
    row_masks,
)
from .fused_step import (
    POE_EPS,
    FusedConsts,
    argtypes_of,
    check_inputs,
    check_phase_times,
    check_stack,
    counter_name,
    split_layout_ok,
    workspace,
)

# launches of each kernel in this module, the bfloat16 instance's apart
# (``fused_step.counter_name``); a caller resets and reads it
KERNEL_LAUNCHES: Dict[str, int] = {"presence_step": 0,
                                   "presence_step_bf16": 0}
# train steps those launches ran (one launch may run a group of steps)
KERNEL_STEPS: Dict[str, int] = dict.fromkeys(KERNEL_LAUNCHES, 0)

PORTED_METHODS = METHODS


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


def n_presence_metrics(method: str) -> int:
    return 10 if method == "poe" else 9


def n_presence_masks(method: str, rate: float) -> int:
    """Keep masks streamed per single-present step: one per encoder
    pass."""
    if rate <= 0.0:
        return 0
    return 2 if method == "poe" else 1


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
    modalities present."""
    names = [m.name for m in model.modalities]
    present = [n for n in names if n in batch]
    return (cfg.method in METHODS
            and split_layout_ok(cfg, model)
            and len(present) == 1
            and (cfg.method != "poe" or cfg.poe_unimodal_elbos))


def presence_fwd_bwd_reference(sp, x, noise, dims: FusedDims,
                               consts: FusedConsts, learn_scale: bool,
                               mod_idx: int, method: str = "joint_elbo",
                               dropout_masks: Optional[Sequence] = None,
                               bf16: bool = False):
    """Plain PyTorch version of the kernel: ``(loss, metrics[9 | 10],
    grads)`` of ``presence_loss_split`` with a hand-derived backward;
    ``grads`` holds all 28 split tensors, the absent modality's zero.
    ``bf16``: ``matmul_bf16`` under the TPU kernel's autodiff (scheme B of
    :mod:`.bf16`)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    n_masks = 0 if dropout_masks is None else len(dropout_masks)
    if n_masks not in (0, 2 if method == "poe" else 1):
        raise ValueError(f"{method} takes {2 if method == 'poe' else 1} "
                         f"dropout masks, got {n_masks}")
    e, d = f"enc{mod_idx + 1}", f"dec{mod_idx + 1}"
    s_dim = dims.s1 if mod_idx == 0 else dims.s2
    cd = dims.cd
    b = float(dims.b)
    beta, beta_style, beta_content = consts
    dm = dropout_masks[0] if n_masks else None
    g = {n: torch.zeros_like(v) for n, v in sp.items()}

    h, cmu, clv, smu, slv = encode(sp, e, x, dm, bf16)
    ev = torch.exp(clv)
    t = 1.0 / (ev + POE_EPS)
    ej, es = noise[:, :cd], noise[:, cd:cd + s_dim]

    if method == "joint_elbo":
        # masked PoE of the bare expert: mu unchanged, logvar = -log t
        joint_mu, joint_lv = cmu, -torch.log(t)
        kld_m = kl_sum(cmu, joint_lv, b)
        group_div = kld_m
    elif method == "moe":
        joint_mu, joint_lv = cmu, clv
        kld_m = kl_sum(cmu, clv, b)
        group_div = kld_m
    elif method == "jsd":
        kld_m = kl_sum(cmu, clv, b)  # a metric only
        m_a, _ = row_masks(dims.b, 2, x.device)
        joint_mu = m_a * cmu  # unit rows: mu = 0
        joint_lv = m_a * clv  # unit rows: logvar = 0
        jsd_sum, ((j_mu, j_lv),) = jsd_prior(
            [(cmu, clv, t)], b, beta * beta_content / (2.0 * b))
        group_div = jsd_sum / 2.0
    else:  # poe: the singleton subset fuses with the unit prior expert
        mu_s, lv_s, ts = poe_with_prior(cmu, t)
        joint_mu, joint_lv = mu_s, lv_s
        kld_m = kl_sum(mu_s, lv_s, b)
        group_div = kld_m

    zc = joint_mu + ej * torch.exp(0.5 * joint_lv)
    zs = smu + es * torch.exp(0.5 * slv)
    nll, r, iv = decode_nll(sp, d, x, zs, zc, b, bf16)
    kld_s = kl_sum(smu, slv, b)
    style = beta_style * beta_style * kld_s
    extra = []
    if method != "poe":
        loss = nll + beta * (style + beta_content * group_div)
    else:
        off = cd + s_dim
        uj, us = noise[:, off:off + cd], noise[:, off + cd:off + cd + s_dim]
        # the unimodal re-run: the same posterior, or under dropout a
        # second encoding with its own mask
        hu, cmuu, clvu, smuu, slvu = h, cmu, clv, smu, slv
        tu, mu_u, lv_u, ts_u = t, mu_s, lv_s, ts
        if n_masks:
            hu, cmuu, clvu, smuu, slvu = encode(sp, e, x, dropout_masks[1],
                                               bf16)
            tu = 1.0 / (torch.exp(clvu) + POE_EPS)
            mu_u, lv_u, ts_u = poe_with_prior(cmuu, tu)
        zcu = mu_u + uj * torch.exp(0.5 * lv_u)
        zsu = smuu + us * torch.exp(0.5 * slvu)
        nll_uni, r_u, iv_u = decode_nll(sp, d, x, zsu, zcu, b, bf16)
        loss = nll_uni + nll + beta * (2.0 * beta_content * kld_m
                                       + 2.0 * style)
        extra = [nll_uni]
    metrics = torch.stack([loss, group_div, nll, kld_m, kld_s, cmu.mean(),
                           clv.mean(), smu.mean(), slv.mean()] + extra)

    # ---------------- backward ----------------
    g_zs, g_zc = decode_bwd(sp, g, d, r, iv, zs, zc, b, learn_scale, bf16)
    g_jmu, g_jlv = reparam_bwd(g_zc, ej, joint_lv)
    g_smu, g_slv = reparam_bwd(g_zs, es, slv)
    cg = beta * beta_content / b
    cs = beta * beta_style * beta_style / b
    if method == "poe":
        cg, cs = 2.0 * cg, 2.0 * cs  # the unimodal and the joint ELBO
    if method == "joint_elbo":
        k_mu, k_lv = kl_grads(cmu, joint_lv, cg)
        g_cmu = g_jmu + k_mu
        g_clv = (g_jlv + k_lv) * ev * t  # d(-log t)/d clv = exp(clv) t
    elif method == "moe":
        k_mu, k_lv = kl_grads(cmu, clv, cg)
        g_cmu, g_clv = g_jmu + k_mu, g_jlv + k_lv
    elif method == "jsd":
        g_cmu, g_clv = m_a * g_jmu + j_mu, m_a * g_jlv + j_lv
    else:
        k_mu, k_lv = kl_grads(mu_s, lv_s, cg)
        g_mu_s, g_lv_s = g_jmu + k_mu, g_jlv + k_lv
        g_zsu, g_zcu = decode_bwd(sp, g, d, r_u, iv_u, zsu, zcu, b,
                                  learn_scale, bf16)
        g_mu_u, g_lv_u = reparam_bwd(g_zcu, uj, lv_u)
        g_smuu, g_slvu = reparam_bwd(g_zsu, us, slvu)
        if n_masks:
            # the second pass takes the unimodal NLL's gradient alone
            gc, gt = poe_with_prior_bwd(cmuu, tu, ts_u, mu_u, g_mu_u, g_lv_u)
            encode_bwd(sp, g, e, x, hu, dropout_masks[1],
                       (gc, -gt * torch.exp(clvu) * tu * tu, g_smuu, g_slvu),
                       bf16)
        else:
            g_mu_s, g_lv_s = g_mu_s + g_mu_u, g_lv_s + g_lv_u
            g_smu, g_slv = g_smu + g_smuu, g_slv + g_slvu
        g_cmu, g_t = poe_with_prior_bwd(cmu, t, ts, mu_s, g_mu_s, g_lv_s)
        g_clv = -g_t * ev * t * t
    k_mu, k_lv = kl_grads(smu, slv, cs)
    encode_bwd(sp, g, e, x, h, dm, (g_cmu, g_clv, g_smu + k_mu,
                                    g_slv + k_lv), bf16)
    return loss, metrics, g


# The C arguments of ``presence_epoch_launch`` in order: (name, kind), kinds
# as in ``fused_step.EPOCH_ARGS``.
EPOCH_ARGS = (
    ("params", "ptr"), ("mu", "ptr"), ("nu", "ptr"), ("grads", "ptr"),
    ("metrics", "ptr"), ("xs", "ptr"), ("noise", "ptr"), ("masks", "ptr"),
    ("work", "ptr"),
    ("n", "i32"), ("method", "i32"), ("mod_idx", "i32"), ("b", "i32"),
    ("d1", "i32"), ("d2", "i32"), ("h", "i32"), ("cd", "i32"),
    ("s1", "i32"), ("s2", "i32"),
    ("beta", "f32"), ("beta_style", "f32"), ("beta_content", "f32"),
    ("learn_scale", "i32"), ("count", "i64"),
    ("lr", "f32"), ("b1", "f32"), ("b2", "f32"), ("one_minus_b1", "f32"),
    ("one_minus_b2", "f32"), ("log_b1", "f32"), ("log_b2", "f32"),
    ("eps", "f32"),
    ("phase_times", "ptr"), ("stream", "ptr"),
)


def pack_epoch_args(p, mu, nu, grads, metrics, xs, noise, masks, work,
                    dims: FusedDims, consts: FusedConsts, learn_scale: bool,
                    mod_idx: int, method: str, count: int, hyper: AdamHyper,
                    stream: int, phase_times=None) -> tuple:
    """The arguments of ``presence_epoch_launch`` in :data:`EPOCH_ARGS`
    order (``masks`` None becomes a null pointer). Pure: it reads only
    addresses and shapes."""
    return (
        p.data_ptr(), mu.data_ptr(), nu.data_ptr(), grads.data_ptr(),
        metrics.data_ptr(), xs.data_ptr(), noise.data_ptr(),
        None if masks is None else masks.data_ptr(), work.data_ptr(),
        int(xs.shape[0]), METHODS.index(method), int(mod_idx), dims.b,
        dims.d1, dims.d2, dims.h, dims.cd, dims.s1, dims.s2,
        *(float(c) for c in consts), int(bool(learn_scale)), int(count),
        *adam_scalars(hyper),
        None if phase_times is None else phase_times.data_ptr(), int(stream))


def _presence_library():
    from ._build import load_kernel

    lib = load_kernel("presence_step")
    if lib.presence_step_launch.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # every launch takes the precision (bf16) after its stream
        lib.presence_step_launch.argtypes = (
            [ptr] * 5 + [i32, ptr, ptr, i32, ptr] + [i32] * 9 + [f32] * 3
            + [i32, ptr, i32])
        lib.presence_step_launch.restype = i32
        lib.presence_epoch_launch.argtypes = argtypes_of(EPOCH_ARGS) + [i32]
        lib.presence_epoch_launch.restype = i32
        lib.presence_step_grid_blocks.argtypes = [i32] * 11
        lib.presence_step_grid_blocks.restype = i32
        lib.presence_step_barriers.argtypes = [i32]
        lib.presence_step_barriers.restype = i32
        lib.presence_step_workspace_floats.argtypes = [i32] * 7
        lib.presence_step_workspace_floats.restype = ctypes.c_longlong
        lib.presence_step_error_string.argtypes = [i32]
        lib.presence_step_error_string.restype = ctypes.c_char_p
    return lib


def _launch_presence(p, x, noise, dims: FusedDims, consts: FusedConsts,
                     learn_scale: bool, mod_idx: int, method: str, masks,
                     metrics, grads, bf16: bool = False):
    device = p.device
    b = dims.b
    d = dims.d1 if mod_idx == 0 else dims.d2
    s = dims.s1 if mod_idx == 0 else dims.s2
    width = (dims.cd + s) * (2 if method == "poe" else 1)
    check_inputs("presence_step", device, [
        (p, (flat_size(dims),)), (grads, (flat_size(dims),)),
        (metrics, (n_presence_metrics(method),)), (x, (b, d)),
        (noise, (b, width))])
    if not x.is_contiguous():
        raise ValueError("presence_step takes a contiguous batch")
    masks = check_masks("presence_step", masks,
                        2 if method == "poe" else 1, b, dims.h, device)
    mask_ptrs = [m.data_ptr() for m in masks] + [None] * (2 - len(masks))
    ld_mask = masks[0].stride(0) if masks else 0
    lib = _presence_library()
    method_idx = METHODS.index(method)
    work = workspace(lib, "presence_step", device, method_idx,
                     int(bool(masks)), b, d, dims.h, dims.cd, s)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.presence_step_launch(
            p.data_ptr(), grads.data_ptr(), metrics.data_ptr(),
            x.data_ptr(), noise.data_ptr(), noise.stride(0), *mask_ptrs,
            ld_mask, work.data_ptr(), method_idx, int(mod_idx), b, dims.d1,
            dims.d2, dims.h, dims.cd, dims.s1, dims.s2,
            *(float(c) for c in consts), int(bool(learn_scale)), stream,
            int(bool(bf16)))
    counter = counter_name("presence_step", bf16)
    if rc != 0:
        raise RuntimeError(f"{counter} launch failed: "
                           + lib.presence_step_error_string(rc).decode())
    KERNEL_LAUNCHES[counter] += 1
    KERNEL_STEPS[counter] += 1


def launch_geometry(dims: FusedDims, device, mod_idx: int,
                    method: str = "joint_elbo", has_masks: bool = False,
                    bf16: bool = False) -> Dict[str, int]:
    """Of the persistent kernel (its float32 or bfloat16 instance) at these
    sizes on ``device``: the blocks of its cooperative grid and the grid
    barriers of one step with and without the in-kernel Adam update."""
    lib = _presence_library()
    with torch.cuda.device(device):
        blocks = lib.presence_step_grid_blocks(
            METHODS.index(method), int(has_masks), int(mod_idx), dims.b,
            dims.d1, dims.d2, dims.h, dims.cd, dims.s1, dims.s2,
            int(bool(bf16)))
    if blocks < 0:
        raise RuntimeError("presence_step: "
                           + lib.presence_step_error_string(-blocks).decode())
    return {"grid_blocks": blocks,
            "barriers_per_step_adam": lib.presence_step_barriers(1),
            "barriers_per_step": lib.presence_step_barriers(0)}


def _check_epoch_stacks(p, xs, noise, masks, dims: FusedDims, mod_idx: int,
                        method: str) -> None:
    """The stacked inputs of a group of steps: contiguous float32 on the
    params' device, ``xs [n, B, d_i]``, ``noise [n, B, w]``, ``masks [n,
    1 | 2, B, hidden]`` or None."""
    n, b = int(xs.shape[0]), dims.b
    d = dims.d1 if mod_idx == 0 else dims.d2
    s = dims.s1 if mod_idx == 0 else dims.s2
    poe = method == "poe"
    check_stack("presence_step", p.device, xs, (n, b, d))
    check_stack("presence_step", p.device, noise,
                (n, b, (dims.cd + s) * (2 if poe else 1)))
    if masks is not None:
        check_stack("presence_step", p.device, masks,
                    (n, 2 if poe else 1, b, dims.h))


def _launch_presence_epoch(p, mu, nu, count, xs, noise, dims: FusedDims,
                           consts: FusedConsts, hyper: AdamHyper,
                           learn_scale: bool, mod_idx: int, method: str,
                           masks, phase_times=None, bf16: bool = False):
    """ONE launch for the whole group of steps; returns ``metrics [n,
    9 | 10]``."""
    device = p.device
    n, b = int(xs.shape[0]), dims.b
    check_inputs("presence_step", device, [
        (t, (flat_size(dims),)) for t in (p, mu, nu)])
    check_phase_times("presence_step", device, phase_times, n)
    metrics = torch.empty(n, n_presence_metrics(method),
                          dtype=torch.float32, device=device)
    if n == 0:
        return metrics
    grads = torch.empty_like(p)
    d = dims.d1 if mod_idx == 0 else dims.d2
    s = dims.s1 if mod_idx == 0 else dims.s2
    lib = _presence_library()
    work = workspace(lib, "presence_step", device, METHODS.index(method),
                     int(masks is not None), b, d, dims.h, dims.cd, s)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.presence_epoch_launch(*pack_epoch_args(
            p, mu, nu, grads, metrics, xs, noise, masks, work, dims, consts,
            learn_scale, mod_idx, method, count, hyper, stream, phase_times),
            int(bool(bf16)))
    counter = counter_name("presence_step", bf16)
    if rc != 0:
        raise RuntimeError(f"{counter} epoch launch failed: "
                           + lib.presence_step_error_string(rc).decode())
    KERNEL_LAUNCHES[counter] += 1
    KERNEL_STEPS[counter] += n
    return metrics


def presence_step_flat(p, x, noise, dims: FusedDims, consts: FusedConsts,
                       learn_scale: bool, mod_idx: int,
                       method: str = "joint_elbo", dropout_masks=None,
                       bf16: bool = False):
    """One presence step on a flat params buffer: ``(metrics[9 | 10],
    grads)``. The kernel for CUDA tensors, the plain version for CPU
    tensors; ``bf16`` the bfloat16 branch of either."""
    if mod_idx not in (0, 1):
        raise ValueError(f"mod_idx must be 0 or 1, got {mod_idx}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if p.device.type == "cuda":
        metrics = torch.empty(n_presence_metrics(method),
                              dtype=torch.float32, device=p.device)
        grads = torch.empty_like(p)
        _launch_presence(p, x, noise, dims, consts, learn_scale, mod_idx,
                         method, dropout_masks, metrics, grads, bf16)
        return metrics, grads
    if p.device.type == "cpu":
        _, metrics, g = presence_fwd_bwd_reference(
            flat_views(p, dims), x, noise, dims, consts, learn_scale,
            mod_idx, method, dropout_masks, bf16)
        return metrics, flatten_split(g)
    raise ValueError(f"presence_step: no kernel for {p.device}")


def presence_epoch_flat(p, mu, nu, count: int, xs, noise, dims: FusedDims,
                        consts: FusedConsts, hyper: AdamHyper,
                        learn_scale: bool, mod_idx: int,
                        method: str = "joint_elbo", masks=None,
                        phase_times=None, bf16: bool = False):
    """``n`` presence steps on flat buffers, each followed by Adam over all
    28 tensors; ``noise [n, B, presence_noise_width]``, ``masks [n, 1 | 2,
    B, hidden]`` or None. Returns ``metrics [n, 9 | 10]``. On CUDA tensors
    the whole group is ONE launch of the persistent kernel (stacks
    contiguous float32 on the params' device, else it raises); on CPU
    tensors the host loops the plain step and the plain Adam.
    ``phase_times``: tracing, as in ``fused_step.epoch_flat`` (the kernel
    has the same eight phases). ``bf16``: the bfloat16 branch, on the card
    the kernel's bfloat16 instance."""
    if mod_idx not in (0, 1):
        raise ValueError(f"mod_idx must be 0 or 1, got {mod_idx}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if p.device.type not in ("cuda", "cpu"):
        raise ValueError(f"presence_step: no kernel for {p.device}")
    _check_epoch_stacks(p, xs, noise, masks, dims, mod_idx, method)
    if p.device.type == "cuda":
        return _launch_presence_epoch(p, mu, nu, count, xs, noise, dims,
                                      consts, hyper, learn_scale, mod_idx,
                                      method, masks, phase_times, bf16)
    if phase_times is not None:
        raise ValueError("presence_step: phase_times traces the kernel; "
                         "the plain version has no phases")
    steps = []
    for i in range(xs.shape[0]):
        metrics, grads = presence_step_flat(
            p, xs[i], noise[i], dims, consts, learn_scale, mod_idx, method,
            None if masks is None else masks[i], bf16)
        adam_update(p, mu, nu, grads, count + i + 1, hyper)
        steps.append(metrics)
    return torch.stack(steps)


def presence_epoch(sp, mu, nu, count: int, xs, noise, dims: FusedDims,
                   consts: FusedConsts, hyper: AdamHyper, learn_scale: bool,
                   mod_idx: int, method: str = "joint_elbo", masks=None,
                   bf16: bool = False):
    """``(sp, mu, nu, metrics[n, 9 | 10])`` of an epoch over single-present
    batches (the contract of ``build_presence_epoch`` with the noise and
    masks as inputs); the inputs are not modified."""
    p, m, v = (flatten_split(t) for t in (sp, mu, nu))
    metrics = presence_epoch_flat(p, m, v, count, xs, noise, dims, consts,
                                  hyper, learn_scale, mod_idx, method, masks,
                                  bf16=bf16)
    return (flat_views(p, dims), flat_views(m, dims), flat_views(v, dims),
            metrics)
