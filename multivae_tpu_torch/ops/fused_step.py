"""The MoPoE train step: a hand-written CUDA kernel and its plain PyTorch
version.

Counterpart of ``multivae_tpu/ops/fused_step.py``. :func:`fwd_bwd_reference`
is a torch transcription of ``_fwd_bwd`` (``:319-499``): the 2-modality
``joint_elbo`` loss on the split params with explicit noise, its 17 metric
scalars and its hand-derived gradients, at any row count ``B``.
:func:`loss_and_grads` has the contract of ``fused_loss_and_grads`` (the TPU
kernel ``_fused_kernel``) and :func:`fused_epoch` that of ``fused_epoch``
(``_epoch_kernel``): ``n`` steps, each followed by Adam. On CUDA tensors a
step launches ``csrc/mopoe_step.cu`` and the update ``csrc/flat_adam.cu``,
the host looping the epoch on one stream; on CPU tensors they run the plain
versions. A kernel that does not build or launch raises; nothing falls
back.

With ``row_offset`` and ``b_total`` the step runs on one shard's row slice
of a batch (the TPU kernel ``fused_sharded._dp_kernel``): ``dims.b`` is the
local row count, the mixture partition and every normalization are the whole
batch's, so the outputs are partial sums (the latent means local means, see
:func:`..fused_sharded.mean_rescale`). :func:`slice_step_flat` launches the
kernel's row-slice entry point and counts under ``dp_step``.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..params import (
    SPLIT_NAMES,
    FusedDims,
    flat_size,
    flat_views,
    flatten_split,
    split_layout,
)
from .adam import AdamHyper, adam_update

LOG2PI = math.log(2.0 * math.pi)
POE_EPS = 1e-8

# launches of each kernel in this module; a caller resets and reads it
KERNEL_LAUNCHES: Dict[str, int] = {"mopoe_step": 0, "dp_step": 0}


class FusedConsts(NamedTuple):
    beta: float
    beta_style: float
    beta_content: float


def consts_from(cfg) -> FusedConsts:
    return FusedConsts(cfg.beta, cfg.beta_style, cfg.beta_content)


# per-step scalar families, filled with the two modality names and the joint
# subset key so the logs carry the general path's families
METRIC_TEMPLATES = (
    "loss", "joint_divergence",
    "log_prob/{m1}", "log_prob/{m2}",
    "kld/{m1}", "kld/{m2}", "kld/{joint}",
    "kld_style/{m1}_style", "kld_style/{m2}_style",
    "latent_mu/{m1}", "latent_logvar/{m1}",
    "latent_mu/{m1}_style", "latent_logvar/{m1}_style",
    "latent_mu/{m2}", "latent_logvar/{m2}",
    "latent_mu/{m2}_style", "latent_logvar/{m2}_style",
)
N_METRICS = len(METRIC_TEMPLATES)


def metric_names(model) -> Tuple[str, ...]:
    """Concrete metric keys for this model's modality names."""
    m1, m2 = (m.name for m in model.modalities)
    joint = "_".join(sorted([m1, m2]))
    return tuple(t.format(m1=m1, m2=m2, joint=joint)
                 for t in METRIC_TEMPLATES)


def split_layout_ok(cfg, model) -> bool:
    """The architecture the split layout describes: two modalities, one
    encoder hidden layer, linear decoders, factorized styles, normal
    likelihood with a per-feature output scale."""
    return len(model.modalities) == 2 and split_layout(cfg)


def supports_fused(cfg, model, batch) -> bool:
    """Whether (cfg, model, batch) is the step kernel's
    (``multivae_tpu`` ``supports_fused`` less its TPU VMEM guard)."""
    names = [m.name for m in model.modalities]
    return (cfg.method == "joint_elbo"
            and split_layout_ok(cfg, model)
            and all(n in batch for n in names)
            and cfg.dropout_rate == 0.0)


def _uniform_bounds(b: int, k: int):
    """Row partition of a k-component uniform stratified mixture."""
    size = int(math.floor(b / k))
    return [i * size for i in range(1, k)]


@contextlib.contextmanager
def full_f32_products():
    """Full-float32 matrix products on the card inside the block (TF32
    keeps ~3 decimal digits); the process-wide flag is restored on exit.
    The plain versions are held to the kernels under this setting, which is
    also PyTorch's default."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def mixture_bounds(b: int) -> Tuple[int, int]:
    """Row partition of the 3-subset uniform mixture."""
    k1, k2 = _uniform_bounds(b, 3)
    return k1, k2


def check_slice(name: str, b: int, row_offset, b_total) -> Tuple[int, int]:
    """``(row_offset, b_total)`` of a row slice of ``b`` rows, checked:
    both ints, the slice inside the batch. ``b_total=None`` is the whole
    batch (``row_offset`` must then be 0)."""
    if b_total is None:
        if row_offset != 0:
            raise ValueError(f"{name}: row_offset needs b_total")
        return 0, b
    for label, v in (("row_offset", row_offset), ("b_total", b_total)):
        if isinstance(v, bool) or not isinstance(v, int):
            raise TypeError(f"{name}: {label} is an int, got "
                            f"{type(v).__name__}")
    if row_offset < 0 or b_total < row_offset + b:
        raise ValueError(f"{name}: rows [{row_offset}, {row_offset + b}) "
                         f"are not inside a batch of {b_total}")
    return row_offset, b_total


# ------------------------------------------------------------ plain version
def fwd_bwd_reference(sp, x1, x2, ej, es1, es2, dims: FusedDims,
                      consts: FusedConsts, learn_scale: bool = True,
                      row_offset: int = 0, b_total=None):
    """Plain PyTorch version of the kernel: ``(loss, metrics[17], grads)``,
    ``grads`` a dict of the split tensors' gradients (``_fwd_bwd``).
    ``row_offset``/``b_total`` as there: the inputs are rows ``[row_offset,
    row_offset + dims.b)`` of a batch of ``b_total``; the partition masks use
    global row indices, the sums are divided by ``b_total`` and the latent
    means stay local."""
    row_offset, bt = check_slice("fwd_bwd_reference", dims.b, row_offset,
                                 b_total)
    k1, k2 = mixture_bounds(bt)
    b = float(bt)
    beta, beta_style, beta_content = consts

    h1 = torch.relu(x1 @ sp["enc1_Wh"] + sp["enc1_bh"])
    h2 = torch.relu(x2 @ sp["enc2_Wh"] + sp["enc2_bh"])
    cmu1 = h1 @ sp["enc1_Wcmu"] + sp["enc1_bcmu"]
    clv1 = h1 @ sp["enc1_Wclv"] + sp["enc1_bclv"]
    smu1 = h1 @ sp["enc1_Wsmu"] + sp["enc1_bsmu"]
    slv1 = h1 @ sp["enc1_Wslv"] + sp["enc1_bslv"]
    cmu2 = h2 @ sp["enc2_Wcmu"] + sp["enc2_bcmu"]
    clv2 = h2 @ sp["enc2_Wclv"] + sp["enc2_bclv"]
    smu2 = h2 @ sp["enc2_Wsmu"] + sp["enc2_bsmu"]
    slv2 = h2 @ sp["enc2_Wslv"] + sp["enc2_bslv"]

    ev1, ev2 = torch.exp(clv1), torch.exp(clv2)
    t1 = 1.0 / (ev1 + POE_EPS)
    t2 = 1.0 / (ev2 + POE_EPS)
    tp = 1.0 / (1.0 + POE_EPS)
    mu_a, lv_a = cmu1, -torch.log(t1)
    mu_b, lv_b = cmu2, -torch.log(t2)
    ts = t1 + t2 + tp
    mu_c = (cmu1 * t1 + cmu2 * t2) / ts
    lv_c = -torch.log(ts)

    rows = torch.arange(dims.b, device=x1.device)[:, None] + row_offset
    m_a = (rows < k1).float()
    m_b = ((rows >= k1) & (rows < k2)).float()
    m_c = (rows >= k2).float()
    joint_mu = m_a * mu_a + m_b * mu_b + m_c * mu_c
    joint_lv = m_a * lv_a + m_b * lv_b + m_c * lv_c

    sj = torch.exp(0.5 * joint_lv)
    zc = joint_mu + ej * sj
    ss1, ss2 = torch.exp(0.5 * slv1), torch.exp(0.5 * slv2)
    zs1 = smu1 + es1 * ss1
    zs2 = smu2 + es2 * ss2

    olv1, olv2 = sp["dec1_olv"], sp["dec2_olv"]
    loc1 = zs1 @ sp["dec1_Wds"] + zc @ sp["dec1_Wdc"] + sp["dec1_bd"]
    loc2 = zs2 @ sp["dec2_Wds"] + zc @ sp["dec2_Wdc"] + sp["dec2_bd"]
    r1, r2 = x1 - loc1, x2 - loc2
    iv1, iv2 = torch.exp(-olv1), torch.exp(-olv2)
    nll1 = torch.sum(0.5 * LOG2PI + 0.5 * olv1
                     + 0.5 * torch.square(r1) * iv1) / b
    nll2 = torch.sum(0.5 * LOG2PI + 0.5 * olv2
                     + 0.5 * torch.square(r2) * iv2) / b

    def kl_sum(mu, lv):
        return -0.5 * torch.sum(1.0 - torch.exp(lv) - torch.square(mu)
                                + lv) / b

    kld_a, kld_b, kld_c = kl_sum(mu_a, lv_a), kl_sum(mu_b, lv_b), \
        kl_sum(mu_c, lv_c)
    kld_s1, kld_s2 = kl_sum(smu1, slv1), kl_sum(smu2, slv2)
    group_div = (kld_a + kld_b + kld_c) / 3.0
    loss = (nll1 + nll2 + beta * (beta_style * beta_style
                                  * (kld_s1 + kld_s2)
                                  + beta_content * group_div))
    metrics = torch.stack([
        loss, group_div, nll1, nll2, kld_a, kld_b, kld_c, kld_s1, kld_s2,
        cmu1.mean(), clv1.mean(), smu1.mean(), slv1.mean(),
        cmu2.mean(), clv2.mean(), smu2.mean(), slv2.mean()])

    # ---------------- backward (fused_step.py:430-498) ----------------
    g = {}
    g_loc1 = -r1 * iv1 / b
    g_loc2 = -r2 * iv2 / b
    g["dec1_Wds"] = zs1.T @ g_loc1
    g["dec1_Wdc"] = zc.T @ g_loc1
    g["dec2_Wds"] = zs2.T @ g_loc2
    g["dec2_Wdc"] = zc.T @ g_loc2
    g["dec1_bd"] = g_loc1.sum(0)
    g["dec2_bd"] = g_loc2.sum(0)
    if learn_scale:
        g["dec1_olv"] = torch.sum(0.5 - 0.5 * torch.square(r1) * iv1,
                                  0, keepdim=True) / b
        g["dec2_olv"] = torch.sum(0.5 - 0.5 * torch.square(r2) * iv2,
                                  0, keepdim=True) / b
    else:
        g["dec1_olv"] = torch.zeros_like(olv1)
        g["dec2_olv"] = torch.zeros_like(olv2)
    g_zs1 = g_loc1 @ sp["dec1_Wds"].T
    g_zs2 = g_loc2 @ sp["dec2_Wds"].T
    g_zc = g_loc1 @ sp["dec1_Wdc"].T + g_loc2 @ sp["dec2_Wdc"].T

    g_jmu = g_zc
    g_jlv = g_zc * ej * 0.5 * sj
    cg = beta * beta_content / (3.0 * b)
    g_mu_a = m_a * g_jmu + cg * mu_a
    g_mu_b = m_b * g_jmu + cg * mu_b
    g_mu_c = m_c * g_jmu + cg * mu_c
    g_lv_a = m_a * g_jlv + cg * 0.5 * (torch.exp(lv_a) - 1.0)
    g_lv_b = m_b * g_jlv + cg * 0.5 * (torch.exp(lv_b) - 1.0)
    g_lv_c = m_c * g_jlv + cg * 0.5 * (torch.exp(lv_c) - 1.0)

    g_cmu1 = g_mu_a + g_mu_c * (t1 / ts)
    g_cmu2 = g_mu_b + g_mu_c * (t2 / ts)
    g_t1 = g_mu_c * (cmu1 - mu_c) / ts - g_lv_c / ts
    g_t2 = g_mu_c * (cmu2 - mu_c) / ts - g_lv_c / ts
    g_clv1 = g_lv_a * ev1 * t1 + g_t1 * (-ev1 * t1 * t1)
    g_clv2 = g_lv_b * ev2 * t2 + g_t2 * (-ev2 * t2 * t2)

    cs = beta * beta_style * beta_style / b
    g_smu1 = g_zs1 + cs * smu1
    g_smu2 = g_zs2 + cs * smu2
    g_slv1 = g_zs1 * es1 * 0.5 * ss1 + cs * 0.5 * (torch.exp(slv1) - 1.0)
    g_slv2 = g_zs2 * es2 * 0.5 * ss2 + cs * 0.5 * (torch.exp(slv2) - 1.0)

    for e, x, h, heads in (("enc1", x1, h1, (g_cmu1, g_clv1, g_smu1, g_slv1)),
                           ("enc2", x2, h2, (g_cmu2, g_clv2, g_smu2, g_slv2))):
        g_h = torch.zeros_like(h)
        for part, gh in zip(("cmu", "clv", "smu", "slv"), heads):
            g[f"{e}_W{part}"] = h.T @ gh
            g[f"{e}_b{part}"] = gh.sum(0)
            g_h = g_h + gh @ sp[f"{e}_W{part}"].T
        g_h = g_h * (h > 0.0).float()
        g[f"{e}_Wh"] = x.T @ g_h
        g[f"{e}_bh"] = g_h.sum(0)
    return loss, metrics, {n: g[n] for n in SPLIT_NAMES}


# ------------------------------------------------------------------ kernel
def _step_library():
    from ._build import load_kernel

    lib = load_kernel("mopoe_step")
    if lib.mopoe_step_launch.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mopoe_step_launch.argtypes = (
            [ptr] * 6 + [i32, ptr, i32, ptr, i32, ptr] + [i32] * 7
            + [f32] * 3 + [i32, ptr])
        lib.mopoe_step_launch.restype = i32
        lib.mopoe_step_slice_launch.argtypes = (
            [ptr] * 6 + [i32, ptr, i32, ptr, i32, ptr] + [i32] * 9
            + [f32] * 3 + [i32, ptr])
        lib.mopoe_step_slice_launch.restype = i32
        lib.mopoe_step_workspace_floats.argtypes = [i32] * 7
        lib.mopoe_step_workspace_floats.restype = ctypes.c_longlong
        lib.mopoe_step_param_floats.argtypes = [i32] * 6
        lib.mopoe_step_param_floats.restype = ctypes.c_longlong
        lib.mopoe_step_error_string.argtypes = [i32]
        lib.mopoe_step_error_string.restype = ctypes.c_char_p
    return lib


_WORKSPACES: Dict[tuple, torch.Tensor] = {}


def workspace(lib, prefix: str, device, *sizes) -> torch.Tensor:
    """The kernel's scratch buffer for these sizes on ``device``'s current
    stream, allocated once and reused by every later launch there (launches
    of one stream run in order; two streams never share a buffer)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (prefix, str(device), stream) + tuple(sizes)
    buf = _WORKSPACES.get(key)
    if buf is None:
        n = getattr(lib, f"{prefix}_workspace_floats")(*sizes)
        buf = torch.empty(int(n), dtype=torch.float32, device=device)
        _WORKSPACES[key] = buf
    return buf


def check_inputs(name: str, device, tensors) -> None:
    """Device, dtype, shape and row-contiguity checks of a kernel's inputs
    (``tensors``: ``(tensor, shape)`` pairs; a row may have a stride)."""
    for t, shape in tensors:
        if t.device != device:
            raise ValueError(f"{name}: a tensor is on {t.device}, expected "
                             f"{device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if t.dim() == 2 and t.stride(1) != 1 or t.dim() == 1 and \
                not t.is_contiguous():
            raise ValueError(f"{name} takes tensors with contiguous rows")


def _launch_step(p, x1, x2, ej, es1, es2, dims: FusedDims,
                 consts: FusedConsts, learn_scale: bool, metrics, grads,
                 row_slice=None):
    """Launch the step (``row_slice=None``, counted as ``mopoe_step``) or
    its row-slice entry point (``row_slice=(row_offset, b_total)``, counted
    as ``dp_step``)."""
    device = p.device
    b = dims.b
    check_inputs("mopoe_step", device, [
        (p, (flat_size(dims),)), (grads, (flat_size(dims),)),
        (metrics, (N_METRICS,)),
        (x1, (b, dims.d1)), (x2, (b, dims.d2)), (ej, (b, dims.cd)),
        (es1, (b, dims.s1)), (es2, (b, dims.s2))])
    for t in (x1, x2):
        if not t.is_contiguous():
            raise ValueError("mopoe_step takes contiguous batches")
    lib = _step_library()
    widths = (dims.d1, dims.d2, dims.h, dims.cd, dims.s1, dims.s2)
    if lib.mopoe_step_param_floats(*widths) != p.numel():
        raise ValueError("mopoe_step: the kernel's split layout disagrees "
                         "with params.split_shapes")
    work = workspace(lib, "mopoe_step", device, b, *widths)
    launch, counter, rows = lib.mopoe_step_launch, "mopoe_step", (b,)
    if row_slice is not None:
        launch, counter = lib.mopoe_step_slice_launch, "dp_step"
        rows = (b,) + tuple(row_slice)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = launch(
            p.data_ptr(), grads.data_ptr(), metrics.data_ptr(),
            x1.data_ptr(), x2.data_ptr(), ej.data_ptr(), ej.stride(0),
            es1.data_ptr(), es1.stride(0), es2.data_ptr(), es2.stride(0),
            work.data_ptr(), *rows, *widths, *(float(c) for c in consts),
            int(bool(learn_scale)), stream)
    if rc != 0:
        raise RuntimeError(f"{counter} launch failed: "
                           + lib.mopoe_step_error_string(rc).decode())
    KERNEL_LAUNCHES[counter] += 1


def _step_flat(p, x1, x2, ej, es1, es2, dims, consts, learn_scale,
               row_slice):
    if p.device.type == "cuda":
        metrics = torch.empty(N_METRICS, dtype=torch.float32,
                              device=p.device)
        grads = torch.empty_like(p)
        _launch_step(p, x1, x2, ej, es1, es2, dims, consts, learn_scale,
                     metrics, grads, row_slice)
        return metrics, grads
    if p.device.type == "cpu":
        row_offset, b_total = row_slice or (0, None)
        _, metrics, g = fwd_bwd_reference(flat_views(p, dims), x1, x2, ej,
                                          es1, es2, dims, consts,
                                          learn_scale, row_offset, b_total)
        return metrics, flatten_split(g)
    raise ValueError(f"mopoe_step: no kernel for {p.device}")


def step_flat(p, x1, x2, ej, es1, es2, dims: FusedDims,
              consts: FusedConsts, learn_scale: bool = True):
    """One step on a flat params buffer: ``(metrics[17], grads)``, ``grads``
    a new flat buffer of the split layout. The kernel for CUDA tensors, the
    plain version for CPU tensors."""
    return _step_flat(p, x1, x2, ej, es1, es2, dims, consts, learn_scale,
                      None)


def slice_step_flat(p, x1, x2, ej, es1, es2, dims: FusedDims,
                    consts: FusedConsts, learn_scale: bool, row_offset: int,
                    b_total: int):
    """:func:`step_flat` on rows ``[row_offset, row_offset + dims.b)`` of a
    batch of ``b_total``: partial ``(metrics[17], grads)`` whose sum over
    the shards is the whole batch's (the latent means after
    ``mean_rescale``). The kernel's row-slice entry point for CUDA tensors,
    the plain version for CPU tensors."""
    return _step_flat(p, x1, x2, ej, es1, es2, dims, consts, learn_scale,
                      check_slice("dp_step", dims.b, row_offset, b_total))


def loss_and_grads(sp, x1, x2, ej, es1, es2, dims: FusedDims,
                   consts: FusedConsts, learn_scale: bool = True):
    """``(loss, metrics[17], grads)`` of one step on split params (the
    contract of ``fused_loss_and_grads``, grads in the split layout)."""
    metrics, grads = step_flat(flatten_split(sp), x1, x2, ej, es1, es2,
                               dims, consts, learn_scale)
    return metrics[0], metrics, flat_views(grads, dims)


def split_noise(noise, dims: FusedDims):
    """``noise [..., cd + s1 + s2]`` (layout ``cd | s1 | s2``) ->
    ``(ej, es1, es2)`` views."""
    cd, s1 = dims.cd, dims.s1
    return (noise[..., :cd], noise[..., cd:cd + s1],
            noise[..., cd + s1:])


def epoch_flat(p, mu, nu, count: int, x1s, x2s, noise, dims: FusedDims,
               consts: FusedConsts, hyper: AdamHyper,
               learn_scale: bool = True):
    """``n`` steps on flat buffers, each followed by Adam at
    ``t = count + step + 1``; ``p``, ``mu`` and ``nu`` are updated in place.
    ``noise [n, B, cd + s1 + s2]``. Returns ``metrics [n, 17]`` (on the
    buffers' device; nothing is fetched)."""
    steps = []
    for i in range(x1s.shape[0]):
        ej, es1, es2 = split_noise(noise[i], dims)
        metrics, grads = step_flat(p, x1s[i], x2s[i], ej, es1, es2, dims,
                                   consts, learn_scale)
        adam_update(p, mu, nu, grads, count + i + 1, hyper)
        steps.append(metrics)
    return torch.stack(steps)


def fused_epoch(sp, mu, nu, count: int, x1s, x2s, ejs, es1s, es2s,
                dims: FusedDims, consts: FusedConsts, hyper: AdamHyper,
                learn_scale: bool = True):
    """The contract of ``fused_epoch``: ``(sp, mu, nu, metrics[n, 17])``
    from split params and moments (dicts) and per-step batches and noise.
    The inputs are not modified."""
    p, m, v = (flatten_split(t) for t in (sp, mu, nu))
    noise = torch.cat([ejs, es1s, es2s], dim=-1)
    metrics = epoch_flat(p, m, v, count, x1s, x2s, noise, dims, consts,
                         hyper, learn_scale)
    return (flat_views(p, dims), flat_views(m, dims), flat_views(v, dims),
            metrics)
