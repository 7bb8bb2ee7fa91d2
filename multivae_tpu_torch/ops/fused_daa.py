"""The fused DAA avatar sweep: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``multivae_tpu/ops/fused_daa.py``. The ROI-encoder
posteriors do not depend on the perturbed clinical column, so they are
encoded once (:func:`rois_posteriors`); per (sample, score) cell only the
clinical encoder, the 3-expert PoE, the method's joint, the
reparameterization and the ROI decoder run. On a CUDA tensor
:func:`sweep_cells` launches ``csrc/avatar_sweep.cu``; on a CPU tensor it
runs :func:`sweep_cells_reference`. There is no fallback from one to the
other: a kernel that does not build or launch raises.

The TPU kernel's cell packing, tiled posteriors and VMEM guard exist for the
TPU's VMEM and matrix unit and are not carried over: the CUDA kernel indexes
the ``[B, .]`` posteriors by ``row mod B``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..params import FusedDims, dims_from, model_split_params
from .fusion import POE_EPS

# launches of each kernel in this module; a caller resets and reads it
KERNEL_LAUNCHES: Dict[str, int] = {"avatar_sweep": 0}

METHODS = ("joint_elbo", "moe", "jsd", "poe")
_METHOD_CODES = {m: i for i, m in enumerate(METHODS)}  # csrc enum Method

ENC_NAMES = ("Wh", "bh", "Wcmu", "bcmu", "Wclv", "bclv")
DEC_NAMES = ("Wds", "Wdc", "bd")


def supports_fused_sweep(cfg, model, batch) -> bool:
    """The sweep fuses for any of the four methods on the flagship
    architecture: two modalities, one encoder hidden layer, linear
    decoders, factorized styles, normal likelihood with a per-feature
    output scale (``multivae_tpu`` ``supports_fused_sweep`` less its TPU
    VMEM guard)."""
    names = [m.name for m in model.modalities]
    return (
        cfg.method in METHODS
        and len(model.modalities) == 2
        and all(n in batch for n in names)
        and cfg.num_hidden_layer_encoder == 1
        and cfg.num_hidden_layer_decoder == 0
        and cfg.factorized_representation
        and all(m.style_dim > 0 for m in model.modalities)
        and cfg.likelihood == "normal"
        and not cfg.learn_output_sample_scale
        and (cfg.method != "poe" or cfg.poe_unimodal_elbos)
    )


def build_cell_grid(clinical, scores_values):
    """Perturbed clinical block of every (sample, score) cell:
    ``[n_samples * n_scores, B, d1]``, where cell ``(p, s)`` replaces score
    ``s`` of every subject by ``scores_values[p, :, s]``."""
    n_samples, b, n_scores = scores_values.shape
    eye = torch.eye(n_scores, dtype=clinical.dtype, device=clinical.device)
    cdata = (clinical[None, None] * (1.0 - eye)[None, :, None, :]
             + scores_values.permute(0, 2, 1)[:, :, :, None]
             * eye[None, :, None, :])
    return cdata.reshape(n_samples * n_scores, b, clinical.shape[-1])


def sweep_cells_reference(sp, posteriors, cdata, eps, dims: FusedDims,
                          sample_latents: bool, method: str = "joint_elbo"):
    """Plain PyTorch version of the kernel: decoded ROI locs
    ``[n_cells, B, d2]`` of every cell (the math of ``_avatar_kernel``)."""
    cd, b = dims.cd, dims.b
    cmu2, clv2, smu2, slv2 = posteriors
    h1 = torch.relu(cdata @ sp["enc1_Wh"] + sp["enc1_bh"])
    cmu1 = h1 @ sp["enc1_Wcmu"] + sp["enc1_bcmu"]
    clv1 = h1 @ sp["enc1_Wclv"] + sp["enc1_bclv"]
    t1 = 1.0 / (torch.exp(clv1) + POE_EPS)
    t2 = 1.0 / (torch.exp(clv2) + POE_EPS)
    tp = 1.0 / (1.0 + POE_EPS)
    ts = t1 + t2 + tp
    mu_c = (cmu1 * t1 + cmu2 * t2) / ts   # full-set PoE (+ prior expert)
    if sample_latents:
        rows = torch.arange(b, device=cdata.device)[:, None]
        k1 = b // 3
        lv_c = -torch.log(ts)
        if method == "joint_elbo":
            lv_a = torch.log(torch.exp(clv1) + POE_EPS)
            lv_b = torch.log(torch.exp(clv2) + POE_EPS)
            joint_mu = torch.where(rows < k1, cmu1,
                                   torch.where(rows < 2 * k1, cmu2, mu_c))
            joint_lv = torch.where(rows < k1, lv_a,
                                   torch.where(rows < 2 * k1, lv_b, lv_c))
        elif method == "moe":
            joint_mu = torch.where(rows < b // 2, cmu1, cmu2)
            joint_lv = torch.where(rows < b // 2, clv1, clv2)
        elif method == "jsd":   # third component: the unit expert
            zero = torch.zeros_like(cmu1)
            joint_mu = torch.where(rows < k1, cmu1,
                                   torch.where(rows < 2 * k1, cmu2, zero))
            joint_lv = torch.where(rows < k1, clv1,
                                   torch.where(rows < 2 * k1, clv2, zero))
        else:  # poe
            joint_mu, joint_lv = mu_c, lv_c
        zc = joint_mu + eps[..., :cd] * torch.exp(0.5 * joint_lv)
        zs2 = smu2 + eps[..., cd:] * torch.exp(0.5 * slv2)
    else:
        # the mean over the selected subset mixture; styles at their means
        if method == "joint_elbo":
            zc = (cmu1 + cmu2 + mu_c) / 3.0
        elif method == "moe":
            zc = (cmu1 + cmu2) / 2.0
        elif method == "jsd":
            zc = (cmu1 + cmu2) / 3.0   # + the zero-mean unit expert
        else:  # poe
            zc = mu_c
        zs2 = smu2.expand(cdata.shape[0], -1, -1)
    return zs2 @ sp["dec2_Wds"] + zc @ sp["dec2_Wdc"] + sp["dec2_bd"]


def _sweep_library():
    from ._build import load_kernel

    lib = load_kernel("avatar_sweep")
    if lib.avatar_sweep_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.avatar_sweep_launch.argtypes = (
            [ptr] * 16 + [ctypes.c_longlong] + [i32] * 8 + [ptr])
        lib.avatar_sweep_launch.restype = i32
        lib.avatar_sweep_smem_bytes.argtypes = [i32] * 4
        lib.avatar_sweep_smem_bytes.restype = ctypes.c_longlong
        lib.avatar_sweep_error_string.argtypes = [i32]
        lib.avatar_sweep_error_string.restype = ctypes.c_char_p
    return lib


_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use


def _launch_sweep(sp, posteriors, cdata, eps, dims: FusedDims,
                  sample_latents: bool, method: str):
    n_cells, b = cdata.shape[0], cdata.shape[1]
    device = cdata.device
    if method not in _METHOD_CODES:
        raise ValueError(f"unknown method {method!r}")
    enc = [sp[f"enc1_{n}"] for n in ENC_NAMES]
    dec = [sp[f"dec2_{n}"] for n in DEC_NAMES]
    shapes = [
        (cdata, (n_cells, b, dims.d1)), (eps, (n_cells, b, dims.cd + dims.s2)),
        (enc[0], (dims.d1, dims.h)), (enc[1], (dims.h,)),
        (enc[2], (dims.h, dims.cd)), (enc[3], (dims.cd,)),
        (enc[4], (dims.h, dims.cd)), (enc[5], (dims.cd,)),
        (dec[0], (dims.s2, dims.d2)), (dec[1], (dims.cd, dims.d2)),
        (dec[2], (dims.d2,)),
        (posteriors[0], (b, dims.cd)), (posteriors[1], (b, dims.cd)),
        (posteriors[2], (b, dims.s2)), (posteriors[3], (b, dims.s2)),
    ]
    for t, shape in shapes:
        if t.device != device:
            raise ValueError(f"avatar_sweep: a tensor is on {t.device}, "
                             f"the cells on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"avatar_sweep takes float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"avatar_sweep: shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError("avatar_sweep takes contiguous tensors")
    lib = _sweep_library()
    smem = lib.avatar_sweep_smem_bytes(dims.d1, dims.h, dims.cd, dims.s2)
    if smem > _MAX_SMEM:
        raise ValueError(f"avatar_sweep: {smem} B of shared memory per "
                         f"block exceeds Hopper's {_MAX_SMEM} B")
    out = torch.empty((n_cells, b, dims.d2), dtype=torch.float32,
                      device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.avatar_sweep_launch(
            cdata.data_ptr(), eps.data_ptr(),
            *[t.data_ptr() for t in enc + dec],
            *[t.data_ptr() for t in posteriors], out.data_ptr(),
            n_cells * b, b, dims.d1, dims.h, dims.cd, dims.s2, dims.d2,
            _METHOD_CODES[method], int(bool(sample_latents)), stream)
    if rc != 0:
        raise RuntimeError("avatar_sweep launch failed: "
                           + lib.avatar_sweep_error_string(rc).decode())
    KERNEL_LAUNCHES["avatar_sweep"] += 1
    return out


def sweep_cells(sp, posteriors, cdata, eps, dims: FusedDims,
                sample_latents: bool, method: str = "joint_elbo"):
    """Decoded ROI locs ``[n_cells, B, d2]`` of prepared cells.

    ``sp``: split params (``[in, out]``); ``posteriors``: the cell-invariant
    ROI posteriors ``(cmu2, clv2, smu2, slv2)``; ``cdata [n_cells, B, d1]``
    perturbed clinical; ``eps [n_cells, B, cd+s2]`` reparameterization
    noise (content columns first). A CUDA ``cdata`` launches the kernel, a
    CPU one runs the plain version."""
    if cdata.device.type == "cuda":
        return _launch_sweep(sp, posteriors, cdata, eps, dims,
                             sample_latents, method)
    if cdata.device.type == "cpu":
        return sweep_cells_reference(sp, posteriors, cdata, eps, dims,
                                     sample_latents, method)
    raise ValueError(f"avatar_sweep: no kernel for {cdata.device}")


@torch.no_grad()
def rois_posteriors(model, rois):
    """Cell-invariant ROI-encoder posteriors ``(cmu2, clv2, smu2, slv2)``."""
    names = model.mod_names
    enc = model.encode({names[1]: rois})
    cmu2, clv2 = enc[names[1]]
    smu2, slv2 = enc[names[1] + "_style"]
    return tuple(t.contiguous() for t in (cmu2, clv2, smu2, slv2))


@torch.no_grad()
def prepare_sweep(model, data, scores_values, generator: torch.Generator,
                  cfg):
    """The inputs of :func:`sweep_cells` for a whole sweep: ``(sp,
    posteriors, cdata, eps, dims)`` with one noise draw ``eps [n_samples *
    n_scores, B, cd + s2]`` from ``generator`` on the data's device."""
    names = model.mod_names
    clinical, rois = data[names[0]], data[names[1]]
    n_samples, b, n_scores = scores_values.shape
    dims = dims_from(cfg, b)
    sp = model_split_params(model, dims)
    cdata = build_cell_grid(clinical, scores_values)
    posteriors = rois_posteriors(model, rois)
    eps = torch.randn((n_samples * n_scores, b, dims.cd + dims.s2),
                      generator=generator, dtype=torch.float32,
                      device=clinical.device)
    return sp, posteriors, cdata, eps, dims


def avatar_layout(out, n_samples: int, n_scores: int):
    """``[n_samples * n_scores, B, d2]`` cells -> ``[B, n_scores,
    n_samples, d2]`` (a permuted view)."""
    return out.reshape(n_samples, n_scores, out.shape[1],
                       out.shape[2]).permute(2, 1, 0, 3)


@torch.no_grad()
def fused_avatar_sweep(model, data, scores_values, sample_latents: bool,
                       generator: torch.Generator, cfg):
    """Avatar sweep in the layout of
    :func:`multivae_tpu_torch.analysis.daa.avatar_sweep`:
    ``[B, n_scores, n_samples, n_rois]`` (a permuted view).

    ``data``: ``{clinical: [B, d1], rois: [B, d2]}``; ``scores_values``:
    ``[n_samples, B, n_scores]``; ``generator`` draws the noise on the
    data's device, and the kernel takes it as an input."""
    n_samples, _, n_scores = scores_values.shape
    sp, posteriors, cdata, eps, dims = prepare_sweep(
        model, data, scores_values, generator, cfg)
    out = sweep_cells(sp, posteriors, cdata, eps, dims, sample_latents,
                      method=cfg.method)
    return avatar_layout(out, n_samples, n_scores)
