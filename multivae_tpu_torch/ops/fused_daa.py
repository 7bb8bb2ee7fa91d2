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
import functools
from typing import Dict, NamedTuple, Optional

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
            [ptr] * 17 + [ctypes.c_longlong] + [i32] * 15
            + [ctypes.c_longlong, ptr])
        lib.avatar_sweep_launch.restype = i32
        lib.avatar_sweep_smem_bytes.argtypes = [i32] * 11
        lib.avatar_sweep_smem_bytes.restype = ctypes.c_longlong
        lib.avatar_sweep_error_string.argtypes = [i32]
        lib.avatar_sweep_error_string.restype = ctypes.c_char_p
    return lib


_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use
SWEEP_THREADS = 512  # threads per block (csrc kThreads)
SWEEP_ROWS = (32, 16, 8, 4)  # tile rows, in order of preference
# the kernel's tracing phases (csrc kPhases)
SWEEP_PHASES = ("inputs", "hidden", "heads", "latents", "decoder")
_CHUNK_FLOOR = 64  # the narrowest chunk a wide tile is worth


class SweepPlan(NamedTuple):
    """How the sweep kernel covers the rows. All but ``grid`` depend on the
    widths alone, so the sums of an element run in one order whatever the
    launch."""
    rows: int       # rows per tile
    split: int      # K splits of the content heads, added in order
    resident: bool  # weights copied once per block, else staged per tile
    h_chunk: int    # chunked: hidden columns per chunk
    k_chunk: int    # chunked: rows of [Wcmu|Wclv] per chunk
    n_chunk: int    # chunked: decoder columns per chunk
    grid: int       # persistent blocks
    smem: int       # bytes of shared memory per block


def _r4(n: int) -> int:
    return (n + 3) // 4 * 4


def _splits(dims, rows: int) -> int:
    """The most K splits of the content heads worth having: enough to keep
    the block's threads busy on the heads' micro-tiles of 4 x 4 (csrc
    kHeadRows, kHeadCols), each split of at least 16 rows of K, at most 16
    (the latents add them)."""
    tiles = (rows // 4) * (_r4(2 * dims.cd) // 4)
    return max(1, min(SWEEP_THREADS // tiles, dims.h // 16, 16))


def _sweep_floats(dims, rows: int, split: int, resident: bool,
                  h_chunk: int = 0, k_chunk: int = 0,
                  n_chunk: int = 0) -> int:
    """Floats of shared memory per block (csrc ``make_layout``)."""
    h4, cp, dp = _r4(dims.h), _r4(2 * dims.cd), _r4(dims.d2)
    kd = ew = dims.s2 + dims.cd
    tile = (2 * (_r4(rows * dims.d1) + _r4(rows * ew))
            + max(h4, kd) * rows + split * cp * rows)
    if resident:
        return (tile + dims.d1 * h4 + h4 + dims.h * cp + cp + kd * dp
                + dp)
    return tile + cp + max(dims.d1 * h_chunk + h_chunk, k_chunk * cp,
                           kd * n_chunk + n_chunk)


def _chunks(dims, rows: int, split: int, floor: int):
    """Even chunks of the hidden columns, the heads' K and the decoder
    columns that fit beside a tile of ``rows``, each at least
    ``min(floor, whole)`` wide, or None."""
    budget = _MAX_SMEM // 4 - _sweep_floats(dims, rows, split, False)
    h4, cp, dp = _r4(dims.h), _r4(2 * dims.cd), _r4(dims.d2)
    kd = dims.s2 + dims.cd
    most = (budget // (dims.d1 + 1) // 4 * 4, budget // cp,
            budget // (kd + 1) // 4 * 4)
    whole = (h4, dims.h, dp)
    least = (4, 1, 4)
    if any(m < max(lo, min(floor, w))
           for m, w, lo in zip(most, whole, least)):
        return None
    # as few chunks as fit, of even width
    even = [-(-w // -(-w // m)) for m, w in zip(most, whole)]
    return _r4(even[0]), even[1], _r4(even[2])


@functools.lru_cache(maxsize=64)
def _width_plan(dims) -> tuple:
    """The grid-free part of :func:`sweep_plan` (``SweepPlan`` less
    ``grid``)."""
    def fits(rows, split, resident, chunks=(0, 0, 0)):
        smem = 4 * _sweep_floats(dims, rows, split, resident, *chunks)
        return ((rows, split, resident, *chunks, smem)
                if smem <= _MAX_SMEM else None)

    # tiles of 16 rows or more: resident weights, else chunks of at least
    # 64; then narrower tiles likewise; then any chunks; within each, the
    # most splits that fit
    wide = [r for r in SWEEP_ROWS if r >= 16]
    narrow = [r for r in SWEEP_ROWS if r < 16]
    order = ([(r, True, _CHUNK_FLOOR) for r in wide]
             + [(r, False, _CHUNK_FLOOR) for r in wide]
             + [(r, res, _CHUNK_FLOOR) for r in narrow
                for res in (True, False)]
             + [(r, False, 1) for r in SWEEP_ROWS])
    for rows, resident, floor in order:
        for split in range(_splits(dims, rows), 0, -1):
            chunks = (0, 0, 0) if resident else _chunks(dims, rows, split,
                                                        floor)
            plan = chunks and fits(rows, split, resident, chunks)
            if plan:
                return plan
    raise ValueError(f"avatar_sweep: no tile of {SWEEP_ROWS[-1]} rows fits "
                     f"Hopper's {_MAX_SMEM} B of shared memory per block "
                     f"at widths {dims}")


def sweep_plan(dims, n_sms: int, n_rows: int) -> SweepPlan:
    """The kernel's plan: the weights resident in shared memory beside a
    tile of 32 or 16 rows, else staged per tile in chunks beside such a
    tile, else the same with 8 or 4 rows; ``grid`` is ``min(n_sms,
    tiles)``. Raises where nothing fits in one block's shared memory."""
    plan = _width_plan(dims._replace(b=0))
    grid = max(1, min(int(n_sms), -(-int(n_rows) // plan[0])))
    return SweepPlan(*plan[:-1], grid, plan[-1])


def _launch_sweep(sp, posteriors, cdata, eps, dims: FusedDims,
                  sample_latents: bool, method: str,
                  n_blocks: Optional[int] = None, phase_clocks=None):
    """Checks the inputs, plans and launches the kernel; ``n_blocks`` caps
    the grid (default: one block per SM). ``phase_clocks`` (tracing, one
    barrier more a tile): a contiguous int64 ``[n, len(SWEEP_PHASES)]`` on
    the cells' device, ``n`` at least the grid, whose first ``grid`` rows
    receive each block's SM cycles per phase."""
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
    n_rows = n_cells * b
    if n_blocks is None:
        n_blocks = torch.cuda.get_device_properties(
            device).multi_processor_count
    plan = sweep_plan(dims, n_blocks, n_rows)
    if phase_clocks is not None and (
            phase_clocks.device != device
            or phase_clocks.dtype != torch.int64
            or phase_clocks.dim() != 2
            or phase_clocks.shape[0] < plan.grid
            or phase_clocks.shape[1] != len(SWEEP_PHASES)
            or not phase_clocks.is_contiguous()):
        raise ValueError(f"avatar_sweep: phase_clocks is a contiguous int64 "
                         f"[>= {plan.grid}, {len(SWEEP_PHASES)}] on {device}")
    lib = _sweep_library()
    shape_args = (dims.d1, dims.h, dims.cd, dims.s2, dims.d2)
    plan_args = (plan.rows, plan.split, int(plan.resident), plan.h_chunk,
                 plan.k_chunk, plan.n_chunk)
    smem = lib.avatar_sweep_smem_bytes(*shape_args, *plan_args)
    if smem != plan.smem:
        raise RuntimeError(f"avatar_sweep: the kernel lays out {smem} B of "
                           f"shared memory, the plan {plan.smem} B")
    out = torch.empty((n_cells, b, dims.d2), dtype=torch.float32,
                      device=device)
    if n_rows == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.avatar_sweep_launch(
            cdata.data_ptr(), eps.data_ptr(),
            *[t.data_ptr() for t in enc + dec],
            *[t.data_ptr() for t in posteriors], out.data_ptr(),
            None if phase_clocks is None else phase_clocks.data_ptr(),
            n_rows, b, *shape_args, _METHOD_CODES[method],
            int(bool(sample_latents)), *plan_args, plan.grid, plan.smem,
            stream)
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
