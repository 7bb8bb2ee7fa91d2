#!/usr/bin/env python3
"""Drive the PyTorch port's `daa` and `train` paths (unsharded,
data-parallel, ensemble and deep-architecture) on one CUDA card and check
them.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA Hopper card (the kernels are built for sm_90a) and the CUDA
toolkit's ``nvcc``; it imports nothing of JAX. Flagship widths
throughout: clinical 7, ROIs 444, hidden 256, latent 20, style [3, 20].
Phases, one line or more each:

1. device: the card's name and power limit;
2. build: every ``multivae_tpu_torch/csrc/*.cu`` at once (one nvcc each),
   with ptxas' registers and spills;
3. kernel: the avatar-sweep kernel against its plain PyTorch version, B=50
   and 200 x 7 cells, four methods with and without sampled latents
   (atol = rtol = 1e-4), both timed with CUDA events;
4. train-kernel: every step route against its plain version at B=256, 64,
   164 (the flagship epoch's batches) and 137, with and without a learned
   output scale (loss rtol 1e-5; metrics
   and grads rtol 5e-4 / atol 1e-5): the MoPoE step; the method step for
   moe, jsd, poe without masks and for joint_elbo, moe, jsd, poe with
   dropout masks (rate 0.2); the presence step for the four methods,
   mod_idx 0 and 1, with and without masks (the three are persistent
   cooperative kernels: these are their one-step launches); flat Adam on
   random state at count 0 and 1000 (rtol 1e-6 / atol 1e-8); for the MoPoE
   step, every presence route and the method step of all four methods with
   and without masks (at B=256 and 64) ONE launch of 8 steps with Adam
   inside against 8 one-step launches with ``flat_adam`` between them from
   the same state (params, both moments and the ``[8, k]`` metrics equal
   bit for bit, and two runs of the launch equal), with the kernels' grid
   size and grid barriers per step; an 8-step epoch of each route against
   the plain versions (params, mu, nu rtol 1e-4 / atol 1e-5); and times in
   turns plain, kernel, kernel, plain: one step of each method, one launch
   of 6 steps with Adam (device time per step, and each phase's time by the
   kernel's own clock stamps), ``method_step`` on joint_elbo without masks
   (the MoPoE step's math on the method kernel, timed only), the Adam pass
   beside ``torch.optim.Adam(fused=True)``, one flagship epoch of device
   work (4 launches for its 8 steps); each kernel's bound from its bytes
   and operations;
5. slice: ``run_daa`` of a seeded-init flagship model on a numpy cohort
   (n_samples=200, n_validation=2), counting the sweep kernel's launches,
   and a small deterministic DAA on the card against the CPU;
6. train-slice: ``workflows.train_exp`` on a 2100-subject synthetic cohort
   (20 % without ROIs: 5 full + 1 partial complete batches, 1 full + 1
   partial clinical-only batches per epoch) for 5 epochs of joint_elbo
   and 3 epochs each of moe, jsd, poe and poe with dropout_rate=0.2,
   counting each kernel's launches (an epoch: 2 ``mopoe_step`` or
   ``method_step`` and 2 ``presence_step`` launches for its 6 + 2 steps,
   no ``flat_adam``) and the steps those launches ran, and checking
   losses, metric families and checkpoints; a profiled epoch of each
   (device busy time); ``workflows.daa_exp`` of the trained joint_elbo run;
   one epoch on the card against one on the CPU (each one-launch group
   replayed step by step from the state before it, to the launch's bits);
7. dp-kernel: the row-slice entry points of the MoPoE and method steps
   (``dp_step``, ``dp_method_step``) at B=256 split over 2 and 4 shards,
   for the MoPoE step and the seven method routes, with and without a
   learned output scale: every shard against its plain version with the
   same ``row_offset`` and ``b_total`` (the train-kernel bounds); the
   shards' summed gradients and rescaled metrics against the unsharded
   kernel on the whole batch (same bounds); the slice that is the whole
   batch against the unsharded kernel (equal bits); an 8-step
   data-parallel epoch of each route against the plain one; times of one
   slice step at 64 rows and of one whole 4-shard step, each with its
   bound;
8. dp-slice: ``train_exp(data_parallel=4)`` on the train-slice cohort,
   joint_elbo 3 epochs and poe with dropout_rate=0.2 2 epochs: launches
   (per epoch 5 full complete batches x 4 slice launches and one Adam
   update each, the partial complete batch and the 2 presence steps one
   launch per group with Adam inside), losses, metric families,
   checkpoints; the first epoch against a ``data_parallel=1`` run from the
   same seed; a profiled epoch;
9. ensemble-slice: ``train_exp(num_models=2, ensemble_parallel=True)``
   against ``ensemble_parallel=False`` from the same seed (every param and
   moment of both members bit-identical), and ``avatar_sweep_sharded``
   over a 4-entry mesh against the unsharded sweep (identical);
10. generic-kernel: the layer-stack step (``generic_step``, a persistent
   cooperative kernel for architectures outside the split layout) against
   its plain version at the flagship widths: deep-A (1 encoder + 1 decoder
   hidden layer, per-sample output scale), deep-B (2 + 1, per-feature
   scale), a 3 + 2 stack and a deep encoder before a linear decoder, each
   for the four methods, with and without dropout masks, with and without a
   learned scale, at B=256 and 137 (the train-kernel bounds); for every one
   of those 32 routes ONE launch of 8 steps with Adam against 8 one-step
   launches with ``flat_adam`` (equal bits, two runs equal); the grid,
   phases and barriers; 8-step epochs of seven routes, every step
   recomputed by the plain version from the kernels' state; times of one
   deep-A joint_elbo step and one deep-B poe step with masks (a one-step
   launch and a 6-step launch with each phase's stamps), each with its
   bound; then the other likelihoods (laplace; bernoulli on the data
   thresholded at 0; categorical on one-hot rows, whose loss has a phase
   of its own) and the unfactorized latent, at 1 + 0 and deep-A, the four
   methods, B=256, learned scale on and off: each step against the plain
   version, each 8-step launch against its one-step launches (equal bits),
   a laplace column tied in every row (the bias gradient of d|r|/dr = +1
   at r = 0), and per variant a one-step and a 6-step launch timed with
   each phase's stamps and the bound. A gradient element outside the bound
   is excused only behind a hidden unit that the plain version in float64
   puts within 1e-6 of its ReLU's edge, or a laplace residual that it puts
   within 1e-6 of 0 (two float32 sums may land on either side), and is
   printed;
11. generic-slice: ``train_exp`` on the train-slice cohort, 3 epochs each,
   of deep-A with joint_elbo, deep-B with poe and dropout_rate=0.2, the
   flagship architecture with likelihood laplace (joint_elbo) and an
   unfactorized latent with 1 + 1 hidden layers (moe): launches (per epoch
   one ``generic_step`` launch for the 5 full complete batches, Adam
   inside; the partial complete batch and the clinical-only batches on the
   general autograd step, 3 ``flat_adam`` updates), losses, metric
   families, checkpoints, a resumed fourth epoch, a profiled epoch, and the
   first epoch's launch replayed step by step (equal bits) and its steps
   recomputed by the plain version from the card's own state; then
   ``workflows.daa_exp`` of the deep-A and the laplace runs through the
   general sweep (wall per round), one round's sweep on the card held to
   the same function on the CPU from the same noise.

The meshes of phases 7-9 start at card 0 and wrap at the card count, so one
card holds every shard and member (on a machine with several cards they
spread over them). Any failed phase exits non-zero. The last three lines
are the JSON record of the kernels (``launches`` summed
over the main paths, each path's own counts in ``launches_by_path``, ``ms``
that of ``timed_variant``), the line of ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

FLAGSHIP = dict(method="joint_elbo", input_dim=[7, 444], class_dim=20,
                style_dim=[3, 20], hidden_dim=256,
                num_hidden_layer_encoder=1, num_hidden_layer_decoder=0,
                likelihood="normal", learn_output_scale=True)
B, N_SAMPLES = 50, 200
ATOL = RTOL = 1e-4
SEED = 1234


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flagship_cfg(method="joint_elbo", **kw):
    from multivae_tpu_torch.train.config import Config

    return Config(**{**FLAGSHIP, "method": method, **kw}).derive()


def kernel_check(device):
    """Phase kernel: the avatar sweep vs its plain version, all methods and
    both branches."""
    import torch

    from multivae_tpu_torch.models import build_model, make_modalities
    from multivae_tpu_torch.ops import fused_daa
    from multivae_tpu_torch.params import dims_from, model_split_params

    gen = torch.Generator(device=device).manual_seed(SEED)
    n_scores = FLAGSHIP["input_dim"][0]
    max_err, timing = 0.0, None
    for method in fused_daa.METHODS:
        cfg = flagship_cfg(method)
        model = build_model(cfg, make_modalities(
            cfg.input_dim, cfg.style_dim, cfg.likelihood), device, seed=SEED)
        dims = dims_from(cfg, B)
        clinical = torch.randn((B, dims.d1), generator=gen, device=device)
        rois = torch.randn((B, dims.d2), generator=gen, device=device)
        scores = torch.randn((N_SAMPLES, B, n_scores), generator=gen,
                             device=device)
        sp = model_split_params(model, dims)
        post = fused_daa.rois_posteriors(model, rois)
        cdata = fused_daa.build_cell_grid(clinical, scores)
        eps = torch.randn((cdata.shape[0], B, dims.cd + dims.s2),
                          generator=gen, device=device)
        for sample in (True, False):
            ker = fused_daa.sweep_cells(sp, post, cdata, eps, dims, sample,
                                        method=method)
            ref = fused_daa.sweep_cells_reference(sp, post, cdata, eps,
                                                  dims, sample, method)
            torch.cuda.synchronize()
            err = float((ker - ref).abs().max())
            max_err = max(max_err, err)
            ok = bool(torch.isfinite(ker).all()) and torch.allclose(
                ker, ref, rtol=RTOL, atol=ATOL)
            log("kernel", f"{method:10s} sample_latents={sample!s:5s} "
                f"cells={cdata.shape[0]} B={B} max_abs_err={err:.3e} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"kernel disagrees with the plain version "
                                 f"({method}, sample_latents={sample})")
            if method == "joint_elbo" and sample:
                def run_ker():
                    fused_daa.sweep_cells(sp, post, cdata, eps, dims, True,
                                          method=method)

                def run_ref():
                    fused_daa.sweep_cells_reference(sp, post, cdata, eps,
                                                    dims, True, method)
                # in turns on one card: plain, kernel, kernel, plain
                t = [cuda_ms(run_ref), cuda_ms(run_ker), cuda_ms(run_ker),
                     cuda_ms(run_ref)]
                # each input read once, the avatars written once; the
                # clinical encoder (content heads) and the ROI decoder per
                # row of every cell
                rows = cdata.shape[0] * B
                used = [sp[k] for k in sp if k.startswith(("enc1_Wh",
                        "enc1_bh", "enc1_Wc", "enc1_bc", "dec2_W",
                        "dec2_bd"))]
                timing = dict(
                    ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
                    library_ms=None,
                    **bound(nbytes(cdata, eps, ker, *post, *used),
                            2.0 * rows * (dims.d1 * dims.h
                                          + 2 * dims.h * dims.cd
                                          + (dims.s2 + dims.cd) * dims.d2)))
                log("kernel", f"joint_elbo sampled: kernel "
                    f"{t[1]:.4f}/{t[2]:.4f} ms, plain {t[0]:.4f}/"
                    f"{t[3]:.4f} ms per sweep of {cdata.shape[0]} cells; "
                    f"bound {timing['bound_ms']:.5f} ms by "
                    f"{timing['bound_by']}")
    return max_err, timing


# ------------------------------------------------------------ train kernels
STEP_RTOL, STEP_ATOL = 5e-4, 1e-5    # metrics and grads (test_fused_step)
LOSS_RTOL = 1e-5
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-8    # one update on identical inputs
EPOCH_RTOL, EPOCH_ATOL = 1e-4, 1e-5  # params, mu, nu after 8 steps
# one flagship epoch's steps (2100-subject synthetic cohort, 20 % without
# the ROI block, batch 256): 5 full + 1 partial complete batches, then the
# clinical-only group's full and partial batch
EPOCH_COMPLETE = (256, 256, 256, 256, 256, 64)
EPOCH_PRESENCE = (256, 164)
STEP_ROWS = (256, 64, 164, 137)  # rows of the step-vs-plain checks


# published peaks of one H100 SXM (dense): HBM3 bytes/s, and float32 FLOP/s
# outside the tensor cores (every product of these kernels is an f32 FMA)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
MASK_RATE = 0.2


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the f32 peak."""
    t_bytes = 1e3 * n_bytes / PEAK_BYTES_S
    t_ops = 1e3 * flops / PEAK_F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def step_flops(batch: int, enc_passes=(1, 1), dec_passes=(1, 1)) -> float:
    """Matmul FLOPs that one flagship train step needs: per row and pass,
    4 per multiply-add of an encoder's hidden layer (forward and weight
    gradient: nothing takes the gradient of the input rows) and 6 per
    multiply-add of its 4-head projection and of a decoder (forward, weight
    gradient and the gradient of the activations that feed it)."""
    d, s = FLAGSHIP["input_dim"], FLAGSHIP["style_dim"]
    h, cd = FLAGSHIP["hidden_dim"], FLAGSHIP["class_dim"]
    per_row = sum(enc_passes[e] * (4 * d[e] * h + 6 * h * 2 * (cd + s[e]))
                  + dec_passes[e] * 6 * (s[e] + cd) * d[e] for e in range(2))
    return float(per_row * batch)


def close(a, b, rtol, atol):
    """``(max_abs_err, mask of elements outside atol + rtol |b|)``."""
    diff = (a - b).abs()
    bad = ~(diff <= atol + rtol * b.abs())
    return float(diff.max()) if diff.numel() else 0.0, bad


def train_setup(device, b: int, seed: int):
    """Seeded flagship params (flat), a batch and its noise on ``device``."""
    import torch

    from multivae_tpu_torch.models import build_model, make_modalities
    from multivae_tpu_torch.params import dims_from, model_flat_params

    cfg = flagship_cfg(seed=seed)
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), device,
                        seed=seed)
    dims = dims_from(cfg, b)
    gen = torch.Generator(device=device).manual_seed(seed)
    x1 = torch.randn((b, dims.d1), generator=gen, device=device)
    x2 = torch.randn((b, dims.d2), generator=gen, device=device)
    noise = torch.randn((b, dims.cd + dims.s1 + dims.s2), generator=gen,
                        device=device)
    return cfg, dims, model_flat_params(model, dims), x1, x2, noise


def check_step(name, ker, ref, names, log_prefix, phase="train-kernel",
               quiet=False, excuse=None):
    """Hold one step's (metrics, grads) of the kernel to the plain
    version; returns the max abs error over metrics and grads.

    ``excuse`` (called only after a mismatch) returns ``(mask, text)``: the
    gradient elements that lie behind a branch the two versions may take
    differently at the rounding level (:func:`rounding_level_units`), which
    are then not held, and what they are; everything else still is."""
    import torch

    (km, kg), (rm, rg) = ker, ref
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(km).all() and torch.isfinite(kg).all())
    loss_err, loss_bad = close(km[:1], rm[:1], LOSS_RTOL, 0.0)
    m_err, m_bad = close(km, rm, STEP_RTOL, STEP_ATOL)
    g_err, g_bad = close(kg, rg, STEP_RTOL, STEP_ATOL)
    worst = max(m_err, g_err)
    excused = ""
    if bool(g_bad.any()) and excuse is not None:
        mask, text = excuse()
        n_out = int(g_bad.sum())
        g_bad = g_bad & ~mask
        excused = (f"; {n_out - int(g_bad.sum())} of {n_out} gradient "
                   f"elements outside the bound lie behind {text} and are "
                   f"not held")
    diff = (kg - rg).abs()
    bad_tensors = [
        f"{tname}({int(bt.sum())}, {float(dt.max()):.2e})"
        for tname, (bt, dt) in names(g_bad.to(torch.uint8), diff)
        if bool(bt.any())]
    ok = (finite and not bool(loss_bad.any()) and not bool(m_bad.any())
          and not bad_tensors)
    if not (ok and quiet and not excused):
        log(phase, f"{name} {log_prefix} loss {float(km[0]):.6f} vs "
            f"{float(rm[0]):.6f} (err {loss_err:.2e}), metrics max_abs_err "
            f"{m_err:.2e}, metrics+grads max_abs_err {worst:.3e} "
            f"{'ok' if ok else 'MISMATCH ' + ' '.join(bad_tensors)}"
            + excused)
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version "
                         f"({log_prefix})")
    return worst


def split_pairs(dims):
    from multivae_tpu_torch.params import flat_views

    def pairs(kg, rg):
        kv, rv = flat_views(kg, dims), flat_views(rg, dims)
        return [(n, (kv[n], rv[n])) for n in kv]
    return pairs


def hold_epoch(phase, name, ker, ref, ker_grads, ref_grads, dims,
               branch=None, downstream_ok=False):
    """Hold two runs of one epoch from the same state and inputs to each
    other: ``ker``/``ref`` the state after it (tuples of flat tensors),
    ``ker_grads``/``ref_grads`` each step's gradients.

    The first step's gradients agree at the step bound everywhere. The
    state after the epoch agrees at the epoch bound, except for two kinds
    of element, counted and printed:

    * Adam's trap: Adam divides a gradient by its own size, so an element
      whose gradient is within rounding of zero can move by up to ~lr in
      one run only. Such an element's two gradients agree at the step
      bound at every step, yet at some step differ by more than half the
      larger of the two (two exact zeros never do);
    * ``branch``: elements the caller shows to lie behind a branch taken
      at the rounding level (:func:`relu_flips`).

    Any other element outside the bound fails, unless ``downstream_ok``: a
    caller that has also held every step of one run to the other's
    functions from the same state may accept what parts downstream of the
    trap. An element that fell into the trap (its gradients agreed at the
    step bound at every step so far, and at this step differ by more than
    half the larger) moved by ~lr in one run only; from the next step on
    the two runs compute different functions (hidden units near zero change
    branch), so other elements part too. Then the count of such elements
    and the first trap step are printed, and the run fails only if no
    element was trapped before. Returns the max abs error."""
    import torch

    from multivae_tpu_torch.params import flat_views

    err1, bad1 = close(ker_grads[0], ref_grads[0], STEP_RTOL, STEP_ATOL)
    split, grads_apart = torch.zeros_like(bad1), torch.zeros_like(bad1)
    for a, b in zip(ker_grads, ref_grads):
        split |= (a - b).abs() > 0.5 * torch.maximum(a.abs(), b.abs())
        grads_apart |= close(a, b, STEP_RTOL, STEP_ATOL)[1]
    trap = split & ~grads_apart
    if branch is None:
        branch = torch.zeros_like(trap)
    worst, outside = 0.0, torch.zeros_like(bad1)
    for a, b in zip(ker, ref):
        err, bad = close(a, b, EPOCH_RTOL, EPOCH_ATOL)
        worst, outside = max(worst, err), outside | bad
    counts = {k: int(v.sum()) for k, v in flat_views(
        (outside & (trap | branch)).to(torch.uint8), dims).items() if v.any()}
    log(phase, f"{name}: first-step grads max_abs_err {err1:.3e}; state "
        f"after the epoch max_abs_err {worst:.3e}, {int(outside.sum())} "
        f"elements outside rtol {EPOCH_RTOL} / atol {EPOCH_ATOL}: "
        f"{int((outside & trap).sum())} in Adam's trap (of "
        f"{int(trap.sum())} elements there), "
        f"{int((outside & branch & ~trap).sum())} behind a rounding-level "
        f"branch (of {int(branch.sum())})"
        + (f"; by tensor: {counts}" if counts else ""))
    if bool((bad1 & ~branch).any()):
        raise SystemExit(f"{name}: the first step's gradients disagree")
    left = outside & ~(trap | branch)
    if downstream_ok and bool(left.any()):
        # the trap in step order: an element counts from the step at which
        # it splits while it has agreed at the step bound so far
        agreed, first = torch.ones_like(trap), None
        early = torch.zeros_like(trap)
        for s, (a, b) in enumerate(zip(ker_grads, ref_grads)):
            agreed &= ~close(a, b, STEP_RTOL, STEP_ATOL)[1]
            now = agreed & ((a - b).abs() > 0.5 * torch.maximum(a.abs(),
                                                                b.abs()))
            if first is None and bool(now.any()):
                first = s
            early |= now
        if first is not None:
            log(phase, f"{name}: {int(early.sum())} elements fell into "
                f"Adam's trap while both runs still agreed (the first at "
                f"step {first}); {int((left & ~early).sum())} other "
                f"elements part downstream of them and are not held here")
            left = torch.zeros_like(left)
    if bool(left.any()):
        j = int(torch.argmax(sum((a - b).abs() for a, b in zip(ker, ref))
                             * left))
        log(phase, f"{name}: not excused, by tensor: "
            + str({k: int(v.sum()) for k, v in flat_views(
                left.to(torch.uint8), dims).items() if v.any()})
            + f"; worst element [{j}]: state "
            + str([(float(a[j]), float(b[j])) for a, b in zip(ker, ref)])
            + "; its gradient at each step: "
            + str([(float(a[j]), float(b[j]))
                   for a, b in zip(ker_grads, ref_grads)]))
        raise SystemExit(f"{name}: {int((outside & ~(trap | branch)).sum())}"
                         f" elements disagree beyond the epoch bound")
    return worst


class Route:
    """One step route of the trainer at the flagship widths: its kernel,
    its plain version, and the noise and masks it takes. ``kind`` is
    ``mopoe``, ``method`` or ``presence``."""

    def __init__(self, kind, method="joint_elbo", mod_idx=None,
                 masked=False):
        self.kind, self.method = kind, method
        self.mod_idx, self.masked = mod_idx, masked
        self.kernel = {"mopoe": "mopoe_step", "method": "method_step",
                       "presence": "presence_step"}[kind]
        # the kernel's row-slice entry point (complete batches only)
        self.dp_kernel = {"mopoe": "dp_step", "method": "dp_method_step",
                          "presence": None}[kind]
        tag = [] if kind == "mopoe" else [method]
        if mod_idx is not None:
            tag.append(f"mod_idx={mod_idx}")
        if masked:
            tag.append("masks")
        self.name = self.kernel + (f"[{', '.join(tag)}]" if tag else "")
        poe = method == "poe"
        # passes through (encoder 1, encoder 2) and (decoder 1, decoder 2)
        present = [1, 1] if mod_idx is None else [int(mod_idx == e)
                                                  for e in range(2)]
        self.dec_passes = [n * (2 if poe else 1) for n in present]
        self.enc_passes = [n * (2 if poe and masked else 1)
                           for n in present]

    def noise_width(self, dims) -> int:
        s = (dims.s1, dims.s2)
        if self.kind == "presence":
            return (dims.cd + s[self.mod_idx]) * (
                2 if self.method == "poe" else 1)
        w = dims.cd + dims.s1 + dims.s2
        return w + (2 * dims.cd + dims.s1 + dims.s2
                    if self.method == "poe" else 0)

    def n_masks(self) -> int:
        if not self.masked:
            return 0
        per_pass = 1 if self.kind == "presence" else 2
        return per_pass * (2 if self.method == "poe" else 1)

    def inputs(self, dims, gen, device, steps=None):
        """Seeded ``(x1, x2, noise, masks)`` on the card, with a leading
        ``steps`` axis if given."""
        import torch

        lead = () if steps is None else (steps,)
        b = dims.b

        def randn(*shape):
            return torch.randn(lead + shape, generator=gen, device=device)

        x1, x2 = randn(b, dims.d1), randn(b, dims.d2)
        noise = randn(b, self.noise_width(dims))
        masks = None
        if self.masked:
            keep = torch.rand(lead + (self.n_masks(), b, dims.h),
                              generator=gen, device=device) < 1 - MASK_RATE
            masks = keep.float() / (1 - MASK_RATE)
        return x1, x2, noise, masks

    def step(self, version, p, inp, dims, consts, learn_scale=True):
        """``(metrics, grads)`` (flat) of one step by the kernel or the
        plain version."""
        from multivae_tpu_torch.ops import fused_methods as fm
        from multivae_tpu_torch.ops import fused_presence as fp
        from multivae_tpu_torch.ops import fused_step as fs
        from multivae_tpu_torch.params import flat_views, flatten_split

        x1, x2, noise, masks = inp
        x = x1 if self.mod_idx == 0 else x2
        if version == "kernel":
            if self.kind == "mopoe":
                return fs.step_flat(p, x1, x2, *fs.split_noise(noise, dims),
                                    dims, consts, learn_scale)
            if self.kind == "method":
                return fm.method_step_flat(self.method, p, x1, x2, noise,
                                           dims, consts, learn_scale, masks)
            return fp.presence_step_flat(p, x, noise, dims, consts,
                                         learn_scale, self.mod_idx,
                                         self.method, masks)
        sp = flat_views(p, dims)
        if self.kind == "mopoe":
            _, m, g = fs.fwd_bwd_reference(
                sp, x1, x2, *fs.split_noise(noise, dims), dims, consts,
                learn_scale)
        elif self.kind == "method":
            _, m, g = fm.method_fwd_bwd_reference(
                self.method, sp, x1, x2, noise, dims, consts, learn_scale,
                masks)
        else:
            _, m, g = fp.presence_fwd_bwd_reference(
                sp, x, noise, dims, consts, learn_scale, self.mod_idx,
                self.method, masks)
        return m, flatten_split(g)

    def launch_epoch(self, p, mu, nu, count, stacks, dims, consts, hyper,
                     phase_times=None):
        """The route's whole group of steps with their Adam updates in ONE
        launch of its persistent kernel (``stacks``: :meth:`inputs` with a
        leading steps axis); ``p``, ``mu``, ``nu`` are updated in place;
        ``phase_times`` takes the kernel's clock stamps. Returns ``metrics
        [n, k]``."""
        from multivae_tpu_torch.ops import fused_methods as fm
        from multivae_tpu_torch.ops import fused_presence as fp
        from multivae_tpu_torch.ops import fused_step as fs

        x1s, x2s, noises, masks = stacks
        if self.kind == "mopoe":
            return fs.epoch_flat(p, mu, nu, count, x1s, x2s, noises, dims,
                                 consts, hyper, True, phase_times)
        if self.kind == "method":
            return fm.method_epoch_flat(self.method, p, mu, nu, count, x1s,
                                        x2s, noises, dims, consts, hyper,
                                        True, masks, phase_times)
        xs = x1s if self.mod_idx == 0 else x2s
        return fp.presence_epoch_flat(p, mu, nu, count, xs, noises, dims,
                                      consts, hyper, True, self.mod_idx,
                                      self.method, masks, phase_times)

    def phases(self, dims):
        """The persistent kernel's phases, in order."""
        from multivae_tpu_torch.ops import fused_step as fs

        return fs.PHASES

    def geometry(self, dims, device):
        """Grid blocks and barriers per step of the route's persistent
        kernel at these sizes."""
        from multivae_tpu_torch.ops import fused_methods as fm
        from multivae_tpu_torch.ops import fused_presence as fp
        from multivae_tpu_torch.ops import fused_step as fs

        if self.kind == "mopoe":
            return fs.launch_geometry(dims, device)
        if self.kind == "method":
            return fm.launch_geometry(dims, device, self.method, self.masked)
        return fp.launch_geometry(dims, device, self.mod_idx, self.method,
                                  self.masked)

    def slice_step(self, version, p, inp, local, consts, learn_scale,
                   row_offset, b_total):
        """``(metrics, grads)`` (flat, partial sums) of one step on a row
        slice by the kernel's row-slice entry point or the plain version;
        ``inp`` holds the slice's rows, ``local.b`` of them."""
        from multivae_tpu_torch.ops import fused_methods as fm
        from multivae_tpu_torch.ops import fused_step as fs
        from multivae_tpu_torch.params import flat_views, flatten_split

        x1, x2, noise, masks = inp
        if version == "kernel":
            if self.kind == "mopoe":
                return fs.slice_step_flat(
                    p, x1, x2, *fs.split_noise(noise, local), local, consts,
                    learn_scale, row_offset, b_total)
            return fm.slice_method_step_flat(
                self.method, p, x1, x2, noise, local, consts, learn_scale,
                masks, row_offset, b_total)
        sp = flat_views(p, local)
        if self.kind == "mopoe":
            _, m, g = fs.fwd_bwd_reference(
                sp, x1, x2, *fs.split_noise(noise, local), local, consts,
                learn_scale, row_offset, b_total)
        else:
            _, m, g = fm.method_fwd_bwd_reference(
                self.method, sp, x1, x2, noise, local, consts, learn_scale,
                masks, row_offset, b_total)
        return m, flatten_split(g)

    def bound(self, p, inp, dims) -> dict:
        """The step's bound from this run's tensors: the params it reads,
        its batch, noise and masks in, every gradient and the metrics out;
        the operations of its passes."""
        from multivae_tpu_torch.params import flat_views

        x1, x2, noise, masks = inp
        read = nbytes(*[v for k, v in flat_views(p, dims).items()
                        if self.mod_idx is None
                        or k[3] == str(self.mod_idx + 1)])
        xs = (x1, x2) if self.mod_idx is None else (
            (x1,) if self.mod_idx == 0 else (x2,))
        moved = read + nbytes(*xs, noise, masks) + nbytes(p) + 4 * 19
        return bound(moved, step_flops(dims.b, self.enc_passes,
                                       self.dec_passes))


MASK_CASES = ([(m, False) for m in ("moe", "jsd", "poe")]
              + [(m, True) for m in ("joint_elbo", "moe", "jsd", "poe")])


def all_routes():
    """Every step route the trainer can take at the flagship layout."""
    routes = [Route("mopoe")]
    routes += [Route("method", m, None, masked) for m, masked in MASK_CASES]
    for mod_idx in (0, 1):
        routes.append(Route("presence", "joint_elbo", mod_idx))
        routes += [Route("presence", m, mod_idx, masked)
                   for m, masked in MASK_CASES]
    return routes


def epoch_check(route, p0, dims, consts, hyper, gen, device):
    """An 8-step epoch of one route on the kernels and on the plain
    versions from the same state, held by :func:`hold_epoch`."""
    import torch

    from multivae_tpu_torch.ops import adam as adam_ops
    from multivae_tpu_torch.ops.adam import init_adam_state

    x1s, x2s, noises, masks = route.inputs(dims, gen, device, steps=8)
    states, grads = {}, {}
    for version in ("kernel", "plain"):
        p = p0.clone()
        st = init_adam_state(p)
        grads[version] = []
        update = (adam_ops.adam_update if version == "kernel"
                  else adam_ops.adam_update_reference)
        for i in range(8):
            inp = (x1s[i], x2s[i], noises[i],
                   None if masks is None else masks[i])
            _, g = route.step(version, p, inp, dims, consts)
            update(p, st.mu, st.nu, g, i + 1, hyper)
            grads[version].append(g)
        states[version] = (p, st.mu, st.nu)
    torch.cuda.synchronize()
    return hold_epoch("train-kernel", f"{route.name} + flat_adam 8-step "
                      f"epoch", states["kernel"], states["plain"],
                      grads["kernel"], grads["plain"], dims)


def launch_vs_steps(route, p0, dims, consts, hyper, gen, device, n=8,
                    count=3, phase="train-kernel"):
    """One launch of ``n`` steps with the in-kernel Adam against ``n``
    launches of one step with ``flat_adam`` between them, from the same
    state on the same inputs: params, both moments and the ``[n, k]``
    metrics must be equal bit for bit, and a second run of the one launch
    must give the first one's bits."""
    import torch

    from multivae_tpu_torch.ops import adam as adam_ops

    stacks = route.inputs(dims, gen, device, steps=n)
    runs = []
    for _ in range(2):
        st = [p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)]
        runs.append(st + [route.launch_epoch(*st, count, stacks, dims,
                                             consts, hyper)])
    q, mu, nu = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
    rows = []
    for i in range(n):
        inp = tuple(None if t is None else t[i] for t in stacks)
        m, g = route.step("kernel", q, inp, dims, consts)
        adam_ops.adam_update(q, mu, nu, g, count + i + 1, hyper)
        rows.append(m)
    torch.cuda.synchronize()
    stepwise = [q, mu, nu, torch.stack(rows)]
    same = all(torch.equal(a, b) for a, b in zip(runs[0], stepwise))
    again = all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    log(phase, f"{route.name} B={dims.b}: one launch of {n} steps with Adam "
        f"vs {n} launches of 1 step + flat_adam (count {count}): params, mu, "
        f"nu, metrics equal bits {same}; two runs of the launch equal bits "
        f"{again}")
    if not (same and again):
        raise SystemExit(f"{route.name}: the {n}-step launch is not its "
                         f"steps one by one, bit for bit")


def time_launch(route, p0, dims, consts, hyper, gen, device, phase, group=6):
    """One launch of ``group`` steps with Adam by CUDA events (device time:
    nothing but the kernel runs between the two events) and, from one more
    launch, each phase's time by the kernel's own clock (steps 2..: the
    first step also warms the caches). Returns the record entries."""
    import torch

    from multivae_tpu_torch.ops import fused_step as fs

    stacks = route.inputs(dims, gen, device, steps=group)
    st = [p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)]
    launch_ms = (cuda_ms(lambda: route.launch_epoch(
        *st, 0, stacks, dims, consts, hyper), 20)
        + cuda_ms(lambda: route.launch_epoch(
            *st, 0, stacks, dims, consts, hyper), 20)) / 2
    names = route.phases(dims)
    stamps = torch.zeros(group, len(names) + 1, dtype=torch.int64,
                         device=device)
    route.launch_epoch(*st, 0, stacks, dims, consts, hyper, stamps)
    phase_us = fs.phase_microseconds(stamps)[1:].mean(0).tolist()
    bound_ms = route.bound(p0, tuple(None if t is None else t[0]
                                     for t in stacks), dims)["bound_ms"]
    log(phase, f"{route.name} B={dims.b}: one launch of {group} steps with "
        f"Adam {launch_ms:.4f} ms = {launch_ms / group:.4f} ms per step with "
        f"its Adam (device time) = {100 * bound_ms * group / launch_ms:.2f} "
        f"% of the bound's rate; by the kernel's clock {sum(phase_us):.1f} "
        f"us per step, phases with their barriers (us): "
        + ", ".join(f"{k} {v:.1f}" for k, v in zip(names, phase_us)))
    return dict(launch_steps=group, launch_ms=launch_ms,
                step_ms_in_launch=launch_ms / group,
                phase_us=dict(zip(names, phase_us)))


def train_kernel_check(device):
    """Phase train-kernel: every step route and the Adam kernel against
    their plain versions at the flagship widths (one-step launches), the
    persistent kernels' 8-step launch against 8 one-step launches with
    ``flat_adam`` (equal bits), 8-step epochs of each route, and times
    (CUDA events, in turns plain, kernel, kernel, plain) beside each
    kernel's bound."""
    import torch

    from multivae_tpu_torch.ops import adam as adam_ops
    from multivae_tpu_torch.ops import fused_step as fs
    from multivae_tpu_torch.params import dims_from

    result = {k: {"max_abs_err": 0.0, "variants": {}} for k in
              ("mopoe_step", "method_step", "presence_step", "flat_adam")}
    # beta_style != 1 so the squared style factor shows
    consts = fs.FusedConsts(1.0, 0.7, 1.2)
    hyper = adam_ops.AdamHyper(2e-3, 0.9, 0.999)
    routes = all_routes()
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    # the flagship epoch's full and partial batches, and a row count that
    # neither 2 nor 3 divides
    for b in STEP_ROWS:
        cfg, dims, p, _, _, _ = train_setup(device, b, SEED + b)
        for route in routes:
            for learn_scale in (True, False):
                inp = route.inputs(dims, gen, device)
                err = check_step(
                    route.name,
                    route.step("kernel", p, inp, dims, consts, learn_scale),
                    route.step("plain", p, inp, dims, consts, learn_scale),
                    split_pairs(dims), f"B={b} learn_scale={learn_scale}")
                result[route.kernel]["max_abs_err"] = max(
                    result[route.kernel]["max_abs_err"], err)

    # Adam on random state at count 0 and 1000
    gen = torch.Generator(device=device).manual_seed(SEED)
    n = p.numel()
    for count in (0, 1000):
        p0 = torch.randn(n, generator=gen, device=device)
        g = torch.randn(n, generator=gen, device=device)
        mu0 = 0.1 * torch.randn(n, generator=gen, device=device)
        nu0 = 0.01 * torch.rand(n, generator=gen, device=device)
        outs = []
        for fn in (adam_ops.adam_update, adam_ops.adam_update_reference):
            st = [p0.clone(), mu0.clone(), nu0.clone()]
            fn(*st, g, count + 1, hyper)
            outs.append(st)
        torch.cuda.synchronize()
        worst = 0.0
        for kt, rt in zip(*outs):
            err, bad = close(kt, rt, ADAM_RTOL, ADAM_ATOL)
            worst = max(worst, err)
            if bool(bad.any()):
                raise SystemExit(f"flat_adam disagrees with its plain "
                                 f"version at count {count}")
        result["flat_adam"]["max_abs_err"] = max(
            result["flat_adam"]["max_abs_err"], worst)
        log("train-kernel", f"flat_adam count={count} n={n}: params/mu/nu "
            f"max_abs_err {worst:.3e} (rtol {ADAM_RTOL}, atol {ADAM_ATOL}) "
            f"ok")

    # 8-step epochs of each route, kernels against plain versions
    cfg, dims, p0, _, _, _ = train_setup(device, 256, SEED)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    # the persistent kernels: a group of steps in one launch is its steps
    # one by one (which also shows the in-kernel Adam equal to flat_adam)
    # (a generator of its own: the epochs below keep their inputs); the
    # method step for all four methods with and without masks, at the full
    # and the partial batch of an epoch
    launch_gen = torch.Generator(device=device).manual_seed(SEED + 8)
    method_routes = [Route("method", m, None, masked)
                     for m in ("joint_elbo", "moe", "jsd", "poe")
                     for masked in (False, True)]
    for route in routes:
        if route.kind != "method":
            launch_vs_steps(route, p0, dims, consts, hyper, launch_gen,
                            device)
    for b in (256, 64):
        for route in method_routes:
            launch_vs_steps(route, p0, dims._replace(b=b), consts, hyper,
                            launch_gen, device)
    geo_routes = [r for r in routes if r.mod_idx in (None, 0) and (
        r.method in ("joint_elbo", "poe")
        or r.name == "method_step[moe]")]
    geo = {r.name: r.geometry(dims, device) for r in geo_routes}
    log("train-kernel", "persistent kernels at B=256, cooperative grid "
        "blocks and grid barriers per step (with Adam / one step without): "
        + "; ".join(f"{k} {v['grid_blocks']} blocks, "
                    f"{v['barriers_per_step_adam']} / "
                    f"{v['barriers_per_step']} barriers"
                    for k, v in geo.items()))
    result["mopoe_step"]["geometry"] = geo["mopoe_step"]
    result["method_step"]["geometry"] = geo["method_step[poe, masks]"]
    result["presence_step"]["geometry"] = geo[
        "presence_step[joint_elbo, mod_idx=0]"]
    for route in routes:
        err = epoch_check(route, p0, dims, consts, hyper, gen, device)
        worst = result[route.kernel].get("epoch_err", 0.0)
        result[route.kernel]["epoch_err"] = max(worst, err)

    # ---- timing, in turns: plain, kernel, kernel, plain
    p = p0.clone()

    def time_pair(ker_fn, ref_fn, iters=50):
        t = [cuda_ms(ref_fn, iters), cuda_ms(ker_fn, iters),
             cuda_ms(ker_fn, iters), cuda_ms(ref_fn, iters)]
        return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t

    # the route whose time stands for its kernel in the record, then the
    # other methods' steps
    headline = {"mopoe_step": "mopoe_step", "method_step":
                "method_step[poe]", "presence_step":
                "presence_step[joint_elbo, mod_idx=0]"}
    timed = [r for r in routes if r.kind != "presence"
             or (r.mod_idx == 0 and r.method in ("joint_elbo", "poe"))]
    # timed only: the MoPoE step's math on the method kernel, in the same
    # call as the MoPoE kernel
    timed.insert(1, Route("method", "joint_elbo", None, False))
    for route in timed:
        inp = route.inputs(dims, gen, device)
        ker_ms, plain_ms, t = time_pair(
            lambda: route.step("kernel", p, inp, dims, consts),
            lambda: route.step("plain", p, inp, dims, consts), iters=30)
        entry = dict(ms=ker_ms, plain_ms=plain_ms, library_ms=None,
                     **route.bound(p, inp, dims))
        entry.update(time_launch(route, p0, dims, consts, hyper, gen, device,
                                 "train-kernel"))
        result[route.kernel]["variants"][route.name] = entry
        if headline[route.kernel] == route.name:
            result[route.kernel].update(entry, timed_variant=route.name)
        fl = step_flops(256, route.enc_passes, route.dec_passes)
        log("train-kernel", f"{route.name} B=256: kernel {t[1]:.4f}/"
            f"{t[2]:.4f} ms, plain {t[0]:.4f}/{t[3]:.4f} ms per one-step "
            f"launch; bound {entry['bound_ms']:.5f} ms by {entry['bound_by']} "
            f"({fl / 1e6:.1f} MFLOP); kernel "
            f"{fl / (ker_ms * 1e-3) / 1e12:.3f} TFLOP/s = "
            f"{100 * entry['bound_ms'] / ker_ms:.2f} % of the bound's rate")

    # Adam in place on one state, beside torch's fused Adam on one flat
    # parameter (the library call; the port never calls it)
    q = p0.clone()
    mu, nu = torch.zeros_like(q), torch.zeros_like(q)
    g = torch.randn(q.numel(), generator=gen, device=device) * 1e-3
    lib_p = torch.nn.Parameter(p0.clone())
    lib_p.grad = g.clone()
    lib = torch.optim.Adam([lib_p], lr=hyper.lr, betas=(hyper.b1, hyper.b2),
                           eps=hyper.eps, fused=True)
    r = p0.clone()
    rmu, rnu = torch.zeros_like(r), torch.zeros_like(r)
    ker_ms, plain_ms, t = time_pair(
        lambda: adam_ops.adam_update(q, mu, nu, g, 1, hyper),
        lambda: adam_ops.adam_update_reference(r, rmu, rnu, g, 1, hyper))
    lib_ms = cuda_ms(lib.step, 50)
    result["flat_adam"].update(
        ms=ker_ms, plain_ms=plain_ms, library_ms=lib_ms,
        **bound(nbytes(q, mu, nu, g) + nbytes(q, mu, nu), 12.0 * q.numel()))
    log("train-kernel", f"flat_adam n={q.numel()}: kernel {t[1]:.4f}/"
        f"{t[2]:.4f} ms, plain {t[0]:.4f}/{t[3]:.4f} ms, "
        f"torch.optim.Adam(fused=True) {lib_ms:.4f} ms per update in place; "
        f"bound {result['flat_adam']['bound_ms']:.5f} ms by "
        f"{result['flat_adam']['bound_by']}")

    # one flagship epoch of device work: 6 complete + 2 clinical-only steps
    mopoe, presence = routes[0], next(
        r for r in routes if r.name == headline["presence_step"])
    # the trainer's groups: (route, rows) -> the group's stacked inputs
    groups = []
    for route, sizes in ((mopoe, EPOCH_COMPLETE), (presence, EPOCH_PRESENCE)):
        for b in dict.fromkeys(sizes):
            bdims = dims_from(cfg, b)
            groups.append((route, bdims, route.inputs(
                bdims, gen, device, steps=sizes.count(b))))

    def epoch(version):
        q, m_, v_ = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
        t = 0
        for route, bdims, stacks in groups:
            n = stacks[0].shape[0]
            if version == "kernel":  # one launch per group
                route.launch_epoch(q, m_, v_, t, stacks, bdims, consts,
                                   hyper)
            else:
                for i in range(n):
                    inp = tuple(None if s is None else s[i] for s in stacks)
                    _, gg = route.step("plain", q, inp, bdims, consts)
                    adam_ops.adam_update_reference(q, m_, v_, gg, t + i + 1,
                                                   hyper)
            t += n

    ker_ms, plain_ms, t = time_pair(lambda: epoch("kernel"),
                                    lambda: epoch("plain"), iters=10)
    n_steps = len(EPOCH_COMPLETE) + len(EPOCH_PRESENCE)
    result["epoch"] = dict(ms=ker_ms, plain_ms=plain_ms, steps=n_steps)
    log("train-kernel", f"flagship epoch ({n_steps} steps in {len(groups)} "
        f"launches: complete B="
        f"{list(EPOCH_COMPLETE)}, clinical-only B={list(EPOCH_PRESENCE)}): "
        f"kernels {t[1]:.4f}/{t[2]:.4f} ms = "
        f"{n_steps / (ker_ms * 1e-3):.1f} steps/s, plain {t[0]:.4f}/"
        f"{t[3]:.4f} ms = {n_steps / (plain_ms * 1e-3):.1f} steps/s")
    return result


# ------------------------------------------------------- row-slice kernels
DP_SHARDS = (2, 4)   # local rows 128 and 64 of B=256
DP_TIMED = ("mopoe_step", "method_step[poe, masks]")


def shard_inputs(inp, rows):
    """The rows ``rows`` of one step's ``(x1, x2, noise, masks)``: views."""
    x1, x2, noise, masks = inp
    return (x1[rows], x2[rows], noise[rows],
            None if masks is None else masks[:, rows])


def sharded(route, version, p, inp, dims, consts, n_dev, learn_scale=True):
    """Every shard's ``(metrics, grads)`` of one step of ``route``, and
    their sums in shard order (the metrics rescaled): ``(shards, whole)``."""
    from multivae_tpu_torch.ops.fused_sharded import mean_rescale

    local = dims._replace(b=dims.b // n_dev)
    shards, msum, gsum = [], None, None
    for k in range(n_dev):
        rows = slice(k * local.b, (k + 1) * local.b)
        m, g = route.slice_step(version, p, shard_inputs(inp, rows), local,
                                consts, learn_scale, k * local.b, dims.b)
        shards.append((m, g))
        msum = m if msum is None else msum + m
        gsum = g if gsum is None else gsum + g
    return shards, (mean_rescale(msum, n_dev), gsum)


@contextlib.contextmanager
def recording_adam(module):
    """Collect the gradient of every Adam update that ``module`` makes."""
    grads, saved = [], module.adam_update

    def update(p, mu, nu, g, t, hyper):
        grads.append(g.clone())
        saved(p, mu, nu, g, t, hyper)

    module.adam_update = update
    try:
        yield grads
    finally:
        module.adam_update = saved


def dp_step(route, p, mu, nu, t, inp, dims, consts, hyper, mesh):
    """One data-parallel step of ``route`` with its Adam update, through
    the port's entry point."""
    from multivae_tpu_torch.ops import fused_sharded as fsh

    x1, x2, noise, masks = inp
    if route.kind == "mopoe":
        return fsh.dp_step_flat(p, mu, nu, t, x1, x2, noise, dims, consts,
                                hyper, True, mesh)
    return fsh.dp_method_step_flat(route.method, p, mu, nu, t, x1, x2, noise,
                                   dims, consts, hyper, True, mesh, masks)


def plain_dp_step(route, p, mu, nu, t, inp, dims, consts, hyper, n_dev):
    """The plain data-parallel step: plain slices, sums in shard order,
    the rescale and the plain Adam; returns the summed gradient."""
    from multivae_tpu_torch.ops.adam import adam_update_reference

    _, (_, g) = sharded(route, "plain", p, inp, dims, consts, n_dev)
    adam_update_reference(p, mu, nu, g, t, hyper)
    return g


def dp_epoch_check(route, p0, dims, consts, hyper, gen, device, n_dev):
    """An 8-step data-parallel epoch of one route through the port's entry
    points against the plain one.

    1. Along the kernels' own trajectory every step is recomputed by the
       plain data-parallel step from the same state and inputs: the summed
       gradients are held to the step bound, and the kernels' Adam update to
       the plain Adam on the same gradient (the Adam bound), every element.
    2. The free-running plain epoch from the same start is held by
       :func:`hold_epoch`, which accepts what parts downstream of Adam's
       trap (1. holds every step)."""
    import torch

    from multivae_tpu_torch.ops import fused_sharded as fsh
    from multivae_tpu_torch.ops.adam import (adam_update_reference,
                                             init_adam_state)
    from multivae_tpu_torch.parallel import data_mesh, spread

    name = (f"{route.dp_kernel} of {route.name} x {n_dev} shards + flat_adam "
            f"8-step epoch")
    mesh = data_mesh(n_dev, spread(device, n_dev))
    x1s, x2s, noises, masks = route.inputs(dims, gen, device, steps=8)
    steps = [(x1s[i], x2s[i], noises[i], None if masks is None else masks[i])
             for i in range(8)]
    p, q = p0.clone(), p0.clone()
    sp, sq = init_adam_state(p), init_adam_state(q)
    worst_step = worst_adam = 0.0
    with recording_adam(fsh) as ker_grads:
        for i, inp in enumerate(steps):
            before = [x.clone() for x in (p, sp.mu, sp.nu)]
            dp_step(route, p, sp.mu, sp.nu, i + 1, inp, dims, consts, hyper,
                    mesh)
            _, (_, g_plain) = sharded(route, "plain", before[0], inp, dims,
                                      consts, n_dev)
            err, bad = close(ker_grads[-1], g_plain, STEP_RTOL, STEP_ATOL)
            worst_step = max(worst_step, err)
            if bool(bad.any()):
                raise SystemExit(f"{name}: step {i}'s summed gradient "
                                 f"disagrees with the plain version from "
                                 f"the same state ({int(bad.sum())} "
                                 f"elements, max_abs_err {err:.3e})")
            adam_update_reference(*before, ker_grads[-1], i + 1, hyper)
            for k, (a, b) in enumerate(zip((p, sp.mu, sp.nu), before)):
                err, bad = close(a, b, ADAM_RTOL, ADAM_ATOL)
                if k == 0:
                    # 1 - exp(t log b2) cancels ~3 digits at small t, so
                    # the card's and the plain exp (1 ulp apart) give
                    # updates ~1e-4 apart relative to an update of ~lr
                    bad &= (a - b).abs() > 1e-4 * hyper.lr
                worst_adam = max(worst_adam, err)
                if bool(bad.any()):
                    raise SystemExit(f"{name}: step {i}'s Adam update "
                                     f"disagrees with the plain version")
    ref_grads = [plain_dp_step(route, q, sq.mu, sq.nu, i + 1, inp, dims,
                               consts, hyper, n_dev)
                 for i, inp in enumerate(steps)]
    torch.cuda.synchronize()
    log("dp-kernel", f"{name}: every step recomputed by the plain version "
        f"from the kernels' state: summed gradients max_abs_err "
        f"{worst_step:.3e}, Adam updates {worst_adam:.3e}")
    return hold_epoch("dp-kernel", name, (p, sp.mu, sp.nu),
                      (q, sq.mu, sq.nu), ker_grads, ref_grads, dims,
                      downstream_ok=True)


def dp_kernel_check(device):
    """Phase dp-kernel: the row-slice entry points of the MoPoE and method
    step kernels at B=256 over 2 and 4 shards (see the module docstring);
    returns the record entries of ``dp_step`` and ``dp_method_step``."""
    import torch

    from multivae_tpu_torch.ops import adam as adam_ops
    from multivae_tpu_torch.ops import fused_step as fs
    from multivae_tpu_torch.ops.adam import init_adam_state
    from multivae_tpu_torch.parallel import data_mesh, spread

    result = {k: {"max_abs_err": 0.0, "variants": {}}
              for k in ("dp_step", "dp_method_step")}
    consts = fs.FusedConsts(1.0, 0.7, 1.2)
    hyper = adam_ops.AdamHyper(2e-3, 0.9, 0.999)
    routes = [r for r in all_routes() if r.kind != "presence"]
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    cfg, dims, p, _, _, _ = train_setup(device, 256, SEED + 4)
    for route in routes:
        entry = result[route.dp_kernel]
        for learn_scale in (True, False):
            inp = route.inputs(dims, gen, device)
            whole = route.step("kernel", p, inp, dims, consts, learn_scale)
            # the slice that is the whole batch: the unsharded kernel's bits
            same = route.slice_step("kernel", p, inp, dims, consts,
                                    learn_scale, 0, dims.b)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(same, whole)):
                raise SystemExit(f"{route.dp_kernel} of {route.name} with "
                                 f"row_offset=0, b_total=b is not the "
                                 f"unsharded kernel bit for bit")
            for n_dev in DP_SHARDS:
                tag = (f"B={dims.b} shards={n_dev} "
                       f"learn_scale={learn_scale}")
                kers, summed = sharded(route, "kernel", p, inp, dims, consts,
                                       n_dev, learn_scale)
                refs, _ = sharded(route, "plain", p, inp, dims, consts,
                                  n_dev, learn_scale)
                local = dims._replace(b=dims.b // n_dev)
                err = max(check_step(
                    f"{route.dp_kernel} of {route.name}", ker, ref,
                    split_pairs(local), f"{tag} shard {k}", "dp-kernel",
                    quiet=True) for k, (ker, ref) in enumerate(zip(kers,
                                                                   refs)))
                err_sum = check_step(
                    f"{route.dp_kernel} of {route.name}: sum of shards vs "
                    f"the unsharded kernel", summed, whole,
                    split_pairs(dims), tag, "dp-kernel", quiet=True)
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                log("dp-kernel", f"{route.dp_kernel} of {route.name} {tag}: "
                    f"every shard vs its plain version max_abs_err "
                    f"{err:.3e}, sum of shards vs the unsharded kernel "
                    f"{err_sum:.3e} (loss {float(summed[0][0]):.6f} vs "
                    f"{float(whole[0][0]):.6f}), row_offset=0 b_total=b "
                    f"equal bits ok")

    # 8-step data-parallel epochs: jsd's three partitions at 2 and 4 shards
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    for route in routes:
        for n_dev in (DP_SHARDS if route.method == "jsd" else (4,)):
            err = dp_epoch_check(route, p, dims, consts, hyper, gen, device,
                                 n_dev)
            entry = result[route.dp_kernel]
            entry["epoch_err"] = max(entry.get("epoch_err", 0.0), err)

    # ---- timing, in turns: plain, kernel, kernel, plain
    def time_pair(ker_fn, ref_fn, iters=30):
        t = [cuda_ms(ref_fn, iters), cuda_ms(ker_fn, iters),
             cuda_ms(ker_fn, iters), cuda_ms(ref_fn, iters)]
        return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t

    n_dev = 4
    local = dims._replace(b=dims.b // n_dev)
    mesh = data_mesh(n_dev, spread(device, n_dev))
    for route in routes:
        if route.name not in DP_TIMED:
            continue
        inp = route.inputs(dims, gen, device)
        sl = shard_inputs(inp, slice(local.b, 2 * local.b))
        ker_ms, plain_ms, t = time_pair(
            lambda: route.slice_step("kernel", p, sl, local, consts, True,
                                     local.b, dims.b),
            lambda: route.slice_step("plain", p, sl, local, consts, True,
                                     local.b, dims.b))
        variant = f"{route.dp_kernel} of {route.name}, rows 64-127 of 256"
        entry = dict(ms=ker_ms, plain_ms=plain_ms, library_ms=None,
                     **route.bound(p, sl, local))
        result[route.dp_kernel]["variants"][variant] = entry
        result[route.dp_kernel].update(entry, timed_variant=variant)
        log("dp-kernel", f"{variant}: kernel {t[1]:.4f}/{t[2]:.4f} ms, plain "
            f"{t[0]:.4f}/{t[3]:.4f} ms per slice step; bound "
            f"{entry['bound_ms']:.5f} ms by {entry['bound_by']}; "
            f"{100 * entry['bound_ms'] / ker_ms:.2f} % of the bound's rate")
        # one whole step: 4 slices, the sums, the rescale, one Adam update
        q, r = p.clone(), p.clone()
        sq, sr = init_adam_state(q), init_adam_state(r)
        ker_ms, plain_ms, t = time_pair(
            lambda: dp_step(route, q, sq.mu, sq.nu, 1, inp, dims, consts,
                            hyper, mesh),
            lambda: plain_dp_step(route, r, sr.mu, sr.nu, 1, inp, dims,
                                  consts, hyper, n_dev), iters=20)
        # state read and written once, the batch, noise and masks read once
        moved = 2 * nbytes(q, sq.mu, sq.nu) + nbytes(*inp) + 4 * 19
        whole = dict(ms=ker_ms, plain_ms=plain_ms, library_ms=None, **bound(
            moved, step_flops(dims.b, route.enc_passes, route.dec_passes)
            + 12.0 * q.numel()))
        variant = (f"{route.dp_kernel} of {route.name} x {n_dev} shards + "
                   f"sums + flat_adam, B=256")
        result[route.dp_kernel]["variants"][variant] = whole
        log("dp-kernel", f"{variant}: kernels {t[1]:.4f}/{t[2]:.4f} ms, "
            f"plain {t[0]:.4f}/{t[3]:.4f} ms per step; bound "
            f"{whole['bound_ms']:.5f} ms by {whole['bound_by']}")
    return result


# ------------------------------------------------- the layer-stack step
# architectures outside the split layout, at the flagship widths:
# (encoder hidden layers, decoder hidden layers, per-sample output scale)
DEEP_A = dict(num_hidden_layer_encoder=1, num_hidden_layer_decoder=1,
              learn_output_sample_scale=True)
DEEP_B = dict(num_hidden_layer_encoder=2, num_hidden_layer_decoder=1,
              learn_output_sample_scale=False)
# a depth no slice has, and a deep encoder before a linear decoder
DEEP_C = dict(num_hidden_layer_encoder=3, num_hidden_layer_decoder=2,
              learn_output_sample_scale=False)
DEEP_D = dict(num_hidden_layer_encoder=2, num_hidden_layer_decoder=0,
              learn_output_sample_scale=True)
DEEP_ARCHS = {"deep-A": DEEP_A, "deep-B": DEEP_B, "3+2": DEEP_C,
              "2+0 per-sample": DEEP_D}
GENERIC_ROWS = (256, 137)
# the other likelihoods and the unfactorized latent take the layer-stack
# step at the flagship architecture (1 + 0, per-feature scale) too
FLAT_ARCH = dict(num_hidden_layer_encoder=1, num_hidden_layer_decoder=0,
                 learn_output_sample_scale=False)
ALL_ARCHS = {**DEEP_ARCHS, "1+0": FLAT_ARCH}
VARIANTS = {"laplace": dict(likelihood="laplace"),
            "bernoulli": dict(likelihood="bernoulli"),
            "categorical": dict(likelihood="categorical"),
            "unfactorized": dict(factorized_representation=False)}
VARIANT_ARCHS = ("1+0", "deep-A")


def generic_flops(dims, enc_passes: int, dec_passes: int) -> float:
    """Matmul FLOPs one layer-stack step needs: per row and pass, 4 per
    multiply-add of an encoder's first layer (forward and weight gradient:
    nothing takes the gradient of the data) and 6 per multiply-add of every
    other product (forward, weight gradient, the gradient of its input)."""
    per_row = 0
    for e, (d, s) in enumerate(((dims.d1, dims.s1), (dims.d2, dims.s2))):
        enc = 4 * d * dims.h + 6 * dims.h * dims.h * (dims.n_enc - 1) \
            + 6 * dims.h * (2 * dims.cd + 2 * s)
        n_out = 2 * d if dims.sample_scale else d
        widths = [s + dims.cd] + [dims.h] * dims.n_dec + [n_out]
        dec = 6 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
        per_row += enc_passes * enc + dec_passes * dec
    return float(per_row * dims.b)


# a float32 sum's rounding (~6e-8 of the sum of its terms' sizes, and as
# much again from the layer below) with a margin of ten
ROUNDING = 1e-6


def rounding_level_units(method, p, inp, dims, consts):
    """Hidden units of the layer stacks that may take either ReLU branch at
    the rounding level: in some row the unit's input, computed by the plain
    version in float64, is within ``ROUNDING`` of zero relative to the sum
    of its terms' sizes, so two float32 sums in different orders can land
    on different sides. Returns the mask of the gradient elements behind
    such units (the unit's own input weights and bias, every layer below it
    in its network and, below a decoder, the encoders) and their
    description."""
    import torch

    from multivae_tpu_torch.ops import fused_generic as fg
    from multivae_tpu_torch.ops.fused_methods import latent_fwd_bwd
    from multivae_tpu_torch.params import flat_views

    x1, x2, noise, masks = (None if t is None else t.double() for t in inp)
    found = []

    class Recording(fg.StackNets):
        def _stack(self, net, depth, h, mask_of):
            below = h
            for i in range(depth):
                w = self.sp[f"{net}/hidden_{i}/kernel"]
                b = self.sp[f"{net}/hidden_{i}/bias"]
                pre = below @ w + b
                size = below.abs() @ w.abs() + b.abs()
                near = (pre.abs() <= ROUNDING * size).any(0)
                if bool(near.any()):
                    found.append((net, i, torch.nonzero(near).flatten()))
                below = torch.relu(pre)
                if mask_of(i) is not None:
                    below = below * mask_of(i)
            return super()._stack(net, depth, h, mask_of)

        def decode(self, e, p, zs, zc):
            # laplace: |r| has a kink at 0, so a residual within rounding
            # of 0 may take either sign of its gradient
            nll, cache = super().decode(e, p, zs, zc)
            if self.dims.likelihood == "laplace":
                net, x = f"dec{e + 1}", self.xs[e]
                d, h = x.shape[1], cache[1]
                out = "out_heads" if self.dims.sample_scale else "out_mu"
                w = self.sp[f"{net}/{out}/kernel"][:, :d]
                b = self.sp[f"{net}/{out}/bias"][:d]
                r = x - (h @ w + b)
                size = x.abs() + h.abs() @ w.abs() + b.abs()
                near = (r.abs() <= ROUNDING * size).any(0)
                if bool(near.any()):
                    ties.append((net, out, torch.nonzero(near).flatten()))
            return nll, cache

    ties = []
    nets = Recording(flat_views(p.double(), dims), (x1, x2), dims, True,
                     masks)
    latent_fwd_bwd(method, nets, noise, dims.b, dims.cd, dims.s1, dims.s2,
                   consts)
    mask = torch.zeros_like(p, dtype=torch.bool)
    views = flat_views(mask, dims)

    def layer_of(name):
        return int(name.split("/")[1].split("_")[1])

    for net, i, units in found:
        views[f"{net}/hidden_{i}/kernel"][:, units] = True
        views[f"{net}/hidden_{i}/bias"][units] = True
        for name, v in views.items():
            if (name.startswith(net + "/hidden_") and layer_of(name) < i) or (
                    net.startswith("dec") and name.startswith("enc")):
                v[...] = True
    for net, out, cols in ties:
        # the output columns, the decoder's hidden layers and the encoders
        # (through the latents' gradients)
        views[f"{net}/{out}/kernel"][:, cols] = True
        views[f"{net}/{out}/bias"][cols] = True
        for name, v in views.items():
            if name.startswith(net + "/hidden_") or name.startswith("enc"):
                v[...] = True
    text = ("hidden units within " + str(ROUNDING) + " of a ReLU's edge: "
            + ", ".join(f"{net} layer {i} units {u.tolist()}"
                        for net, i, u in found))
    if ties:
        text += ("; laplace residuals within " + str(ROUNDING) + " of 0: "
                 + ", ".join(f"{net} columns {c.tolist()}"
                             for net, _, c in ties))
    return mask, text


class GenericRoute:
    """The layer-stack step of one architecture and method: its kernel, its
    plain version, and the noise and masks it takes."""

    kernel = "generic_step"

    def __init__(self, arch: str, method="joint_elbo", masked=False,
                 variant=None):
        self.arch, self.method, self.masked = arch, method, masked
        self.variant = variant
        self.cfg_kw = {**ALL_ARCHS[arch], **VARIANTS.get(variant, {})}
        self.likelihood = self.cfg_kw.get("likelihood", "normal")
        self.name = (f"generic_step[{arch}, "
                     + (f"{variant}, " if variant else "") + method
                     + (", masks" if masked else "") + "]")
        poe = method == "poe"
        self.dec_passes = 2 if poe else 1
        self.enc_passes = 2 if poe and masked else 1

    def setup(self, device, b: int, seed: int):
        """Seeded params (flat, the general layout) and the dims."""
        from multivae_tpu_torch.models import build_model, make_modalities
        from multivae_tpu_torch.params import dims_from, model_flat_params

        cfg = flagship_cfg(self.method, seed=seed, **self.cfg_kw)
        model = build_model(cfg, make_modalities(
            cfg.input_dim, cfg.style_dim, cfg.likelihood), device, seed=seed)
        dims = dims_from(cfg, b)
        return dims, model_flat_params(model, dims)

    def inputs(self, dims, gen, device, steps=None):
        import torch

        from multivae_tpu_torch.ops import fused_generic as fg

        lead = () if steps is None else (steps,)
        b = dims.b

        def randn(*shape):
            return torch.randn(lead + shape, generator=gen, device=device)

        w = dims.cd + dims.s1 + dims.s2
        if self.method == "poe":
            w += 2 * dims.cd + dims.s1 + dims.s2
        x1, x2, noise = randn(b, dims.d1), randn(b, dims.d2), randn(b, w)
        if self.likelihood == "bernoulli":  # the cohort thresholded at 0
            x1, x2 = (x1 > 0).float(), (x2 > 0).float()
        elif self.likelihood == "categorical":  # one-hot rows
            x1, x2 = (torch.nn.functional.one_hot(torch.randint(
                0, d, lead + (b,), generator=gen, device=device), d).float()
                for d in (dims.d1, dims.d2))
        masks = None
        if self.masked:
            n = fg.n_dropout_masks(self.method, MASK_RATE, dims.n_enc,
                                   dims.n_dec)
            keep = torch.rand(lead + (n, b, dims.h), generator=gen,
                              device=device) < 1 - MASK_RATE
            masks = keep.float() / (1 - MASK_RATE)
        return x1, x2, noise, masks

    def step(self, version, p, inp, dims, consts, learn_scale=True):
        from multivae_tpu_torch.ops import fused_generic as fg
        from multivae_tpu_torch.params import flat_views, flatten_named

        x1, x2, noise, masks = inp
        if version == "kernel":
            return fg.generic_step_flat(self.method, p, x1, x2, noise, dims,
                                        consts, learn_scale, masks)
        _, m, g = fg.generic_fwd_bwd_reference(
            self.method, flat_views(p, dims), x1, x2, noise, dims, consts,
            learn_scale, masks)
        return m, flatten_named(g, dims)

    def launch_epoch(self, p, mu, nu, count, stacks, dims, consts, hyper,
                     phase_times=None):
        """A group of steps with their Adam updates in ONE launch of the
        persistent kernel, as :meth:`Route.launch_epoch`."""
        from multivae_tpu_torch.ops import fused_generic as fg

        x1s, x2s, noises, masks = stacks
        return fg.generic_epoch_flat(self.method, p, mu, nu, count, x1s, x2s,
                                     noises, dims, consts, hyper, True, masks,
                                     None, phase_times)

    def phases(self, dims):
        from multivae_tpu_torch.ops import fused_generic as fg

        return fg.phases(dims)

    def geometry(self, dims, device):
        from multivae_tpu_torch.ops import fused_generic as fg

        return fg.launch_geometry(dims, device, self.method, self.masked)

    def bound(self, p, inp, dims) -> dict:
        """Params, batch, noise and masks read once, every gradient and the
        metrics written once; the operations of its passes (categorical's
        row pass: ~10 per output element and decode)."""
        moved = 2 * nbytes(p) + nbytes(*inp) + 4 * 19
        flops = generic_flops(dims, self.enc_passes, self.dec_passes)
        if self.likelihood == "categorical":
            flops += 10.0 * dims.b * (dims.d1 + dims.d2) * self.dec_passes
        return bound(moved, flops)


def generic_kernel_check(device):
    """Phase generic-kernel: the layer-stack step against its plain version
    at the flagship widths, for four architectures (the two slices', a 3+2
    stack and a deep encoder before a linear decoder), the four methods,
    masks on and off, learned scale on and off, B=256 and 137; 8-step
    epochs; times in turns plain, kernel, kernel, plain beside the bound.
    Returns the record entry of ``generic_step``."""
    import torch

    from multivae_tpu_torch.ops import adam as adam_ops
    from multivae_tpu_torch.ops import fused_generic as fg
    from multivae_tpu_torch.ops import fused_step as fs

    entry = {"max_abs_err": 0.0, "variants": {}}
    consts = fs.FusedConsts(1.0, 0.7, 1.2)
    hyper = adam_ops.AdamHyper(2e-3, 0.9, 0.999)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    n_cases = 0
    for arch in DEEP_ARCHS:
        for method in fg.PORTED_METHODS:
            for masked in (False, True):
                route = GenericRoute(arch, method, masked)
                worst = 0.0
                for b in GENERIC_ROWS:
                    dims, p = route.setup(device, b, SEED + b)
                    for learn_scale in (True, False):
                        inp = route.inputs(dims, gen, device)
                        worst = max(worst, check_step(
                            route.name,
                            route.step("kernel", p, inp, dims, consts,
                                       learn_scale),
                            route.step("plain", p, inp, dims, consts,
                                       learn_scale),
                            split_pairs(dims),
                            f"B={b} learn_scale={learn_scale}",
                            "generic-kernel", quiet=True,
                            excuse=lambda: rounding_level_units(
                                route.method, p, inp, dims, consts)))
                        n_cases += 1
                entry["max_abs_err"] = max(entry["max_abs_err"], worst)
                log("generic-kernel", f"{route.name} B={list(GENERIC_ROWS)} "
                    f"learn_scale on/off: metrics+grads max_abs_err "
                    f"{worst:.3e} ok")
    log("generic-kernel", f"{n_cases} steps held to the plain version (loss "
        f"rtol {LOSS_RTOL}; metrics and grads rtol {STEP_RTOL} / atol "
        f"{STEP_ATOL})")

    # a group of steps in one launch is its steps one by one, bit for bit,
    # for every architecture x method x masks
    launch_gen = torch.Generator(device=device).manual_seed(SEED + 10)
    geo = {}
    for arch in DEEP_ARCHS:
        for method in fg.PORTED_METHODS:
            for masked in (False, True):
                route = GenericRoute(arch, method, masked)
                dims, p0 = route.setup(device, 256, SEED)
                launch_vs_steps(route, p0, dims, consts, hyper, launch_gen,
                                device, phase="generic-kernel")
                if method == "poe" and masked or method == "joint_elbo" \
                        and not masked:
                    geo[route.name] = route.geometry(dims, device)
    log("generic-kernel", "persistent kernel at B=256, cooperative grid "
        "blocks, phases and grid barriers per step (with Adam / one step "
        "without): " + "; ".join(
            f"{k} {v['grid_blocks']} blocks, {v['phases']} phases, "
            f"{v['barriers_per_step_adam']} / {v['barriers_per_step']} "
            f"barriers" for k, v in geo.items()))
    entry["geometry"] = geo["generic_step[deep-A, joint_elbo]"]

    # 8-step epochs. Along the kernels' own trajectory every step is
    # recomputed by the plain version from the same state (the step bound),
    # then the free-running plain epoch is held by hold_epoch, which accepts
    # what parts downstream of Adam's trap or of a rounding-level ReLU
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    epochs = ([GenericRoute("deep-A", m) for m in ("joint_elbo", "poe")]
              + [GenericRoute("deep-B", m, True) for m in fg.PORTED_METHODS]
              + [GenericRoute("3+2", "jsd")])
    for route in epochs:
        dims, p0 = route.setup(device, 256, SEED)
        x1s, x2s, noises, masks = route.inputs(dims, gen, device, steps=8)
        steps = [(x1s[i], x2s[i], noises[i],
                  None if masks is None else masks[i]) for i in range(8)]
        name = f"{route.name} + flat_adam 8-step epoch"
        p, q = p0.clone(), p0.clone()
        sp, sq = adam_ops.init_adam_state(p), adam_ops.init_adam_state(q)
        ker_grads, ref_grads = [], []
        branch = torch.zeros_like(p, dtype=torch.bool)
        worst = 0.0
        for i, inp in enumerate(steps):
            ker = route.step("kernel", p, inp, dims, consts)

            def excuse(inp=inp):
                mask, text = rounding_level_units(route.method, p, inp,
                                                  dims, consts)
                branch.logical_or_(mask)
                return mask, text

            worst = max(worst, check_step(
                name, ker, route.step("plain", p, inp, dims, consts),
                split_pairs(dims), f"step {i} from the kernels' state",
                "generic-kernel", quiet=True, excuse=excuse))
            adam_ops.adam_update(p, sp.mu, sp.nu, ker[1], i + 1, hyper)
            ker_grads.append(ker[1])
            _, g = route.step("plain", q, inp, dims, consts)
            adam_ops.adam_update_reference(q, sq.mu, sq.nu, g, i + 1, hyper)
            ref_grads.append(g)
        torch.cuda.synchronize()
        log("generic-kernel", f"{name}: every step recomputed by the plain "
            f"version from the kernels' state: metrics+grads max_abs_err "
            f"{worst:.3e}")
        err = hold_epoch("generic-kernel", name, (p, sp.mu, sp.nu),
                         (q, sq.mu, sq.nu), ker_grads, ref_grads, dims,
                         branch=branch, downstream_ok=True)
        entry["epoch_err"] = max(entry.get("epoch_err", 0.0), err)

    # ---- timing, in turns: plain, kernel, kernel, plain
    headline = "generic_step[deep-A, joint_elbo]"
    for route in (GenericRoute("deep-A", "joint_elbo"),
                  GenericRoute("deep-B", "poe", True)):
        dims, p = route.setup(device, 256, SEED)
        inp = route.inputs(dims, gen, device)
        ker = lambda: route.step("kernel", p, inp, dims, consts)
        ref = lambda: route.step("plain", p, inp, dims, consts)
        t = [cuda_ms(ref, 30), cuda_ms(ker, 30), cuda_ms(ker, 30),
             cuda_ms(ref, 30)]
        timed = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
                     library_ms=None, **route.bound(p, inp, dims))
        timed.update(time_launch(route, p, dims, consts, hyper, gen, device,
                                 "generic-kernel"))
        entry["variants"][route.name] = timed
        if route.name == headline:
            entry.update(timed, timed_variant=route.name)
        fl = generic_flops(dims, route.enc_passes, route.dec_passes)
        log("generic-kernel", f"{route.name} B=256: kernel {t[1]:.4f}/"
            f"{t[2]:.4f} ms, plain {t[0]:.4f}/{t[3]:.4f} ms per one-step "
            f"launch; bound {timed['bound_ms']:.5f} ms by {timed['bound_by']} "
            f"({fl / 1e6:.1f} MFLOP, {p.numel()} params); kernel "
            f"{fl / (timed['ms'] * 1e-3) / 1e12:.3f} TFLOP/s = "
            f"{100 * timed['bound_ms'] / timed['ms']:.2f} % of the bound's "
            f"rate")
    variant_kernel_check(device, entry, consts, hyper)
    return entry


def variant_kernel_check(device, entry, consts, hyper):
    """The layer-stack step's other likelihoods (laplace, bernoulli on the
    cohort thresholded at 0, categorical on one-hot rows) and the
    unfactorized latent at the flagship widths, B=256, architectures 1 + 0
    (per-feature scale) and deep-A, the four methods: each step held to the
    plain version with and without a learned scale (the train-kernel
    bounds), ONE launch of 8 steps with Adam against 8 one-step launches
    and ``flat_adam`` (equal bits, two runs equal), laplace ties at the
    kernel, and per variant a 6-step launch timed with its phases beside
    the one-step times and the bound. Adds to ``entry``."""
    import torch

    from multivae_tpu_torch.ops import fused_generic as fg
    from multivae_tpu_torch.params import flat_views

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    launch_gen = torch.Generator(device=device).manual_seed(SEED + 12)
    n_cases, geo = 0, {}
    for variant in VARIANTS:
        for arch in VARIANT_ARCHS:
            for method in fg.PORTED_METHODS:
                route = GenericRoute(arch, method, variant=variant)
                dims, p = route.setup(device, 256, SEED + 3)
                worst = 0.0
                for learn_scale in (True, False):
                    inp = route.inputs(dims, gen, device)
                    worst = max(worst, check_step(
                        route.name,
                        route.step("kernel", p, inp, dims, consts,
                                   learn_scale),
                        route.step("plain", p, inp, dims, consts,
                                   learn_scale),
                        split_pairs(dims), f"B=256 learn_scale={learn_scale}",
                        "generic-kernel", quiet=True,
                        excuse=lambda: rounding_level_units(
                            route.method, p, inp, dims, consts)))
                    n_cases += 1
                entry["max_abs_err"] = max(entry["max_abs_err"], worst)
                launch_vs_steps(route, p, dims, consts, hyper, launch_gen,
                                device, phase="generic-kernel")
                if method == "joint_elbo":
                    geo[route.name] = route.geometry(dims, device)
                log("generic-kernel", f"{route.name} B=256 learn_scale "
                    f"on/off: metrics+grads max_abs_err {worst:.3e} ok")
    log("generic-kernel", f"{n_cases} steps of the likelihood and "
        f"unfactorized routes held to the plain version (loss rtol "
        f"{LOSS_RTOL}; metrics and grads rtol {STEP_RTOL} / atol "
        f"{STEP_ATOL})")
    log("generic-kernel", "B=256, cooperative grid blocks, phases and grid "
        "barriers per step (with Adam / one step without): " + "; ".join(
            f"{k} {v['grid_blocks']} blocks, {v['phases']} phases, "
            f"{v['barriers_per_step_adam']} / {v['barriers_per_step']} "
            f"barriers" for k, v in geo.items()))

    # laplace ties: ROI output column 0 is 0 (zero weights and bias) and so
    # is the data's: x - loc is +0.0 in every row, whose d|r|/dr is +1 (the
    # JAX convention), so that column's bias gradient is -exp(-olv / 2)
    route = GenericRoute("1+0", "joint_elbo", variant="laplace")
    dims, p = route.setup(device, 256, SEED + 4)
    views = flat_views(p, dims)
    views["dec2/out_mu/kernel"][:, 0] = 0.0
    views["dec2/out_mu/bias"][0] = 0.0
    x1, x2, noise, masks = route.inputs(dims, gen, device)
    x2[:, 0] = 0.0
    inp = (x1, x2, noise, masks)
    ker = route.step("kernel", p, inp, dims, consts)
    check_step(route.name + " tied column", ker,
               route.step("plain", p, inp, dims, consts), split_pairs(dims),
               "B=256", "generic-kernel", quiet=True)
    got = float(flat_views(ker[1], dims)["dec2/out_mu/bias"][0])
    want = -float(torch.exp(-0.5 * views["dec2/out_logvar"][0, 0]))
    ok = abs(got - want) <= 1e-5 * abs(want)
    log("generic-kernel", f"{route.name}: every row tied in ROI column 0: "
        f"its bias gradient {got:.7f}, -exp(-olv / 2) = {want:.7f} "
        f"(d|r|/dr = +1 at r = 0) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit("laplace ties: the kernel's sign at r = 0 is not "
                         "the JAX convention")

    # timing, in turns: plain, kernel, kernel, plain; a 6-step launch
    for variant in VARIANTS:
        for arch in VARIANT_ARCHS:
            route = GenericRoute(arch, "joint_elbo", variant=variant)
            dims, p = route.setup(device, 256, SEED)
            inp = route.inputs(dims, gen, device)
            ker = lambda: route.step("kernel", p, inp, dims, consts)
            ref = lambda: route.step("plain", p, inp, dims, consts)
            t = [cuda_ms(ref, 30), cuda_ms(ker, 30), cuda_ms(ker, 30),
                 cuda_ms(ref, 30)]
            timed = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
                         library_ms=None, **route.bound(p, inp, dims))
            timed.update(time_launch(route, p, dims, consts, hyper, gen,
                                     device, "generic-kernel"))
            entry["variants"][route.name] = timed
            log("generic-kernel", f"{route.name} B=256: kernel "
                f"{t[1]:.4f}/{t[2]:.4f} ms, plain {t[0]:.4f}/{t[3]:.4f} ms "
                f"per one-step launch; bound {timed['bound_ms']:.5f} ms by "
                f"{timed['bound_by']} ({p.numel()} params)")


def numpy_cohort(rng, cfg, n_train: int, n_test: int):
    """A cohort built with numpy alone: a shared low-rank factor drives a
    clinical block and a ROI block, each standardized."""
    from multivae_tpu_torch.analysis.daa import DaaCohort

    d1, d2 = cfg.input_dim
    n = n_train + n_test
    z = rng.normal(size=(n, 4))
    clinical = z @ rng.normal(size=(4, d1)) + 0.3 * rng.normal(size=(n, d1))
    rois = (z @ rng.normal(size=(4, d2)) * 0.5 + clinical[:, :3]
            @ rng.normal(size=(3, d2)) + 0.3 * rng.normal(size=(n, d2)))

    def standardize(x):
        return ((x - x.mean(0)) / x.std(0)).astype(np.float32)

    clinical, rois = standardize(clinical), standardize(rois)
    metrics = ("thickness", "area", "meancurv")
    meta = np.array([[f"sub-{i:05d}", f"site{'ABC'[i % 3]}"]
                     for i in range(n_train, n)], dtype=object)
    return DaaCohort(
        clinical_names=np.array([f"score_{i}" for i in range(d1)],
                                dtype=object),
        rois_names=np.array([f"roi{i // 3:03d}_{metrics[i % 3]}"
                             for i in range(d2)], dtype=object),
        train_clinical=clinical[:n_train],
        test_data={"clinical": clinical[n_train:], "rois": rois[n_train:]},
        metadata_columns=["participant_id", "site"],
        test_metadata=meta)


def write_run(root: str, cfg) -> str:
    """A seeded-init flagship model written as a port run dir."""
    from multivae_tpu_torch.models import build_model, make_modalities
    from multivae_tpu_torch.train.checkpoint import save_checkpoint

    run = "synthetic_smoke"
    rundir = os.path.join(root, run)
    os.makedirs(rundir)
    cfg.save(os.path.join(rundir, "flags.json"))
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu")
    save_checkpoint(os.path.join(rundir, "checkpoints", "0000"), model)
    return run


def slice_run(device, card: str):
    """Phase slice: the DAA path end to end; returns the kernel launches."""
    import torch

    from multivae_tpu_torch.analysis import daa
    from multivae_tpu_torch.ops import fused_daa
    from multivae_tpu_torch.train.experiment import load_run

    cfg = flagship_cfg(seed=SEED)
    n_val = 2
    with tempfile.TemporaryDirectory() as root:
        run = write_run(root, cfg)
        experiment, cfg = load_run(root, run, device)
        cohort = numpy_cohort(np.random.default_rng(SEED), cfg, 320, 80)
        daadir = os.path.join(root, run, "daa")
        kw = dict(sampling_strategy="likelihood", n_validation=n_val,
                  n_samples=N_SAMPLES, n_subjects=B, M=1000, seed=SEED,
                  sample_latents=True, artifact="full",
                  fetch_dtype="float16")
        fused_daa.KERNEL_LAUNCHES["avatar_sweep"] = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        resdir = daa.run_daa(cfg, experiment.models, [cohort], daadir, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = fused_daa.KERNEL_LAUNCHES["avatar_sweep"]
        if launches < 1:
            raise SystemExit("the DAA path never launched the kernel")

        n_scores, n_rois = cfg.input_dim
        pvalues = np.load(os.path.join(resdir, "pvalues.npy"))
        coefs = np.load(os.path.join(resdir, "coefs.npy"))
        avatars = np.load(os.path.join(resdir, "rois_digital_avatars.npy"),
                          mmap_mode="r")
        checks = {
            "pvalues shape": pvalues.shape == (n_val, n_scores, n_rois),
            "pvalues in [0, 1]": bool(np.isfinite(pvalues).all()
                                      and (pvalues >= 0).all()
                                      and (pvalues <= 1).all()),
            "coefs finite": bool(np.isfinite(coefs).all()),
            "avatars shape": avatars.shape == (n_val, B, n_scores,
                                               N_SAMPLES, n_rois),
            "avatars finite": bool(np.isfinite(avatars).all()),
            "significant_rois.tsv": os.path.isfile(
                os.path.join(resdir, "significant_rois.tsv")),
        }
        log("slice", f"run_daa: {n_val} rounds in {wall:.3f} s wall, "
            f"{launches} kernel launches, checks "
            + ", ".join(f"{k}={v}" for k, v in checks.items()))
        if not all(checks.values()):
            raise SystemExit(f"slice outputs wrong: {checks}")

        # the sweep of one round alone, and its device->host copy
        model = experiment.models[0]
        rng = np.random.default_rng(SEED)
        sel = rng.choice(len(cohort.test_metadata), size=B, replace=False)
        data = {k: torch.as_tensor(v[sel], device=device)
                for k, v in cohort.test_data.items()}
        gen = torch.Generator(device=device).manual_seed(SEED)
        loc, scale, _ = daa.analytic_reconstruction_stats(model, data)
        scores = loc[None] + scale[None] * torch.randn(
            (N_SAMPLES,) + tuple(loc.shape), generator=gen, device=device)
        sweep_ms = cuda_ms(lambda: daa.avatar_sweep(
            model, data, scores, True, gen, cfg), iters=10)
        avatars_dev = daa.avatar_sweep(model, data, scores, True, gen, cfg)
        torch.cuda.synchronize()
        start = time.perf_counter()
        avatars_dev.to(torch.float16).cpu()
        fetch_ms = 1e3 * (time.perf_counter() - start)
        # the regression + vote stage alone, re-run on the saved artifacts
        start = time.perf_counter()
        daa.compute_significativity(
            resdir, cfg, cohort.clinical_names, cohort.rois_names,
            daa.params_namespace(n_val, B, kw["M"], N_SAMPLES,
                                 "hierarchical", kw["sampling_strategy"],
                                 True, SEED),
            cohort.metadata_columns, 0.75, 1.0, "hierarchical")
        regress_s = time.perf_counter() - start
        n_avatars = B * n_scores * N_SAMPLES
        log("slice", f"sweep per round {sweep_ms:.4f} ms = "
            f"{n_avatars / sweep_ms * 1e3:.4e} avatars/s on the card; "
            f"float16 device->host copy {fetch_ms:.2f} ms; regression + "
            f"vote stage {regress_s / n_val:.3f} s/round; run_daa wall "
            f"{wall / n_val:.3f} s/round = "
            f"{n_avatars * n_val / wall:.4e} avatars/s ({card})")

        # small deterministic run: kernel on the card vs plain on the CPU
        small = dict(sampling_strategy="linear", n_validation=2,
                     n_samples=20, n_subjects=B, M=8, seed=SEED,
                     sample_latents=False, artifact="full",
                     fetch_dtype="float32")
        res_gpu = daa.run_daa(cfg, experiment.models, [cohort],
                              os.path.join(root, "gpu"), **small)
        cpu_exp, _ = load_run(root, run, "cpu")
        res_cpu = daa.run_daa(cfg, cpu_exp.models, [cohort],
                              os.path.join(root, "cpu"), **small)

        def load(resdir, name):
            return np.load(os.path.join(resdir, name))

        av_err = float(np.abs(load(res_gpu, "rois_digital_avatars.npy")
                              - load(res_cpu, "rois_digital_avatars.npy")
                              ).max())
        lp = [-np.log10(np.maximum(load(r, "pvalues.npy"), 1e-300))
              for r in (res_gpu, res_cpu)]
        lp_err = float(np.abs(lp[0] - lp[1]).max())

        def tsv(resdir):
            with open(os.path.join(resdir, "significant_rois.tsv")) as fh:
                return fh.read()

        same_tsv = tsv(res_gpu) == tsv(res_cpu)
        log("slice", f"small deterministic DAA, card vs CPU plain: avatars "
            f"max_abs_err={av_err:.3e}, -log10 p max_abs_err={lp_err:.3e}, "
            f"significant_rois.tsv identical={same_tsv} "
            f"({tsv(res_gpu).count(chr(10)) - 1} rows)")
        if not (av_err <= ATOL * 10 and lp_err <= 1e-2 and same_tsv):
            raise SystemExit("the DAA run on the card disagrees with the "
                             "plain version on the CPU")
    return launches, sweep_ms


# ------------------------------------------------------------- train slice
SLICE_SUBJECTS, SLICE_EPOCHS = 2100, 5
# the other methods' slices: (method, dropout_rate), 3 epochs each
METHOD_SLICES = (("moe", 0.0), ("jsd", 0.0), ("poe", 0.0), ("poe", 0.2))
METHOD_SLICE_EPOCHS = 3
SLICE_TRAIN = dict(input_dims=[7, 444], latent_dim=20, style_dim=[3, 20],
                   batch_size=256, fused_training=True,
                   use_tensorboard=False)


def epoch_batch_counts(datadir: str):
    """``(complete, clinical-only)`` batch sizes of one training epoch of
    the cohort, from the port's data layer and sampler."""
    from multivae_tpu_torch.data import MissingModalitySampler
    from multivae_tpu_torch.train.experiment import MultimodalExperiment

    cfg = flagship_cfg(dataset="synthetic", datasetdir=datadir,
                       batch_size=256)
    exp = MultimodalExperiment(cfg, "cpu")
    exp.set_datasets()
    ds = exp.dataset_train
    start = time.perf_counter()
    complete, clinical = [], []
    for idxs in MissingModalitySampler(ds, batch_size=256, seed=cfg.seed):
        data, _, _ = ds.gather(idxs)
        (complete if len(data) == 2 else clinical).append(len(idxs))
    return sorted(complete), sorted(clinical), time.perf_counter() - start


class _Tee(io.StringIO):
    def write(self, text):
        sys.__stdout__.write(text)
        return super().write(text)


def train_run(datadir, outdir, epochs, device, **kw):
    """``train_exp`` of the slice (``kw``: method, dropout_rate); returns
    the run and the train wall of each epoch that it prints."""
    from multivae_tpu_torch import workflows

    out = _Tee()
    with contextlib.redirect_stdout(out):
        run = workflows.train_exp("synthetic", datadir, outdir,
                                  num_epochs=epochs, device=device,
                                  **SLICE_TRAIN, **kw)
    line = [ln for ln in out.getvalue().splitlines()
            if "train wall per epoch (s):" in ln][-1]
    return run, [float(w) for w in line.split(":", 1)[1].split()]


def profile_epoch(datadir, run_dir, device):
    """Device busy time of one training epoch (``torch.profiler``), its
    host wall, and the kernels' device time by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multivae_tpu_torch.train import trainer
    from multivae_tpu_torch.train.config import Config
    from multivae_tpu_torch.train.experiment import MultimodalExperiment

    cfg = Config.load(os.path.join(run_dir, "flags.json"))
    cfg.datasetdir = datadir
    exp = MultimodalExperiment(cfg, device)
    exp.set_datasets()
    exp.set_optimizers()
    dp_epoch = trainer.make_dp_epoch(cfg, exp.models[0], exp.device)
    trainer.train_one_epoch(exp, 0, None, trainer.epoch_generator(cfg, 0, 0),
                            dp_epoch=dp_epoch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        trainer.train_one_epoch(exp, 0, None,
                                trainer.epoch_generator(cfg, 0, 1), 1,
                                dp_epoch=dp_epoch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    by_name = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            by_name[ev.key] = t / 1e3  # ms
    return wall, by_name


def cpu(x):
    return x.detach().cpu().clone() if hasattr(x, "detach") else x


@contextlib.contextmanager
def recording_train_loop():
    """Record every step and Adam update of the train loop on the host:
    each step's inputs, its (metrics, grads), and each update's state
    before and after. A data-parallel step is recorded as one step of its
    whole batch: the unsharded step's inputs, the rescaled metrics and the
    summed gradient. On the card a group of MoPoE, method or presence steps
    is one launch with Adam inside: the state before it is kept, the launch runs,
    and the group is replayed from the kept state with one-step launches
    and ``flat_adam``, which are recorded step by step; the replay must end
    in the launch's state, bit for bit. The replay's launches are taken out
    of the launch and step counts."""
    from multivae_tpu_torch.ops import (adam, fused_methods, fused_presence,
                                        fused_sharded, fused_step)

    rec = {"steps": [], "updates": [], "state": None}
    modules = (fused_step, fused_methods, fused_presence, fused_sharded)
    owner = {"step_flat": fused_step, "method_step_flat": fused_methods,
             "presence_step_flat": fused_presence,
             "dp_step_flat": fused_sharded,
             "dp_method_step_flat": fused_sharded}
    orig = {name: getattr(m, name) for name, m in owner.items()}

    def recorder(kind, fn):
        def step(*args):
            out = fn(*args)
            rec["steps"].append((kind, [cpu(a) for a in args],
                                 [cpu(o) for o in out]))
            return out
        return step

    def update(p, mu, nu, g, t, hyper):
        before = [cpu(x) for x in (p, mu, nu)]
        adam.adam_update(p, mu, nu, g, t, hyper)
        rec["updates"].append((before, cpu(g), t, hyper,
                               [cpu(x) for x in (p, mu, nu)]))
        rec["state"] = (p, mu, nu)

    def method_recorder(method, p, x1, x2, noise, dims, consts, learn_scale,
                        masks=None):
        out = orig["method_step_flat"](method, p, x1, x2, noise, dims,
                                       consts, learn_scale, masks)
        rec["steps"].append((
            "method", [cpu(a) for a in (p, x1, x2, noise, dims, consts,
                                        learn_scale, masks, method)],
            [cpu(o) for o in out]))
        return out

    def dp_mopoe_recorder(p, mu, nu, t, x1, x2, noise, dims, consts, hyper,
                          learn_scale, mesh):
        args = [cpu(a) for a in (p, x1, x2, *fused_step.split_noise(
            noise, dims), dims, consts, learn_scale)]
        m = orig["dp_step_flat"](p, mu, nu, t, x1, x2, noise, dims, consts,
                                 hyper, learn_scale, mesh)
        rec["steps"].append(("complete", args,
                             [cpu(m), rec["updates"][-1][1]]))
        return m

    def dp_method_recorder(method, p, mu, nu, t, x1, x2, noise, dims,
                           consts, hyper, learn_scale, mesh, masks=None):
        args = [cpu(a) for a in (p, x1, x2, noise, dims, consts,
                                 learn_scale, masks, method)]
        m = orig["dp_method_step_flat"](method, p, mu, nu, t, x1, x2, noise,
                                        dims, consts, hyper, learn_scale,
                                        mesh, masks)
        rec["steps"].append(("method", args,
                             [cpu(m), rec["updates"][-1][1]]))
        return m

    new = {"step_flat": recorder("complete", orig["step_flat"]),
           "method_step_flat": method_recorder,
           "presence_step_flat": recorder("presence",
                                          orig["presence_step_flat"]),
           "dp_step_flat": dp_mopoe_recorder,
           "dp_method_step_flat": dp_method_recorder}

    def replayed(module, epoch_fn, one_step, lead=0):
        """``epoch_fn`` (a one-launch group on the card) followed by its
        recorded replay; ``one_step(q, i, ...)`` runs step ``i`` of the
        group on state ``q`` through the recording step wrapper. ``lead``
        arguments (the method) come before the state."""
        import torch

        counts = (adam.KERNEL_LAUNCHES, module.KERNEL_LAUNCHES,
                  module.KERNEL_STEPS)

        def epoch(*args):
            head, (p, mu, nu, count), rest = (args[:lead],
                                              args[lead:lead + 4],
                                              args[lead + 4:])
            if p.device.type != "cuda":
                # the CPU loops the recorded step and update itself
                return epoch_fn(*args)
            q, qm, qv = (x.clone() for x in (p, mu, nu))
            metrics = epoch_fn(*args)
            hyper = next(a for a in rest if isinstance(a, adam.AdamHyper))
            saved = [dict(c) for c in counts]
            rows = []
            for i in range(metrics.shape[0]):
                m, g = one_step(q, i, *head, *rest)
                update(q, qm, qv, g, count + i + 1, hyper)
                rows.append(m)
            for c, old in zip(counts, saved):
                c.update(old)
            same = all(torch.equal(a, b) for a, b in (
                (q, p), (qm, mu), (qv, nu), (torch.stack(rows), metrics)))
            if not same:
                raise SystemExit("a group's one launch and its replay by "
                                 "one-step launches differ")
            rec["state"] = (p, mu, nu)
            return metrics
        return epoch

    def mopoe_one(q, i, x1s, x2s, noise, dims, consts, hyper,
                  learn_scale=True):
        return new["step_flat"](q, x1s[i], x2s[i], *fused_step.split_noise(
            noise[i], dims), dims, consts, learn_scale)

    def presence_one(q, i, xs, noise, dims, consts, hyper, learn_scale,
                     mod_idx, method="joint_elbo", masks=None):
        return new["presence_step_flat"](
            q, xs[i], noise[i], dims, consts, learn_scale, mod_idx, method,
            None if masks is None else masks[i])

    def method_one(q, i, method, x1s, x2s, noise, dims, consts, hyper,
                   learn_scale=True, masks=None):
        return new["method_step_flat"](
            method, q, x1s[i], x2s[i], noise[i], dims, consts, learn_scale,
            None if masks is None else masks[i])

    epochs = {"epoch_flat": (fused_step, mopoe_one, 0),
              "presence_epoch_flat": (fused_presence, presence_one, 0),
              "method_epoch_flat": (fused_methods, method_one, 1)}
    orig_epochs = {name: getattr(m, name)
                   for name, (m, _, _) in epochs.items()}
    for name, m in owner.items():
        setattr(m, name, new[name])
    for name, (m, one, lead) in epochs.items():
        setattr(m, name, replayed(m, orig_epochs[name], one, lead))
    for m in modules:
        m.adam_update = update
    try:
        yield rec
    finally:
        for name, m in owner.items():
            setattr(m, name, orig[name])
        for name, (m, _, _) in epochs.items():
            setattr(m, name, orig_epochs[name])
        for m in modules:
            m.adam_update = adam.adam_update


def relu_flips(card, host, dims):
    """Hidden units whose ReLU took different branches in the two recorded
    runs at the rounding level: at some step and row, the unit's input,
    computed on the host from each run's own state, lies on different
    sides of zero while the two inputs agree to ``EPOCH_RTOL`` of the sum
    of their terms' sizes. Returns the mask of the params whose gradients
    pass through such a unit (its input weights, its bias and its rows of
    the four heads) and a description of each unit's first flip."""
    import torch

    from multivae_tpu_torch.params import flat_views

    mask = torch.zeros_like(card["updates"][0][1], dtype=torch.bool)
    views, flips = flat_views(mask, dims), {}
    for s, ((kind, args, _), (_, host_args, _)) in enumerate(
            zip(card["steps"], host["steps"])):
        # complete and method steps: (p, x1, x2, ...); presence_step_flat(p,
        # x, noise, dims, consts, learn_scale, mod_idx, ...)
        inputs = ([(args[6] + 1, args[1])] if kind == "presence"
                  else [(1, args[1]), (2, args[2])])
        for e, x in inputs:
            pre = []
            for p in (args[0], host_args[0]):
                w, b = (flat_views(p, dims)[f"enc{e}_{n}"] for n in
                        ("Wh", "bh"))
                pre.append(x @ w + b)
            size = x.abs() @ w.abs() + b.abs()
            gap = (pre[0] - pre[1]).abs()
            flip = ((pre[0] > 0) != (pre[1] > 0)) & (gap <= EPOCH_RTOL * size)
            for r, j in torch.nonzero(flip).tolist():
                if (e, j) in flips:
                    continue
                flips[(e, j)] = (
                    f"enc{e} unit {j}: step {s} row {r}, input "
                    f"{float(pre[0][r, j]):.3e} (card's state) vs "
                    f"{float(pre[1][r, j]):.3e} (CPU's), "
                    f"{float(gap[r, j] / size[r, j]):.1e} of its terms' size")
                views[f"enc{e}_Wh"][:, j] = True
                views[f"enc{e}_bh"][j] = True
                for head in ("Wcmu", "Wclv", "Wsmu", "Wslv"):
                    views[f"enc{e}_{head}"][j] = True
    return mask, list(flips.values())


def hold_adam_updates(updates, phase, label) -> float:
    """Recompute every recorded Adam update (:func:`recording_train_loop`)
    by the plain version on the host from the same state and gradient, and
    hold it to the Adam bound, every element; returns the max abs error."""
    import torch

    from multivae_tpu_torch.ops import adam

    worst = 0.0
    for before, g, t, hyper, after in updates:
        st = [x.clone() for x in before]
        adam.adam_update_reference(*st, g, t, hyper)
        for i, (a, b) in enumerate(zip(after, st)):
            err, bad = close(a, b, ADAM_RTOL, ADAM_ATOL)
            if i == 0:
                # 1 - exp(t log b2) cancels ~3 digits at small t, so the
                # card's and the host's exp (1 ulp apart) give updates
                # ~1e-4 apart relative to the update itself
                bad &= (a - b).abs() > 1e-4 * (b - before[0]).abs()
            worst = max(worst, err)
            if bool(bad.any()):
                j = int(torch.argmax((a - b).abs() * bad))
                log(phase, f"Adam t={t} {'p mu nu'.split()[i]}: "
                    f"{int(bad.sum())} outside; worst [{j}] card "
                    f"{float(a[j]):.9e} host {float(b[j]):.9e} before "
                    f"{float(before[i][j]):.9e} g {float(g[j]):.9e} "
                    f"mu {float(before[1][j]):.6e} "
                    f"nu {float(before[2][j]):.6e}")
                raise SystemExit(f"an Adam update of the epoch of {label} "
                                 f"disagrees with the plain version")
    return worst


def hold_slice_epoch(card, host, dims, phase="train-slice",
                     labels=("card (kernels)", "CPU (plain versions)"),
                     referee64=False):
    """Hold the card's epoch to the CPU's (``card``/``host``: the records
    of :func:`recording_train_loop`; ``labels`` name the two runs, which
    may also be two runs on the card).

    1. Both runs fed every step the same inputs (batches and noise), bit
       for bit.
    2. Along the card's own trajectory, every step and every Adam update
       is recomputed by the plain versions on the host from the same
       inputs, and held to the step and Adam bounds, every element.
    3. The params after the epoch are held by :func:`hold_epoch`, with the
       params behind the ReLUs of :func:`relu_flips` as its branch.

    ``referee64`` (two runs on the card, held on a cohort's own steps): in
    2. the plain steps run in float64, so the bound holds the kernels' own
    error and not the sum of two float32 roundings, and a gradient's
    absolute bound is ``STEP_ATOL`` times the largest element of its split
    tensor (at least 1): a float32 sum's error grows with its terms, and a
    cohort's poe step has gradients of hundreds where the seeded checks of
    train-kernel have ones. In 3. what parts downstream of Adam's trap is
    accepted (``hold_epoch(downstream_ok=True)``): 2. holds every step."""
    import torch

    from multivae_tpu_torch.ops import (adam, fused_methods, fused_presence,
                                        fused_step)

    def tensors_equal(a, b):
        return torch.equal(a, b) if torch.is_tensor(a) else a == b

    same_inputs = len(card["steps"]) == len(host["steps"]) and all(
        ck == hk and all(tensors_equal(a, b)
                         for a, b in zip(ca[1:], ha[1:]))
        for (ck, ca, _), (hk, ha, _) in zip(card["steps"], host["steps"]))
    if not same_inputs:
        raise SystemExit(f"the epochs of {labels[0]} and {labels[1]} were "
                         f"fed different inputs")
    plain = {"complete": fused_step.step_flat,
             "presence": fused_presence.presence_step_flat,
             "method": lambda p, x1, x2, noise, d, consts, ls, masks, method:
             fused_methods.method_step_flat(method, p, x1, x2, noise, d,
                                            consts, ls, masks)}
    worst_step = 0.0

    def on_host(x):
        if referee64 and torch.is_tensor(x) and x.is_floating_point():
            return x.double()
        return x

    from multivae_tpu_torch.params import flat_views

    worst_scale = 1.0
    for kind, args, (km, kg) in card["steps"]:
        rm, rg = plain[kind](*[on_host(a) for a in args])
        g_atol = STEP_ATOL
        if referee64:
            g_atol = torch.empty_like(rg)
            for t, v in zip(flat_views(g_atol, dims).values(),
                            flat_views(rg, dims).values()):
                t.fill_(STEP_ATOL * max(1.0, float(v.abs().max())))
            worst_scale = max(worst_scale, float(g_atol.max()) / STEP_ATOL)
        for a, b, rtol, atol in ((km[:1], rm[:1], LOSS_RTOL, 0.0),
                                 (km, rm, STEP_RTOL, STEP_ATOL),
                                 (kg, rg, STEP_RTOL, g_atol)):
            err, bad = close(a, b, rtol, atol)
            worst_step = max(worst_step, err)
            if bool(bad.any()):
                j = int(torch.argmax((a - b).abs() * bad))
                log(phase, f"a {kind} step, tensor of {a.numel()}: "
                    f"{int(bad.sum())} elements outside rtol {rtol} / atol "
                    f"{atol if isinstance(atol, float) else 'scaled'}; worst "
                    f"[{j}] {float(a.reshape(-1)[j]):.9e} vs "
                    f"plain {float(b.reshape(-1)[j]):.9e}")
                raise SystemExit(f"a {kind} step of the epoch of "
                                 f"{labels[0]} disagrees with the plain "
                                 f"version")
    worst_adam = hold_adam_updates(card["updates"], phase, labels[0])
    log(phase, f"one epoch, {labels[0]} vs {labels[1]}: same inputs at all "
        f"{len(card['steps'])} steps; the former's steps recomputed by the "
        f"plain versions on the host"
        + (f" in float64 (gradient atol {STEP_ATOL} x its tensor's largest "
           f"element, at most x {worst_scale:.1f})" if referee64 else "")
        + f" max_abs_err {worst_step:.3e}, its "
        f"{len(card['updates'])} Adam updates {worst_adam:.3e}")
    branch, flips = relu_flips(card, host, dims)
    log(phase, f"ReLUs that took different branches at the rounding level"
        + (" (sums in another order may flip one)" if referee64 else "")
        + f": {flips if flips else 'none'}")
    hold_epoch(phase, f"params after one epoch, {labels[0]} vs {labels[1]}",
               (card["updates"][-1][4][0],), (host["updates"][-1][4][0],),
               [u[1] for u in card["updates"]],
               [u[1] for u in host["updates"]], dims, branch,
               downstream_ok=referee64)


def step_counters():
    """The counts of train steps run by the persistent kernels' launches
    (one launch may run a group of steps)."""
    from multivae_tpu_torch.ops import (fused_generic, fused_methods,
                                        fused_presence, fused_step)

    return {"mopoe_step": fused_step.KERNEL_STEPS,
            "dp_step": fused_step.KERNEL_STEPS,
            "method_step": fused_methods.KERNEL_STEPS,
            "dp_method_step": fused_methods.KERNEL_STEPS,
            "presence_step": fused_presence.KERNEL_STEPS,
            "generic_step": fused_generic.KERNEL_STEPS}


def slice_counters():
    from multivae_tpu_torch.ops import (adam, fused_generic, fused_methods,
                                        fused_presence, fused_step)

    return {"generic_step": fused_generic.KERNEL_LAUNCHES,
            "mopoe_step": fused_step.KERNEL_LAUNCHES,
            "dp_step": fused_step.KERNEL_LAUNCHES,
            "method_step": fused_methods.KERNEL_LAUNCHES,
            "dp_method_step": fused_methods.KERNEL_LAUNCHES,
            "presence_step": fused_presence.KERNEL_LAUNCHES,
            "flat_adam": adam.KERNEL_LAUNCHES}


def train_and_check(outdir, datadir, device, card, method, rate, epochs,
                    complete, clinical, batching_s, data_parallel=1,
                    phase="train-slice"):
    """``train_exp`` of one method on the card with every count set to 0
    just before and read just after; checks the launches of its routes (the
    MoPoE, method and presence routes: one launch per ``(presence pattern,
    rows)`` group, Adam inside, and the steps those launches ran), the
    losses, the metric families and the checkpoints. ``outdir`` is the
    run's own (run names have the resolution of a minute). With
    ``data_parallel > 1`` the full complete batches take ``data_parallel``
    row-slice launches each. Returns ``(run, launches)``."""
    import types

    import pandas as pd
    import torch

    from multivae_tpu_torch.ops import fused_methods, fused_presence

    counters = slice_counters()
    tag = method + (f", dropout {rate}" if rate else "") + (
        f", data_parallel {data_parallel}" if data_parallel > 1 else "")
    steps = len(complete) + len(clinical)
    # the complete batches that split over the shards, and the others
    n_dp = sum(b == 256 for b in complete) if data_parallel > 1 else 0
    n_whole = len(complete) - n_dp
    # one launch per group of equal rows (the sharded batches apart)
    whole_groups = len(set(complete)) - (1 if n_dp else 0)
    ran = step_counters()
    for c in list(counters.values()) + list(ran.values()):
        for k in c:
            c[k] = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    run, walls = train_run(datadir, outdir, epochs, "cuda", method=method,
                           dropout_rate=rate, data_parallel=data_parallel)
    total = time.perf_counter() - start
    launches = {k: c[k] for k, c in counters.items()}
    steps_run = {k: c[k] for k, c in ran.items()}
    rundir = os.path.join(outdir, run)
    csv = pd.read_csv(os.path.join(rundir, "logs", "metrics.csv"))
    tr = csv[csv.phase == "train"]
    per_step = tr.groupby("step").metric.apply(frozenset)
    names = types.SimpleNamespace(modalities=[
        types.SimpleNamespace(name="clinical"),
        types.SimpleNamespace(name="rois")])
    complete_fam = frozenset(fused_methods.method_metric_names(names,
                                                               method))
    clinical_fam = frozenset(fused_presence.presence_metric_names(
        names, method, 0))
    n_complete = sum(s == complete_fam for s in per_step)
    n_clinical = sum(s == clinical_fam for s in per_step)
    losses = tr[tr.metric == "loss"].sort_values("step").value.to_numpy()
    first = losses[:steps].mean()
    last = losses[-steps:].mean()
    ckpt = os.path.join(rundir, "checkpoints", f"{epochs - 1:04d}")
    # joint_elbo without dropout keeps the MoPoE step; every other
    # complete batch takes the method step
    mopoe = method == "joint_elbo" and not rate
    checks = {
        "mopoe_step launches": launches["mopoe_step"]
        == (whole_groups * epochs if mopoe else 0),
        "mopoe_step steps": steps_run["mopoe_step"]
        == (n_whole * epochs if mopoe else 0),
        "method_step launches": launches["method_step"]
        == (0 if mopoe else whole_groups * epochs),
        "method_step steps": steps_run["method_step"]
        == (0 if mopoe else n_whole * epochs),
        "dp_step launches": launches["dp_step"]
        == (n_dp * data_parallel * epochs if mopoe else 0),
        "dp_method_step launches": launches["dp_method_step"]
        == (0 if mopoe else n_dp * data_parallel * epochs),
        "presence_step launches": launches["presence_step"]
        == len(set(clinical)) * epochs,
        "presence_step steps": steps_run["presence_step"]
        == len(clinical) * epochs,
        # Adam runs inside the MoPoE, method and presence launches;
        # flat_adam follows every data-parallel step
        "flat_adam launches": launches["flat_adam"] == n_dp * epochs,
        "losses finite": bool(np.isfinite(csv.value).all()),
        "last epoch loss < first": bool(last < first),
        "complete-route families": n_complete == len(complete) * epochs,
        "log_prob_uni only for poe": ("log_prob_uni/rois" in complete_fam)
        == (method == "poe"),
        "clinical-only-route families": n_clinical
        == len(clinical) * epochs,
        "model.npz": os.path.isfile(os.path.join(ckpt, "model.npz")),
        "opt_state.npz": os.path.isfile(os.path.join(ckpt,
                                                     "opt_state.npz")),
    }
    wall = float(np.median(walls[1:])) if len(walls) > 1 else walls[0]
    log(phase, f"[{tag}] train_exp {epochs} epochs x {steps} steps"
        f" in {total:.3f} s (set-up included); launches {launches}; steps "
        f"run by the persistent kernels' launches {steps_run}; "
        f"mean train loss epoch 1 {first:.3f} -> epoch {epochs} "
        f"{last:.3f}; checks "
        + ", ".join(f"{k}={v}" for k, v in checks.items()))
    log(phase, f"[{tag}] train wall per epoch (train + test + "
        f"logs, host clock, synchronized): first {walls[0]:.4f} s, median "
        f"of the rest {wall:.4f} s = {steps / wall:.1f} steps/s end to "
        f"end; host batching {batching_s:.4f} s = "
        f"{100 * batching_s / wall:.1f} % of it ({card})")
    if not all(checks.values()):
        raise SystemExit(f"train slice wrong ({tag}): {checks}")

    ep_wall, by_name = profile_epoch(datadir, rundir, device)
    busy = sum(by_name.values())
    if busy > 0:
        ours = {k: v for k, v in by_name.items()
                if any(s in k for s in ("steps_kernel", "flat_adam"))}
        log(phase, f"[{tag}] profiled training epoch: wall "
            f"{ep_wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
            f"(idle share {100 * (1 - busy / (ep_wall * 1e3)):.1f} %) ="
            f" {steps / (busy * 1e-3):.1f} device steps/s; hand "
            f"kernels {sum(ours.values()):.3f} ms; top: "
            + ", ".join(f"{k[:40]} {v:.3f}" for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:6]))
    else:
        log(phase, f"[{tag}] profiled training epoch: wall "
            f"{ep_wall * 1e3:.3f} ms; device time not measured (the "
            f"profiler recorded no device events)")
    return run, launches


def slice_cohort(root: str, phase: str):
    """The train slices' cohort under ``root``: ``(datadir, complete batch
    sizes, clinical-only batch sizes, host batching seconds per epoch)``."""
    from multivae_tpu_torch.data import make_synthetic_cohort

    datadir = os.path.join(root, "data")
    make_synthetic_cohort(datadir, n_subjects=SLICE_SUBJECTS, n_scores=7,
                          n_rois=444, missing_rate=0.2, seed=SEED,
                          signal_strength=2.0)
    complete, clinical, batching_s = epoch_batch_counts(datadir)
    log(phase, f"cohort {SLICE_SUBJECTS} subjects: complete batches "
        f"{complete}, clinical-only batches {clinical}; host batching "
        f"(sampler + gather + scaling) {batching_s:.4f} s per epoch")
    if (complete != sorted(EPOCH_COMPLETE)
            or clinical != sorted(EPOCH_PRESENCE)):
        raise SystemExit("unexpected epoch batches")
    return datadir, complete, clinical, batching_s


def train_slice(device, card: str):
    """Phase train-slice: ``workflows.train_exp`` on the card at the
    flagship width for joint_elbo, moe, jsd, poe and poe with dropout, then
    ``daa_exp`` of the trained joint_elbo run, then one epoch on the card
    against one epoch on the CPU (the plain versions). Returns each train
    run's launches, ``{path: {kernel: count}}``."""
    from multivae_tpu_torch import workflows

    with tempfile.TemporaryDirectory() as root:
        datadir, complete, clinical, batching_s = slice_cohort(
            root, "train-slice")
        by_path = {}
        run, by_path["train joint_elbo"] = train_and_check(
            os.path.join(root, "out"), datadir, device, card, "joint_elbo",
            0.0, SLICE_EPOCHS, complete, clinical, batching_s)
        for method, rate in METHOD_SLICES:
            path = f"train {method}" + (f" dropout {rate}" if rate else "")
            _, by_path[path] = train_and_check(
                os.path.join(root, f"out_{method}_{rate}"), datadir, device,
                card, method, rate, METHOD_SLICE_EPOCHS, complete, clinical,
                batching_s)

        # daa of the trained run through its normal entry point
        start = time.perf_counter()
        resdir = workflows.daa_exp(
            "synthetic", datadir, os.path.join(root, "out"), run,
            n_validation=2, n_samples=50, n_subjects=50, M=100,
            device="cuda")
        tsv = os.path.join(resdir, "significant_rois.tsv")
        with open(tsv) as fh:
            n_rows = fh.read().count("\n") - 1
        log("train-slice", f"daa_exp of the trained run: "
            f"{time.perf_counter() - start:.3f} s, significant_rois.tsv "
            f"{n_rows} rows")

        # one epoch on the card against one epoch on the CPU
        from multivae_tpu_torch.params import dims_from

        records = {}
        for dev in ("cuda", "cpu"):
            with recording_train_loop() as rec:
                train_run(datadir, os.path.join(root, f"one_{dev}"), 1, dev)
            records[dev] = rec
        hold_slice_epoch(records["cuda"], records["cpu"],
                         dims_from(flagship_cfg(), 256))
    return by_path


# ------------------------------------------------- deep-architecture slices
# (path, train_exp's architecture and method flags), 3 epochs each
GENERIC_SLICES = (
    ("train deep-A joint_elbo", dict(
        num_hidden_layer_encoder=1, num_hidden_layer_decoder=1,
        out_scale_per_subject=True, method="joint_elbo", dropout_rate=0.0)),
    ("train deep-B poe dropout 0.2", dict(
        num_hidden_layer_encoder=2, num_hidden_layer_decoder=1,
        method="poe", dropout_rate=MASK_RATE)),
    ("train laplace joint_elbo", dict(
        likelihood="laplace", method="joint_elbo", dropout_rate=0.0)),
    ("train unfactorized moe", dict(
        factorized_representation=False, num_hidden_layer_encoder=1,
        num_hidden_layer_decoder=1, method="moe", dropout_rate=0.0)),
)
GENERIC_SLICE_EPOCHS = 3
# the runs that `daa` analyses next, through the general sweep
GENERAL_DAA_RUNS = ("train deep-A joint_elbo", "train laplace joint_elbo")
GENERAL_DAA = dict(sampling_strategy="likelihood", n_validation=2,
                   n_samples=N_SAMPLES, n_subjects=B, M=100, seed=SEED,
                   sample_latents=True, artifact="full",
                   fetch_dtype="float16", chunk=16)


@contextlib.contextmanager
def recording_generic_epoch():
    """Record the layer-stack steps of the train loop on the host: a group
    of steps is one launch with Adam inside on the card, so the state
    before it is kept, the launch runs, and the group is replayed from the
    kept state with one-step launches and ``flat_adam``, each step's
    arguments and (metrics, grads) and each update's state before and after
    recorded; the replay must end in the launch's state and metrics, bit for
    bit. The replay's launches are taken out of the launch and step
    counts."""
    import torch

    from multivae_tpu_torch.ops import adam, fused_generic

    rec = {"steps": [], "updates": []}
    epoch_fn = fused_generic.generic_epoch_flat

    def epoch(method, p, mu, nu, count, x1s, x2s, noise, dims, consts, hyper,
              learn_scale=True, masks=None, order=None):
        q, qm, qv = (x.clone() for x in (p, mu, nu))
        metrics = epoch_fn(method, p, mu, nu, count, x1s, x2s, noise, dims,
                           consts, hyper, learn_scale, masks, order)
        counts = (adam.KERNEL_LAUNCHES, fused_generic.KERNEL_LAUNCHES,
                  fused_generic.KERNEL_STEPS)
        saved = [dict(c) for c in counts]
        rows = []
        for i in range(x1s.shape[0]):
            args = (method, q, x1s[i], x2s[i], noise[i], dims, consts,
                    learn_scale, None if masks is None else masks[i])
            out = fused_generic.generic_step_flat(*args)
            rec["steps"].append(([cpu(a) for a in args],
                                 [cpu(o) for o in out]))
            before = [cpu(x) for x in (q, qm, qv)]
            adam.adam_update(q, qm, qv, out[1], count + i + 1, hyper)
            rec["updates"].append((before, cpu(out[1]), count + i + 1, hyper,
                                   [cpu(x) for x in (q, qm, qv)]))
            rows.append(out[0])
        for c, old in zip(counts, saved):
            c.update(old)
        rows = torch.stack(rows)
        if order is not None:
            rows = rows[:, torch.as_tensor(order, device=rows.device)]
        if not all(torch.equal(a, b) for a, b in (
                (q, p), (qm, mu), (qv, nu), (rows, metrics))):
            raise SystemExit("the generic_step launch and its replay by "
                             "one-step launches differ")
        return metrics

    fused_generic.generic_epoch_flat = epoch
    try:
        yield rec
    finally:
        fused_generic.generic_epoch_flat = epoch_fn


def generic_train_and_check(root, path, kw, datadir, device, card, complete,
                            clinical, batching_s):
    """``train_exp`` of one deep-architecture slice on the card with every
    count set to 0 just before and read just after; checks the launches of
    its routes (the full complete batches on the layer-stack step, every
    other batch on the general autograd step), the losses, the metric
    families, the checkpoints and a resumed run; then recomputes the first
    epoch's kernel steps by the plain version from the card's own state.
    Returns the launches."""
    import types

    import pandas as pd
    import torch

    from multivae_tpu_torch import workflows
    from multivae_tpu_torch.ops import fused_generic, fused_presence
    from multivae_tpu_torch.params import dims_from, flat_size
    from multivae_tpu_torch.train.config import Config

    phase, epochs = "generic-slice", GENERIC_SLICE_EPOCHS
    tag = path[len("train "):]
    counters = slice_counters()
    ran = step_counters()
    steps = len(complete) + len(clinical)
    n_full = sum(b == 256 for b in complete)
    outdir = os.path.join(root, path.replace(" ", "_"))
    for c in list(counters.values()) + list(ran.values()):
        for k in c:
            c[k] = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    run, walls = train_run(datadir, outdir, epochs, "cuda", **kw)
    total = time.perf_counter() - start
    launches = {k: c[k] for k, c in counters.items()}
    steps_run = ran["generic_step"]["generic_step"]
    rundir = os.path.join(outdir, run)

    def train_losses():
        csv = pd.read_csv(os.path.join(rundir, "logs", "metrics.csv"))
        tr = csv[csv.phase == "train"]
        return csv, tr, tr[tr.metric == "loss"].sort_values(
            "step").value.to_numpy()

    csv, tr, losses = train_losses()
    per_step = tr.groupby("step").metric.apply(frozenset)
    styled = kw.get("factorized_representation", True)
    names = types.SimpleNamespace(
        factorized_representation=styled, modalities=[
            types.SimpleNamespace(name=n, style_dim=s) for n, s in zip(
                ("clinical", "rois"), SLICE_TRAIN["style_dim"])])
    method = kw["method"]
    complete_fam = frozenset(fused_generic.generic_metric_names(names,
                                                                method))
    # the general step's families: total_loss's, no style family without
    # style latents
    clinical_fam = frozenset(
        n for n in fused_presence.presence_metric_names(names, method, 0)
        if styled or "_style" not in n)
    first, last = losses[:steps].mean(), losses[-steps:].mean()
    ckpt = os.path.join(rundir, "checkpoints", f"{epochs - 1:04d}")
    checks = {
        # one launch per epoch for the full complete batches, Adam inside;
        # flat_adam after every general (autograd) step
        "generic_step launches = epochs": launches["generic_step"] == epochs,
        "generic_step steps = full complete batches": steps_run
        == n_full * epochs,
        "flat_adam launches = the other batches": launches["flat_adam"]
        == (steps - n_full) * epochs,
        "no other step kernel": all(
            launches[k] == 0 for k in ("mopoe_step", "method_step",
                                       "presence_step", "dp_step",
                                       "dp_method_step")),
        "losses finite": bool(np.isfinite(csv.value).all()),
        "last epoch loss < first": bool(last < first),
        "complete-batch families": sum(s == complete_fam for s in per_step)
        == len(complete) * epochs,
        "style families only with style latents": any(
            "_style" in n for n in complete_fam) == styled,
        "log_prob_uni only for poe": ("log_prob_uni/rois" in complete_fam)
        == (method == "poe"),
        "clinical-only families": sum(s == clinical_fam for s in per_step)
        == len(clinical) * epochs,
        "model.npz": os.path.isfile(os.path.join(ckpt, "model.npz")),
        "opt_state.npz": os.path.isfile(os.path.join(ckpt,
                                                     "opt_state.npz")),
    }
    wall = float(np.median(walls[1:]))
    log(phase, f"[{tag}] train_exp {epochs} epochs x {steps} steps in "
        f"{total:.3f} s (set-up included); launches {launches}; per epoch "
        f"{launches['generic_step'] / epochs:g} generic_step launch for "
        f"{steps_run / epochs:g} full complete batches and "
        f"{launches['flat_adam'] / epochs:g} flat_adam; steps run "
        f"by the generic_step launches {steps_run}; mean train "
        f"loss epoch 1 {first:.3f} -> epoch {epochs} {last:.3f}; checks "
        + ", ".join(f"{k}={v}" for k, v in checks.items()))
    log(phase, f"[{tag}] train wall per epoch (train + test + logs, host "
        f"clock, synchronized): first {walls[0]:.4f} s, median of the rest "
        f"{wall:.4f} s = {steps / wall:.1f} steps/s end to end; host "
        f"batching {batching_s:.4f} s = {100 * batching_s / wall:.1f} % of "
        f"it ({card})")
    if not all(checks.values()):
        raise SystemExit(f"generic slice wrong ({tag}): {checks}")

    # the checkpoint restored into a resumed run that trains one epoch more
    with contextlib.redirect_stdout(io.StringIO()):
        workflows.resume_exp("synthetic", datadir, outdir, run, epochs + 1,
                             use_tensorboard=False, device="cuda")
    _, _, losses = train_losses()
    resumed = losses[-steps:].mean()
    with np.load(os.path.join(rundir, "checkpoints", f"{epochs:04d}",
                              "opt_state.npz")) as fh:
        count, n_mu = int(fh["count"]), int(fh["mu"].size)
    cfg = Config.load(os.path.join(rundir, "flags.json"))
    resume_checks = {
        "Adam count continues": count == steps * (epochs + 1),
        "moments of the deep tree": n_mu == flat_size(
            dims_from(cfg, cfg.batch_size)),
        "resumed epoch's loss below the first epoch's": bool(
            resumed < first),
        "resumed epoch's loss near the last epoch's": bool(
            abs(resumed - last) < 0.5 * abs(first - last)),
    }
    log(phase, f"[{tag}] resume_exp to {epochs + 1} epochs: mean train loss "
        f"of the resumed epoch {resumed:.3f}; checks "
        + ", ".join(f"{k}={v}" for k, v in resume_checks.items()))
    if not all(resume_checks.values()):
        raise SystemExit(f"generic slice resume wrong ({tag})")

    ep_wall, by_name = profile_epoch(datadir, rundir, device)
    busy = sum(by_name.values())
    if busy > 0:
        ours = sum(v for k, v in by_name.items() if any(
            s in k for s in ("steps_kernel", "flat_adam")))
        log(phase, f"[{tag}] profiled training epoch: wall "
            f"{ep_wall * 1e3:.3f} ms, device busy {busy:.3f} ms (idle share "
            f"{100 * (1 - busy / (ep_wall * 1e3)):.1f} %) = "
            f"{steps / (busy * 1e-3):.1f} device steps/s; hand kernels "
            f"{ours:.3f} ms, the rest (the general-step batches' autograd "
            f"kernels, copies) {busy - ours:.3f} ms = "
            f"{100 * (busy - ours) / busy:.1f} % of busy; top: "
            + ", ".join(f"{k[:40]} {v:.3f}" for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:6]))
    else:
        log(phase, f"[{tag}] profiled training epoch: wall "
            f"{ep_wall * 1e3:.3f} ms; device time not measured (the "
            f"profiler recorded no device events)")

    # the first epoch's kernel steps (the launch replayed step by step) and
    # their Adam updates, recomputed by the plain versions on the host from
    # the card's own state
    with recording_generic_epoch() as rec:
        train_run(datadir, os.path.join(root, path.replace(" ", "_")
                                        + "_one"), 1, "cuda", **kw)
    worst = 0.0
    for i, (args, out) in enumerate(rec["steps"]):
        method_, p, x1, x2, noise, dims, consts, learn_scale, masks = args
        worst = max(worst, check_step(
            f"generic_step[{tag}]", out,
            fused_generic.generic_step_flat(*args), split_pairs(dims),
            f"step {i} of the first epoch, from the card's state", phase,
            quiet=True, excuse=lambda: rounding_level_units(
                method_, p, (x1, x2, noise, masks), dims, consts)))
    worst_adam = hold_adam_updates(rec["updates"], phase, tag)
    ok = len(rec["steps"]) == len(rec["updates"]) == n_full
    log(phase, f"[{tag}] first epoch: the generic_step launch equals its "
        f"{len(rec['steps'])} steps replayed by one-step launches and "
        f"flat_adam, bit for bit; those steps recomputed by the plain "
        f"version on the host from the card's own state max_abs_err "
        f"{worst:.3e}, their {len(rec['updates'])} Adam updates "
        f"{worst_adam:.3e}")
    if not ok:
        raise SystemExit(f"generic slice ({tag}): expected {n_full} kernel "
                         f"steps in the first epoch")
    if path in GENERAL_DAA_RUNS:
        general_daa(root, outdir, run, datadir, device, card, tag)
    return launches


def general_daa(root, outdir, run, datadir, device, card, tag):
    """``workflows.daa_exp`` of a trained run that the sweep kernel does
    not take, on the card through the general sweep (one model forward
    per cell, vmapped over chunks): wall per round and the outputs'
    checks; then one round's sweep on the card held to the same function
    on the CPU from the same noise."""
    import torch

    from multivae_tpu_torch import workflows
    from multivae_tpu_torch.analysis import daa
    from multivae_tpu_torch.ops import fused_daa
    from multivae_tpu_torch.train.experiment import load_run

    phase = "generic-slice"
    kw = GENERAL_DAA
    fused_daa.KERNEL_LAUNCHES["avatar_sweep"] = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        resdir = workflows.daa_exp("synthetic", datadir, outdir, run,
                                   device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    n_val, n_scores, n_rois = kw["n_validation"], 7, 444
    avatars = np.load(os.path.join(resdir, "rois_digital_avatars.npy"),
                      mmap_mode="r")
    pvalues = np.load(os.path.join(resdir, "pvalues.npy"))
    checks = {
        "avatars shape": avatars.shape == (n_val, kw["n_subjects"],
                                           n_scores, kw["n_samples"],
                                           n_rois),
        "avatars finite": bool(np.isfinite(avatars).all()),
        "pvalues in [0, 1]": bool(np.isfinite(pvalues).all()
                                  and (pvalues >= 0).all()
                                  and (pvalues <= 1).all()),
        "significant_rois.tsv": os.path.isfile(
            os.path.join(resdir, "significant_rois.tsv")),
        "no sweep kernel launch": fused_daa.KERNEL_LAUNCHES[
            "avatar_sweep"] == 0,
    }

    # one round's sweep: the card against the CPU, same inputs and noise
    card_exp, cfg = load_run(outdir, run, device)
    host_exp, _ = load_run(outdir, run, "cpu")
    model = card_exp.models[0]
    rng = np.random.default_rng(SEED)
    data = {n: torch.from_numpy(rng.normal(size=(kw["n_subjects"], d))
                                .astype(np.float32)).to(device)
            for n, d in zip(model.mod_names, (n_scores, n_rois))}
    scores = torch.randn((kw["n_samples"], kw["n_subjects"], n_scores),
                         generator=torch.Generator(device=device)
                         .manual_seed(SEED), device=device)
    cdata, eps = daa.general_sweep_inputs(
        model, data, scores, torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    start = time.perf_counter()
    on_card = daa.general_sweep_cells(model, cdata, data["rois"], eps, True,
                                      kw["chunk"])
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - start
    on_host = daa.general_sweep_cells(host_exp.models[0], cdata.cpu(),
                                      data["rois"].cpu(), eps.cpu(), True,
                                      kw["chunk"])
    err, bad = close(on_card.cpu(), on_host, RTOL, ATOL)
    checks["card sweep = CPU sweep"] = not bool(bad.any())
    log(phase, f"[{tag}] daa_exp through the general sweep: "
        f"{n_val} rounds in {wall:.3f} s = {wall / n_val:.3f} s per round "
        f"(M={kw['M']} Monte-Carlo reconstruction passes, "
        f"{kw['n_samples']} x {n_scores} cells of {kw['n_subjects']} rows, "
        f"chunk {kw['chunk']}); one round's general sweep on the card "
        f"{sweep_s * 1e3:.2f} ms by the host's clock, against the same "
        f"sweep on the CPU from the same noise max_abs_err {err:.3e} "
        f"(rtol {RTOL} / atol {ATOL}); checks "
        + ", ".join(f"{k}={v}" for k, v in checks.items()) + f" ({card})")
    if not all(checks.values()):
        raise SystemExit(f"general daa wrong ({tag}): {checks}")


def generic_slice(device, card: str):
    """Phase generic-slice: ``workflows.train_exp`` on the card at the
    flagship widths for deep-A (1 + 1 hidden layers, a per-sample output
    scale, joint_elbo) and deep-B (2 + 1 hidden layers, dropout 0.2, poe).
    Returns each run's launches, ``{path: {kernel: count}}``."""
    by_path = {}
    with tempfile.TemporaryDirectory() as root:
        datadir, complete, clinical, batching_s = slice_cohort(
            root, "generic-slice")
        for path, kw in GENERIC_SLICES:
            by_path[path] = generic_train_and_check(
                root, path, kw, datadir, device, card, complete, clinical,
                batching_s)
    return by_path


# ------------------------------------------- data-parallel and ensembles
DP_SLICES = (("train_dp_joint_elbo", "joint_elbo", 0.0, 3),
             ("train_dp_poe_dropout", "poe", 0.2, 2))
DATA_PARALLEL = 4


def dp_slice(device, card: str):
    """Phase dp-slice: ``train_exp(data_parallel=4)`` on the card for
    joint_elbo and for poe with dropout, and each one's first epoch against
    a ``data_parallel=1`` run from the same seed. Returns each run's
    launches, ``{path: {kernel: count}}``."""
    from multivae_tpu_torch.params import dims_from

    by_path = {}
    with tempfile.TemporaryDirectory() as root:
        datadir, complete, clinical, batching_s = slice_cohort(
            root, "dp-slice")
        for path, method, rate, epochs in DP_SLICES:
            _, by_path[path] = train_and_check(
                os.path.join(root, path), datadir, device, card, method,
                rate, epochs, complete, clinical, batching_s,
                data_parallel=DATA_PARALLEL, phase="dp-slice")
            records = {}
            for n in (DATA_PARALLEL, 1):
                with recording_train_loop() as rec:
                    train_run(datadir, os.path.join(root, f"{path}_one_{n}"),
                              1, "cuda", method=method, dropout_rate=rate,
                              data_parallel=n)
                records[n] = rec
            hold_slice_epoch(
                records[DATA_PARALLEL], records[1],
                dims_from(flagship_cfg(), 256), "dp-slice",
                (f"{method} data_parallel={DATA_PARALLEL}",
                 f"{method} data_parallel=1 (both on the card)"),
                referee64=True)
    return by_path


def run_arrays(rundir: str, member: int, epoch: int):
    """Every array of a member's checkpoint: params and Adam state."""
    out = {}
    ckpt = os.path.join(rundir, "checkpoints", f"model_{member}",
                        f"{epoch:04d}")
    for name in ("model.npz", "opt_state.npz"):
        with np.load(os.path.join(ckpt, name)) as fh:
            out.update({f"{name}:{k}": fh[k] for k in fh.files})
    return out


def ensemble_slice(device, card: str):
    """Phase ensemble-slice: two members trained by the ensemble runner
    (two streams) against the sequential member loop from the same seed,
    and the sharded avatar sweep against the unsharded one. Returns the
    launches, ``{path: {kernel: count}}``."""
    import torch

    from multivae_tpu_torch.analysis import daa
    from multivae_tpu_torch.models import build_model, make_modalities
    from multivae_tpu_torch.ops import fused_daa
    from multivae_tpu_torch.parallel import data_mesh, spread

    epochs, members = 2, 2
    counters = slice_counters()
    by_path = {}
    with tempfile.TemporaryDirectory() as root:
        datadir, _, _, _ = slice_cohort(root, "ensemble-slice")
        runs, walls = {}, {}
        for parallel in (True, False):
            for c in counters.values():
                for k in c:
                    c[k] = 0
            out = os.path.join(root, f"ensemble_{parallel}")
            run, walls[parallel] = train_run(
                datadir, out, epochs, "cuda", num_models=members,
                ensemble_parallel=parallel)
            runs[parallel] = os.path.join(out, run)
            if parallel:
                by_path["train_ensemble"] = {k: c[k]
                                             for k, c in counters.items()}
        n_arrays, differ = 0, []
        for m in range(members):
            a = run_arrays(runs[True], m, epochs - 1)
            b = run_arrays(runs[False], m, epochs - 1)
            n_arrays += len(a)
            differ += [f"member {m} {k}" for k in a
                       if not np.array_equal(a[k], b[k])]
        files = all(os.path.isfile(os.path.join(
            runs[True], "logs", f"model_{m}", "metrics.csv"))
            for m in range(members))
        log("ensemble-slice", f"train_exp num_models={members} {epochs} "
            f"epochs, ensemble_parallel=True (a stream per member) vs False "
            f"(members in turn): {n_arrays} arrays of params and Adam state "
            f"compared, {len(differ)} differ; per-member metrics.csv "
            f"{files}; launches {by_path['train_ensemble']}; wall per epoch "
            f"(all members, s) {walls[True]} vs member 0 alone "
            f"{walls[False]} ({card})")
        if differ or not files or not n_arrays:
            raise SystemExit(f"the ensemble runner is not the sequential "
                             f"run bit for bit: {differ[:5]}")

    # the sharded sweep over a 4-entry mesh against the unsharded sweep
    cfg = flagship_cfg(seed=SEED)
    model = build_model(cfg, make_modalities(
        cfg.input_dim, cfg.style_dim, cfg.likelihood), device, seed=SEED)
    mesh = data_mesh(4, spread(device, 4))
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    data = {"clinical": torch.randn((B, 7), generator=gen, device=device),
            "rois": torch.randn((B, 444), generator=gen, device=device)}
    sharded_launches = 0
    # 1400 cells split evenly; 1407 cells need one pad cell
    for n_samples in (N_SAMPLES, N_SAMPLES + 1):
        scores = torch.randn((n_samples, B, 7), generator=gen, device=device)
        outs = []
        for fn, extra in ((daa.avatar_sweep, ()),
                          (daa.avatar_sweep_sharded, (mesh,))):
            g = torch.Generator(device=device).manual_seed(SEED + 7)
            fused_daa.KERNEL_LAUNCHES["avatar_sweep"] = 0
            outs.append(fn(model, data, scores, True, g, *extra, cfg))
            if extra:
                sharded_launches += fused_daa.KERNEL_LAUNCHES["avatar_sweep"]
        torch.cuda.synchronize()
        same = (outs[0].shape == outs[1].shape == (B, 7, n_samples, 444)
                and torch.equal(outs[0], outs[1]))
        log("ensemble-slice", f"avatar_sweep_sharded over {mesh} vs "
            f"avatar_sweep, {n_samples * 7} cells: identical={same}")
        if not same:
            raise SystemExit("the sharded sweep differs from the unsharded")
    by_path["daa_sharded"] = {"avatar_sweep": sharded_launches}
    return by_path


# every source under csrc/ and the kernels (entry points) the record lists
SOURCES = ("avatar_sweep", "mopoe_step", "presence_step", "flat_adam",
           "method_step", "generic_step")
KERNELS = SOURCES + ("dp_step", "dp_method_step")
SOURCE_OF = {**{k: k for k in SOURCES}, "dp_step": "mopoe_step",
             "dp_method_step": "method_step"}
# the TPU kernels (bodies) each one replaces on the ported paths
REPLACES = {
    "avatar_sweep": "multivae_tpu/ops/fused_daa.py:54",
    "mopoe_step": "multivae_tpu/ops/fused_step.py:505, "
                  "multivae_tpu/ops/fused_step.py:587, "
                  "multivae_tpu/ops/fused_methods.py:341",
    "presence_step": "multivae_tpu/ops/fused_presence.py:247",
    "method_step": "multivae_tpu/ops/fused_methods.py:341",
    "dp_step": "multivae_tpu/ops/fused_sharded.py:69",
    "dp_method_step": "multivae_tpu/ops/fused_sharded.py:110",
    "generic_step": "multivae_tpu/ops/fused_generic.py:146",
    "flat_adam": "multivae_tpu/ops/fused_step.py:615, "
                 "multivae_tpu/ops/fused_presence.py:287, "
                 "multivae_tpu/ops/fused_methods.py:382"}


def build_phase() -> None:
    """Phase build: every kernel source at once, one nvcc each."""
    from multivae_tpu_torch.ops import _build

    start = time.perf_counter()
    built = _build.build_kernels(SOURCES)
    for name, res in built.items():
        ptxas = [ln.strip() for ln in res.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log("build", f"{name}.cu built in {res.seconds:.2f} s -> "
            f"{res.path.name}; " + " | ".join(ptxas))
    log("build", f"all {len(built)} kernels in "
        f"{time.perf_counter() - start:.2f} s (parallel nvcc)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log("device", f"{name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    build_phase()

    from multivae_tpu_torch.ops.fused_step import full_f32_products

    # the plain versions' products in full float32 while kernels are held
    # to them; the process-wide flag is restored afterwards
    start = time.perf_counter()

    def timed(name, result):
        nonlocal start
        now = time.perf_counter()
        log("time", f"{name} {now - start:.1f} s")
        start = now
        return result

    with full_f32_products():
        max_err, timing = timed("kernel", kernel_check(device))
        entries = {"avatar_sweep": dict(max_abs_err=max_err, **timing)}
        for kname, res in timed("train-kernel",
                                train_kernel_check(device)).items():
            if kname in KERNELS:
                entries[kname] = res
        by_path = {"daa": {"avatar_sweep": timed(
            "slice", slice_run(device, smi))[0]}}
        by_path.update(timed("train-slice", train_slice(device, smi)))
        entries.update(timed("dp-kernel", dp_kernel_check(device)))
        by_path.update(timed("dp-slice", dp_slice(device, smi)))
        by_path.update(timed("ensemble-slice", ensemble_slice(device, smi)))
        entries["generic_step"] = timed("generic-kernel",
                                        generic_kernel_check(device))
        by_path.update(timed("generic-slice", generic_slice(device, smi)))
    for k in KERNELS:
        # each path's own count (set to 0 just before it, read just after)
        # and their sum
        entries[k]["launches_by_path"] = {
            path: counts[k] for path, counts in by_path.items()
            if k in counts}
        entries[k]["launches"] = sum(
            entries[k]["launches_by_path"].values())
        if entries[k]["launches"] < 1:
            raise SystemExit(f"the main paths never launched {k}")

    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda",
        "source": f"multivae_tpu_torch/csrc/{SOURCE_OF[k]}.cu",
        "replaces": REPLACES[k], **{f: entries[k][f] for f in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "launches_by_path")},
        **({"timed_variant": entries[k]["timed_variant"],
            "variants": entries[k]["variants"]}
           if entries[k].get("variants") else {})}
        for k in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
