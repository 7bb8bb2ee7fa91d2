#!/usr/bin/env python3
"""Drive the PyTorch port's `daa` and `train` paths on one CUDA card and
check them.

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
   mod_idx 0 and 1, with and without masks; flat Adam on random state at
   count 0 and 1000 (rtol 1e-6 / atol 1e-8); an 8-step epoch of each
   route (params, mu, nu rtol 1e-4 / atol 1e-5); and times in turns
   plain, kernel, kernel, plain: one step of each method, the Adam pass
   beside ``torch.optim.Adam(fused=True)``, one flagship epoch of device
   work; each kernel's bound from its bytes and operations;
5. slice: ``run_daa`` of a seeded-init flagship model on a numpy cohort
   (n_samples=200, n_validation=2), counting the sweep kernel's launches,
   and a small deterministic DAA on the card against the CPU;
6. train-slice: ``workflows.train_exp`` on a 2100-subject synthetic cohort
   (20 % without ROIs: 5 full + 1 partial complete batches, 1 full + 1
   partial clinical-only batches per epoch) for 5 epochs of joint_elbo
   and 3 epochs each of moe, jsd, poe and poe with dropout_rate=0.2,
   counting each kernel's launches and checking losses, metric families
   and checkpoints; a profiled epoch of each (device busy time);
   ``workflows.daa_exp`` of the trained joint_elbo run; one epoch on the
   card against one on the CPU.

Any failed phase exits non-zero. The last three lines are the JSON record
of the kernels (``launches`` summed over the main paths, each path's own
counts in ``launches_by_path``, ``ms`` that of ``timed_variant``), the
line of ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
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


def check_step(name, ker, ref, names, log_prefix):
    """Hold one step's (metrics, grads) of the kernel to the plain
    version; returns the max abs error over metrics and grads."""
    import torch

    (km, kg), (rm, rg) = ker, ref
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(km).all() and torch.isfinite(kg).all())
    loss_err, loss_bad = close(km[:1], rm[:1], LOSS_RTOL, 0.0)
    m_err, m_bad = close(km, rm, STEP_RTOL, STEP_ATOL)
    worst, bad_tensors = m_err, []
    for tname, (kt, rt) in names(kg, rg):
        err, bad = close(kt, rt, STEP_RTOL, STEP_ATOL)
        worst = max(worst, err)
        if bool(bad.any()):
            bad_tensors.append(f"{tname}({int(bad.sum())}, {err:.2e})")
    ok = (finite and not bool(loss_bad.any()) and not bool(m_bad.any())
          and not bad_tensors)
    log("train-kernel", f"{name} {log_prefix} loss {float(km[0]):.6f} vs "
        f"{float(rm[0]):.6f} (err {loss_err:.2e}), metrics max_abs_err "
        f"{m_err:.2e}, metrics+grads max_abs_err {worst:.3e} "
        f"{'ok' if ok else 'MISMATCH ' + ' '.join(bad_tensors)}")
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
               branch=None):
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

    Any other element outside the bound fails. Returns the max abs error."""
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
    if bool(bad1.any()):
        raise SystemExit(f"{name}: the first step's gradients disagree")
    if bool((outside & ~(trap | branch)).any()):
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


def train_kernel_check(device):
    """Phase train-kernel: every step route and the Adam kernel against
    their plain versions at the flagship widths, 8-step epochs of each
    route, and times (CUDA events, in turns plain, kernel, kernel,
    plain) beside each kernel's bound."""
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
    for route in timed:
        inp = route.inputs(dims, gen, device)
        ker_ms, plain_ms, t = time_pair(
            lambda: route.step("kernel", p, inp, dims, consts),
            lambda: route.step("plain", p, inp, dims, consts), iters=30)
        entry = dict(ms=ker_ms, plain_ms=plain_ms, library_ms=None,
                     **route.bound(p, inp, dims))
        result[route.kernel]["variants"][route.name] = entry
        if headline[route.kernel] == route.name:
            result[route.kernel].update(entry, timed_variant=route.name)
        fl = step_flops(256, route.enc_passes, route.dec_passes)
        log("train-kernel", f"{route.name} B=256: kernel {t[1]:.4f}/"
            f"{t[2]:.4f} ms, plain {t[0]:.4f}/{t[3]:.4f} ms per step; "
            f"bound {entry['bound_ms']:.5f} ms by {entry['bound_by']} "
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
    batches = []
    for route, sizes in ((mopoe, EPOCH_COMPLETE), (presence, EPOCH_PRESENCE)):
        for b in sizes:
            bdims = dims_from(cfg, b)
            batches.append((route, bdims, route.inputs(bdims, gen, device)))

    def epoch(version):
        q, m_, v_ = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
        update = (adam_ops.adam_update if version == "kernel"
                  else adam_ops.adam_update_reference)
        for i, (route, bdims, inp) in enumerate(batches):
            _, gg = route.step(version, q, inp, bdims, consts)
            update(q, m_, v_, gg, i + 1, hyper)

    ker_ms, plain_ms, t = time_pair(lambda: epoch("kernel"),
                                    lambda: epoch("plain"), iters=10)
    n_steps = len(batches)
    result["epoch"] = dict(ms=ker_ms, plain_ms=plain_ms, steps=n_steps)
    log("train-kernel", f"flagship epoch ({n_steps} steps: complete B="
        f"{list(EPOCH_COMPLETE)}, clinical-only B={list(EPOCH_PRESENCE)}): "
        f"kernels {t[1]:.4f}/{t[2]:.4f} ms = "
        f"{n_steps / (ker_ms * 1e-3):.1f} steps/s, plain {t[0]:.4f}/"
        f"{t[3]:.4f} ms = {n_steps / (plain_ms * 1e-3):.1f} steps/s")
    return result


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
    trainer.train_one_epoch(exp, 0, None, trainer.epoch_generator(cfg, 0, 0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        trainer.train_one_epoch(exp, 0, None,
                                trainer.epoch_generator(cfg, 0, 1), 1)
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
    before and after."""
    from multivae_tpu_torch.ops import adam, fused_presence, fused_step

    rec = {"steps": [], "updates": [], "state": None}
    saved = (fused_step.step_flat, fused_presence.presence_step_flat,
             fused_step.adam_update, fused_presence.adam_update)

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

    fused_step.step_flat = recorder("complete", saved[0])
    fused_presence.presence_step_flat = recorder("presence", saved[1])
    fused_step.adam_update = fused_presence.adam_update = update
    try:
        yield rec
    finally:
        (fused_step.step_flat, fused_presence.presence_step_flat,
         fused_step.adam_update, fused_presence.adam_update) = saved


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
        # step_flat(p, x1, x2, ...); presence_step_flat(p, x, noise, dims,
        # consts, learn_scale, mod_idx, ...)
        inputs = ([(1, args[1]), (2, args[2])] if kind == "complete"
                  else [(args[6] + 1, args[1])])
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


def hold_slice_epoch(card, host, dims):
    """Hold the card's epoch to the CPU's (``card``/``host``: the records
    of :func:`recording_train_loop`).

    1. Both runs fed every step the same inputs (batches and noise), bit
       for bit.
    2. Along the card's own trajectory, every step and every Adam update
       is recomputed by the plain versions on the host from the same
       inputs, and held to the step and Adam bounds, every element.
    3. The params after the epoch are held by :func:`hold_epoch`, with the
       params behind the ReLUs of :func:`relu_flips` as its branch."""
    import torch

    from multivae_tpu_torch.ops import adam, fused_presence, fused_step

    same_inputs = len(card["steps"]) == len(host["steps"]) and all(
        ck == hk and all(torch.equal(a, b) if torch.is_tensor(a) else a == b
                         for a, b in zip(ca[1:], ha[1:]))
        for (ck, ca, _), (hk, ha, _) in zip(card["steps"], host["steps"]))
    if not same_inputs:
        raise SystemExit("the card's and the CPU's epochs were fed "
                         "different inputs")
    plain = {"complete": fused_step.step_flat,
             "presence": fused_presence.presence_step_flat}
    worst_step, worst_adam = 0.0, 0.0
    for kind, args, (km, kg) in card["steps"]:
        rm, rg = plain[kind](*args)
        for a, b, rtol, atol in ((km[:1], rm[:1], LOSS_RTOL, 0.0),
                                 (km, rm, STEP_RTOL, STEP_ATOL),
                                 (kg, rg, STEP_RTOL, STEP_ATOL)):
            err, bad = close(a, b, rtol, atol)
            worst_step = max(worst_step, err)
            if bool(bad.any()):
                raise SystemExit(f"a {kind} step of the card's epoch "
                                 f"disagrees with the plain version")
    for before, g, t, hyper, after in card["updates"]:
        st = [x.clone() for x in before]
        adam.adam_update_reference(*st, g, t, hyper)
        for i, (a, b) in enumerate(zip(after, st)):
            err, bad = close(a, b, ADAM_RTOL, ADAM_ATOL)
            if i == 0:
                # 1 - exp(t log b2) cancels ~3 digits at small t, so the
                # card's and the host's exp (1 ulp apart) give updates
                # ~1e-4 apart relative to the update itself
                bad &= (a - b).abs() > 1e-4 * (b - before[0]).abs()
            worst_adam = max(worst_adam, err)
            if bool(bad.any()):
                j = int(torch.argmax((a - b).abs() * bad))
                log("train-slice", f"Adam t={t} {'p mu nu'.split()[i]}: "
                    f"{int(bad.sum())} outside; worst [{j}] card "
                    f"{float(a[j]):.9e} host {float(b[j]):.9e} before "
                    f"{float(before[i][j]):.9e} g {float(g[j]):.9e} "
                    f"mu {float(before[1][j]):.6e} "
                    f"nu {float(before[2][j]):.6e}")
                raise SystemExit("an Adam update of the card's epoch "
                                 "disagrees with the plain version")
    log("train-slice", f"one epoch, card (kernels) vs CPU (plain "
        f"versions): same inputs at all {len(card['steps'])} steps; the "
        f"card's steps recomputed by the plain versions max_abs_err "
        f"{worst_step:.3e}, its {len(card['updates'])} Adam updates "
        f"{worst_adam:.3e}")
    branch, flips = relu_flips(card, host, dims)
    log("train-slice", f"ReLUs that took different branches at the "
        f"rounding level: {flips if flips else 'none'}")
    hold_epoch("train-slice", "params after one epoch, card vs CPU",
               (card["updates"][-1][4][0],), (host["updates"][-1][4][0],),
               [u[1] for u in card["updates"]],
               [u[1] for u in host["updates"]], dims, branch)


def slice_counters():
    from multivae_tpu_torch.ops import (adam, fused_methods, fused_presence,
                                        fused_step)

    return {"mopoe_step": fused_step.KERNEL_LAUNCHES,
            "method_step": fused_methods.KERNEL_LAUNCHES,
            "presence_step": fused_presence.KERNEL_LAUNCHES,
            "flat_adam": adam.KERNEL_LAUNCHES}


def train_and_check(outdir, datadir, device, card, method, rate, epochs,
                    complete, clinical, batching_s):
    """``train_exp`` of one method on the card with every count set to 0
    just before and read just after; checks the launches of its routes, the
    losses, the metric families and the checkpoints. ``outdir`` is the
    run's own (run names have the resolution of a minute). Returns
    ``(run, launches)``."""
    import types

    import pandas as pd
    import torch

    from multivae_tpu_torch.ops import fused_methods, fused_presence

    counters = slice_counters()
    tag = method + (f", dropout {rate}" if rate else "")
    steps = len(complete) + len(clinical)
    for c in counters.values():
        for k in c:
            c[k] = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    run, walls = train_run(datadir, outdir, epochs, "cuda", method=method,
                           dropout_rate=rate)
    total = time.perf_counter() - start
    launches = {k: c[k] for k, c in counters.items()}
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
        == (len(complete) * epochs if mopoe else 0),
        "method_step launches": launches["method_step"]
        == (0 if mopoe else len(complete) * epochs),
        "presence_step launches": launches["presence_step"]
        == len(clinical) * epochs,
        "flat_adam launches = steps": launches["flat_adam"]
        == steps * epochs,
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
    log("train-slice", f"[{tag}] train_exp {epochs} epochs x {steps} steps"
        f" in {total:.3f} s (set-up included); launches {launches}; "
        f"mean train loss epoch 1 {first:.3f} -> epoch {epochs} "
        f"{last:.3f}; checks "
        + ", ".join(f"{k}={v}" for k, v in checks.items()))
    log("train-slice", f"[{tag}] train wall per epoch (train + test + "
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
                if any(s in k for s in ("gemm", "latent", "colsum",
                                        "colreduce", "metrics_kernel",
                                        "flat_adam"))}
        log("train-slice", f"[{tag}] profiled training epoch: wall "
            f"{ep_wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
            f"(idle share {100 * (1 - busy / (ep_wall * 1e3)):.1f} %) ="
            f" {steps / (busy * 1e-3):.1f} device steps/s; hand "
            f"kernels {sum(ours.values()):.3f} ms; top: "
            + ", ".join(f"{k[:40]} {v:.3f}" for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:6]))
    else:
        log("train-slice", f"[{tag}] profiled training epoch: wall "
            f"{ep_wall * 1e3:.3f} ms; device time not measured (the "
            f"profiler recorded no device events)")
    return run, launches


def train_slice(device, card: str):
    """Phase train-slice: ``workflows.train_exp`` on the card at the
    flagship width for joint_elbo, moe, jsd, poe and poe with dropout, then
    ``daa_exp`` of the trained joint_elbo run, then one epoch on the card
    against one epoch on the CPU (the plain versions). Returns each train
    run's launches, ``{path: {kernel: count}}``."""
    from multivae_tpu_torch import workflows
    from multivae_tpu_torch.data import make_synthetic_cohort

    with tempfile.TemporaryDirectory() as root:
        datadir = os.path.join(root, "data")
        make_synthetic_cohort(datadir, n_subjects=SLICE_SUBJECTS,
                              n_scores=7, n_rois=444, missing_rate=0.2,
                              seed=SEED, signal_strength=2.0)
        complete, clinical, batching_s = epoch_batch_counts(datadir)
        log("train-slice", f"cohort {SLICE_SUBJECTS} subjects: complete "
            f"batches {complete}, clinical-only batches {clinical}; host "
            f"batching (sampler + gather + scaling) {batching_s:.4f} s "
            f"per epoch")
        if (complete != sorted(EPOCH_COMPLETE)
                or clinical != sorted(EPOCH_PRESENCE)):
            raise SystemExit("unexpected epoch batches")

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


KERNELS = ("avatar_sweep", "mopoe_step", "presence_step", "flat_adam",
           "method_step")
# the TPU kernels (bodies) each one replaces on the ported paths
REPLACES = {
    "avatar_sweep": "multivae_tpu/ops/fused_daa.py:54",
    "mopoe_step": "multivae_tpu/ops/fused_step.py:505, "
                  "multivae_tpu/ops/fused_step.py:587, "
                  "multivae_tpu/ops/fused_methods.py:341",
    "presence_step": "multivae_tpu/ops/fused_presence.py:247",
    "method_step": "multivae_tpu/ops/fused_methods.py:341",
    "flat_adam": "multivae_tpu/ops/fused_step.py:615, "
                 "multivae_tpu/ops/fused_presence.py:287, "
                 "multivae_tpu/ops/fused_methods.py:382"}


def build_phase() -> None:
    """Phase build: every kernel source at once, one nvcc each."""
    from multivae_tpu_torch.ops import _build

    start = time.perf_counter()
    built = _build.build_kernels(KERNELS)
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
    with full_f32_products():
        max_err, timing = kernel_check(device)
        entries = {"avatar_sweep": dict(max_abs_err=max_err, **timing)}
        for kname, res in train_kernel_check(device).items():
            if kname in KERNELS:
                entries[kname] = res
        by_path = {"daa": {"avatar_sweep": slice_run(device, smi)[0]}}
        by_path.update(train_slice(device, smi))
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
        "source": f"multivae_tpu_torch/csrc/{k}.cu",
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
