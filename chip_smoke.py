#!/usr/bin/env python3
"""Drive the PyTorch port's `daa` and `train` paths (unsharded,
data-parallel, ensemble, deep-architecture, tensor-parallel, traced, and
resumed from the JAX package's checkpoints) on one CUDA card and check
them.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA Hopper card (the kernels are built for sm_90a) and the CUDA
toolkit's ``nvcc``; it imports nothing of JAX. Flagship widths
throughout: clinical 7, ROIs 444, hidden 256, latent 20, style [3, 20].
Phases, one line or more each:

1. device: the card's name and power limit;
2. build: every ``multivae_tpu_torch/csrc/*.cu`` at once (one nvcc each),
   with ptxas' registers and spills;
3. kernel: the avatar-sweep kernel against its plain PyTorch version
   (atol = rtol = 1e-4), four methods with and without sampled latents, at
   B=50 and 200 x 7 cells (the flagship round), B=37 x 3 cells, B=7 x 2
   cells (fewer rows than a tile), 1407 cells, hidden 1024 (the weights
   staged in chunks) and a 4099-wide decoder (chunked, scalar stores), each
   with its plan; the flagship and hidden-1024 sweeps at two grid sizes (the
   SM count and 7: equal bits); the flagship sweep timed by CUDA graph
   replay and by events around back-to-back calls, kernel and plain;
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
   beside ``torch.optim.Adam(fused=True)`` (both also by CUDA graph replay,
   which the host's enqueue rate does not set), one flagship epoch of device
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
   over a 4-entry mesh against the unsharded sweep (identical), both timed
   for one flagship round;
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
   the same function on the CPU from the same noise;
12. eval-slice: ``train_exp`` of joint_elbo on the train-slice cohort for 4
   epochs with ``calc_nll``, ``calc_prd``, ``calc_clf``, ``calc_coherence``
   (``eval_freq`` = ``eval_freq_fid`` = 2) and ``save_samples``: the step
   kernels' launches (the cadence runs plain torch and launches none), the
   Likelihoods, PRD, Latent Representation and Generation families at
   epochs 2 and 4, the ``fid/`` dump's groups, and each cadence hit's
   host-clock seconds by part; ``eval_exp`` of the last checkpoint on the
   card and on the CPU with the same noise, every row held to the other
   (IWAE relative 1e-4, PRD absolute 0.01, accuracies and coherences equal
   or each differing prediction within 1e-3 of its classifier's boundary)
   with the wall of each command and part; ``daa_exp`` of the trained run
   with the full, stats-only and sampled artifacts from one seed (2 rounds,
   B=50, P=200, likelihood strategy): the sampled ROI indices, the sampled
   avatars against the full artifact's columns and the sampled p-values
   and coefs against stats-only (bit for bit), and the wall per round of
   each mode.
13. analysis-slice, on the eval slice's run and its daa copies:
   ``avatar_plot_exp`` (its traverse, ``avatar_traverse``: 4 subjects, 20
   frames x 7 scores at the latent means) with one ``avatar_sweep`` launch
   and no other kernel, the kernel's inputs recorded from that run and
   held against the plain version through the wrapper's CPU route (atol =
   rtol = 1e-4, the frames too), the traverse's plan and its launch timed
   by CUDA graph replay beside the plain version on the card, the GIF and
   a 20-frame AVI; ``rsa_exp`` on the card against the CPU (latent
   dissimilarities rtol = atol = 1e-5, Kendall taus and p-values 1e-4
   absolute); ``anova_exp``; the robustness counts of the full and the
   stats-only run, equal; ``analyze_avatars`` of the full and the sampled
   run; ``univariate_tests`` with the ROI blocks the synthetic cohort's
   first three scores drive significant; ``hist_plot_exp``, the two
   ``daa-plot`` commands (one on a synthetic surface atlas file) and
   ``rsa_plot_exp``. Where the host lacks matplotlib or PIL, one line
   names the renderers not run, and ``avatar_traverse``,
   ``robustness_counts`` and ``univariate_pvalues`` run in their place.
14. bf16-kernel: the bfloat16 instances of the three persistent step
   kernels (``precision="bfloat16"``, the TPU kernels' ``matmul_bf16``;
   ``multivae_tpu_torch/ops/bf16.py`` names the rounding schemes): ptxas'
   registers and spills per instance and the count of bf16 ``HMMA``
   instructions in each instance's SASS (``cuobjdump --dump-sass``: above 0
   in every bf16 instance, 0 in the f32 ones); every route of train-kernel
   in bf16 (one-step launches at B=256, the complete routes at 64, the
   presence routes at 164) against the plain bf16 version on the card by
   the ratio rule: per metric and per gradient tensor, the kernel's
   distance from the plain bf16 version at most 0.1 x the plain bf16
   version's distance from the plain f32 version (or, where bf16 moves a
   value by float32 round-off only, within 1e-5 of its size); where a
   tensor is outside the rule, its elements more than float32 noise and at
   most two bfloat16 steps from the plain value (rounding ties that two
   float32 sums put on either side of a bfloat16 boundary), at most 10 %
   of a tensor of 256 elements or more, are counted, printed and left out
   of its ratio, and a tensor of fewer than 256 elements (a bias, an
   output scale, a metric) outside the rule holds within two bfloat16
   steps everywhere;
   every route's 8-step launch bit-equal to its one-step launches with
   ``flat_adam`` (the method routes at B=64 too); the row-slice entry
   points of the complete routes over 4 shards (each shard by the ratio
   rule, the whole-batch slice bit-equal to the unsharded launch); f32 and
   bf16 times per step side by side (one-step launches by CUDA events, in
   turns plain bf16, f32, bf16, bf16, f32, plain bf16; per step in a
   6-step launch) with each bf16 bound (tensor-core products at 989
   TFLOP/s, scheme B's backward products at 67 TFLOP/s, bytes at 3.35
   TB/s);
15. bf16-slice: the flagship trained with ``precision="bfloat16"`` through
   ``MultimodalExperiment`` and ``trainer.run_epochs`` on the train slice's
   cohort: joint_elbo 3 epochs and a fourth by ``workflows.resume_exp``,
   poe with dropout 0.2 3 epochs, joint_elbo and poe with dropout at
   ``data_parallel=4`` 1 epoch; each with its launches per kernel and instance (the bf16
   instances on every route of the JAX package's bf16 table, f32 on the
   data-parallel remainder groups), each epoch's mean train loss beside an
   f32 run from the same seed (within 5 %), the wall per epoch, a profiled
   epoch's busy time and idle share, and a first epoch recorded on the
   card and held step by step by the plain versions on the host (the
   ratio rule for bf16 steps, the step bounds for f32 ones, the Adam
   bound);
16. tp-slice: ``train_exp`` at ``tensor_parallel=4`` and at 2 x 2 (tensor x
   data) on the train slice's cohort, 2 epochs each: every batch on the
   tensor-parallel step (``parallel/tensor.py``, Megatron layers in plain
   torch over the ``("data", "tensor")`` mesh), ``flat_adam`` once a step
   and no step kernel; every step recomputed from the state before it by
   the plain single-entry step (autograd of the model on the whole batch)
   and held to it: the loss at rtol 1e-5, the metrics at rtol 1e-4 / atol
   1e-5, each tensor's gradient within a relative L2 distance of 1e-3;
17. dp-general-slice: ``train_exp(data_parallel=4)`` of deep-A and of the
   four-block ``joint_elbo`` (configs the method step does not take) and
   of the flagship with ``fused_training=False``, 2 epochs each: every
   batch on the data-parallel general step, held as in phase 16;
18. profile-slice: ``train --profile-dir`` through the CLI (2 epochs of
   the flagship): the first epoch's Chrome trace holds each of that
   epoch's two ``mopoe_steps_kernel`` and two ``presence_steps_kernel``
   launches, with each kernel's device ms from the trace and how many of
   the tracer's warm-up kernels it kept;
19. jax-checkpoint-slice: a flagship run directory in the JAX package's
   layout (``model`` and ``opt_state`` written by this script's own
   msgpack writer, :func:`flax_msgpack_bytes`) and the same run as the
   port's ``.npz``: ``daa_exp`` of each on the card (the sweep kernel) and
   one resumed epoch of each (the step kernels), equal bit for bit;
20. pipeline-slice: the GPipe schedule of the pipelined MLP (S = 4 stages
   on the card's entries, M = 8 microbatches, 444 -> 512 x 4 -> 7, batch
   256) against the sequential loss and its gradients, and the walls of
   a pipelined and a sequential SGD step.

The meshes of phases 7-9 and 16-20 start at card 0 and wrap at the card count, so one
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
import shutil
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
    """Mean milliseconds per call of ``fn`` on the card (CUDA events around
    back-to-back calls: for a short kernel this is the host's enqueue rate
    of its wrapper, not the kernel's time)."""
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


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` calls captured in
    one CUDA graph (a ctypes launch on the capturing stream is captured
    too), the graph replayed ``replays`` times between CUDA events, so the
    wrapper's Python cost is not in the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    torch.cuda.empty_cache()
    return ms


def flagship_cfg(method="joint_elbo", **kw):
    from multivae_tpu_torch.train.config import Config

    return Config(**{**FLAGSHIP, "method": method, **kw}).derive()


def sweep_setup(device, gen, method, b, n_cells=None, **cfg_kw):
    """Seeded sweep inputs ``(sp, post, cdata, eps, dims)``: the flagship
    round's cell grid (``N_SAMPLES`` x 7 cells), or ``n_cells`` random
    perturbed blocks; ``cfg_kw`` changes the widths."""
    import torch

    from multivae_tpu_torch.models import build_model, make_modalities
    from multivae_tpu_torch.ops import fused_daa
    from multivae_tpu_torch.params import dims_from, model_split_params

    cfg = flagship_cfg(method, **cfg_kw)
    model = build_model(cfg, make_modalities(
        cfg.input_dim, cfg.style_dim, cfg.likelihood), device, seed=SEED)
    dims = dims_from(cfg, b)
    clinical = torch.randn((b, dims.d1), generator=gen, device=device)
    rois = torch.randn((b, dims.d2), generator=gen, device=device)
    if n_cells is None:
        scores = torch.randn((N_SAMPLES, b, dims.d1), generator=gen,
                             device=device)
        cdata = fused_daa.build_cell_grid(clinical, scores)
    else:
        cdata = torch.randn((n_cells, b, dims.d1), generator=gen,
                            device=device)
    eps = torch.randn((cdata.shape[0], b, dims.cd + dims.s2), generator=gen,
                      device=device)
    return (model_split_params(model, dims),
            fused_daa.rois_posteriors(model, rois), cdata, eps, dims)


def hold_sweep(label, inputs, method, sample, n_blocks=None):
    """One kernel launch against the plain version (atol = rtol = 1e-4);
    returns ``(avatars, max_abs_err)``."""
    import torch

    from multivae_tpu_torch.ops import fused_daa

    sp, post, cdata, eps, dims = inputs
    ker = fused_daa._launch_sweep(sp, post, cdata, eps, dims, sample, method,
                                  n_blocks=n_blocks)
    ref = fused_daa.sweep_cells_reference(sp, post, cdata, eps, dims, sample,
                                          method)
    torch.cuda.synchronize()
    err = float((ker - ref).abs().max())
    ok = bool(torch.isfinite(ker).all()) and torch.allclose(
        ker, ref, rtol=RTOL, atol=ATOL)
    log("kernel", f"{label} {method:10s} sample_latents={sample!s:5s} "
        f"cells={cdata.shape[0]} B={dims.b} rows={cdata.shape[0] * dims.b} "
        f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit(f"kernel disagrees with the plain version ({label}, "
                         f"{method}, sample_latents={sample})")
    return ker, err


def kernel_check(device):
    """Phase kernel: the avatar sweep vs its plain version, all methods and
    both branches at the flagship round, at its edges (rows fewer than a
    tile, a ragged last tile, chunked weights, a wide decoder), equal bits
    at two grid sizes, and timed."""
    import torch

    from multivae_tpu_torch.ops import fused_daa

    gen = torch.Generator(device=device).manual_seed(SEED)
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    max_err, timing = 0.0, None
    # (label, B, cells (None: the flagship grid of N_SAMPLES x 7), widths,
    #  methods); every method takes both branches
    cases = [
        ("flagship", B, None, {}, fused_daa.METHODS),
        ("B=37 x 3 cells", 37, 3, {}, fused_daa.METHODS),
        ("B=7 x 2 cells (one partial tile)", 7, 2, {}, ("joint_elbo", "jsd")),
        ("1407 cells", B, 1407, {}, fused_daa.METHODS),
        ("hidden 1024 (chunked)", B, 1400, dict(hidden_dim=1024),
         fused_daa.METHODS),
        ("d2 4099 (chunked, scalar stores)", 37, 21,
         dict(input_dim=[7, 4099]), ("moe", "poe")),
    ]
    for label, b, n_cells, widths, methods in cases:
        for method in methods:
            inputs = sweep_setup(device, gen, method, b, n_cells, **widths)
            dims = inputs[4]
            if method == methods[0]:
                plan = fused_daa.sweep_plan(dims, n_sms,
                                            inputs[2].shape[0] * b)
                log("kernel", f"{label}: plan {plan._asdict()}")
            for sample in (True, False):
                _, err = hold_sweep(label, inputs, method, sample)
                max_err = max(max_err, err)
            if method != "joint_elbo" or label not in (
                    "flagship", "hidden 1024 (chunked)"):
                continue
            # the same inputs at two grid sizes: equal bits
            outs = [hold_sweep(f"{label} grid {g}", inputs, method, True,
                               n_blocks=g)[0] for g in (n_sms, 7)]
            same = torch.equal(outs[0], outs[1])
            log("kernel", f"{label}: grid {n_sms} vs grid 7 equal bits "
                f"{same}")
            if not same:
                raise SystemExit("the sweep's bits depend on the grid")
            if label != "flagship":
                continue
            sp, post, cdata, eps, dims = inputs

            def run_ker():
                fused_daa.sweep_cells(sp, post, cdata, eps, dims, True,
                                      method=method)

            def run_ref():
                fused_daa.sweep_cells_reference(sp, post, cdata, eps, dims,
                                                True, method)
            # in turns on one card: plain, kernel, kernel, plain; events
            # around back-to-back calls, then CUDA graph replays
            t = [cuda_ms(run_ref), cuda_ms(run_ker), cuda_ms(run_ker),
                 cuda_ms(run_ref)]
            g = [graph_ms(run_ref, 10), graph_ms(run_ker, 20),
                 graph_ms(run_ker, 20), graph_ms(run_ref, 10)]
            # each input read once, the avatars written once; the
            # clinical encoder (content heads) and the ROI decoder per
            # row of every cell
            rows = cdata.shape[0] * b
            used = [sp[k] for k in sp if k.startswith(("enc1_Wh",
                    "enc1_bh", "enc1_Wc", "enc1_bc", "dec2_W",
                    "dec2_bd"))]
            out_bytes = rows * dims.d2 * 4
            flops = 2.0 * rows * (dims.d1 * dims.h + 2 * dims.h * dims.cd
                                  + (dims.s2 + dims.cd) * dims.d2)
            # one traced launch: each phase's SM cycles per tile (thread 0
            # of every block, barrier to barrier), and the products' FMAs
            # per cycle against the SM's 128 f32 lanes
            clocks = torch.zeros((n_sms, len(fused_daa.SWEEP_PHASES)),
                                 dtype=torch.int64, device=device)
            fused_daa._launch_sweep(sp, post, cdata, eps, dims, True, method,
                                    phase_clocks=clocks)
            torch.cuda.synchronize()
            per_tile = (clocks[:plan.grid].sum(0).double()
                        / -(-rows // plan.rows)).tolist()
            fmas = {"hidden": dims.d1 * dims.h,
                    "heads": 2 * dims.cd * dims.h,
                    "decoder": (dims.s2 + dims.cd) * dims.d2}
            phases = dict(zip(fused_daa.SWEEP_PHASES, per_tile))
            log("kernel", "flagship sweep, SM cycles per tile of "
                f"{plan.rows} rows (one traced launch): " + ", ".join(
                    f"{k} {v:.0f} ({100 * v / sum(per_tile):.1f} %"
                    + (f"; {100 * plan.rows * fmas[k] / v / 128:.1f} % of "
                       f"the f32 FMA rate" if k in fmas else "") + ")"
                    for k, v in phases.items()))
            timing = dict(
                ms=(g[1] + g[2]) / 2, plain_ms=(g[0] + g[3]) / 2,
                phase_cycles_per_tile=phases,
                ms_events=(t[1] + t[2]) / 2,
                plain_ms_events=(t[0] + t[3]) / 2, library_ms=None,
                plan=plan._asdict(),
                **bound(nbytes(cdata, eps, *post, *used) + out_bytes, flops))
            log("kernel", f"joint_elbo sampled, {cdata.shape[0]} cells: "
                f"kernel {g[1]:.4f}/{g[2]:.4f} ms by graph replay "
                f"({t[1]:.4f}/{t[2]:.4f} by events around back-to-back "
                f"calls), plain {g[0]:.4f}/{g[3]:.4f} ms by graph replay "
                f"({t[0]:.4f}/{t[3]:.4f} by events); bound "
                f"{timing['bound_ms']:.5f} ms by {timing['bound_by']} = "
                f"{100 * timing['bound_ms'] / timing['ms']:.1f} % of the "
                f"kernel's time; {flops / (timing['ms'] * 1e-3) / 1e12:.2f} "
                f"TFLOP/s, {out_bytes / (timing['ms'] * 1e-3) / 1e12:.3f} "
                f"TB/s of avatars")
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
    ``mopoe``, ``method`` or ``presence``; ``bf16`` takes the bfloat16
    branch of both (the kernel's bfloat16 instance)."""

    def __init__(self, kind, method="joint_elbo", mod_idx=None,
                 masked=False, bf16=False):
        self.kind, self.method = kind, method
        self.mod_idx, self.masked = mod_idx, masked
        self.bf16 = bf16
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
        if bf16:
            tag.append("bf16")
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
        bf16 = self.bf16
        if version == "kernel":
            if self.kind == "mopoe":
                return fs.step_flat(p, x1, x2, *fs.split_noise(noise, dims),
                                    dims, consts, learn_scale, bf16)
            if self.kind == "method":
                return fm.method_step_flat(self.method, p, x1, x2, noise,
                                           dims, consts, learn_scale, masks,
                                           bf16)
            return fp.presence_step_flat(p, x, noise, dims, consts,
                                         learn_scale, self.mod_idx,
                                         self.method, masks, bf16)
        sp = flat_views(p, dims)
        if self.kind == "mopoe":
            _, m, g = fs.fwd_bwd_reference(
                sp, x1, x2, *fs.split_noise(noise, dims), dims, consts,
                learn_scale, bf16=bf16)
        elif self.kind == "method":
            _, m, g = fm.method_fwd_bwd_reference(
                self.method, sp, x1, x2, noise, dims, consts, learn_scale,
                masks, bf16=bf16)
        else:
            _, m, g = fp.presence_fwd_bwd_reference(
                sp, x, noise, dims, consts, learn_scale, self.mod_idx,
                self.method, masks, bf16)
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
                                 consts, hyper, True, phase_times, self.bf16)
        if self.kind == "method":
            return fm.method_epoch_flat(self.method, p, mu, nu, count, x1s,
                                        x2s, noises, dims, consts, hyper,
                                        True, masks, phase_times, self.bf16)
        xs = x1s if self.mod_idx == 0 else x2s
        return fp.presence_epoch_flat(p, mu, nu, count, xs, noises, dims,
                                      consts, hyper, True, self.mod_idx,
                                      self.method, masks, phase_times,
                                      self.bf16)

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
            return fs.launch_geometry(dims, device, self.bf16)
        if self.kind == "method":
            return fm.launch_geometry(dims, device, self.method, self.masked,
                                      self.bf16)
        return fp.launch_geometry(dims, device, self.mod_idx, self.method,
                                  self.masked, self.bf16)

    def slice_step(self, version, p, inp, local, consts, learn_scale,
                   row_offset, b_total):
        """``(metrics, grads)`` (flat, partial sums) of one step on a row
        slice by the kernel's row-slice entry point or the plain version;
        ``inp`` holds the slice's rows, ``local.b`` of them."""
        from multivae_tpu_torch.ops import fused_methods as fm
        from multivae_tpu_torch.ops import fused_step as fs
        from multivae_tpu_torch.params import flat_views, flatten_split

        x1, x2, noise, masks = inp
        bf16 = self.bf16
        if version == "kernel":
            if self.kind == "mopoe":
                return fs.slice_step_flat(
                    p, x1, x2, *fs.split_noise(noise, local), local, consts,
                    learn_scale, row_offset, b_total, bf16)
            return fm.slice_method_step_flat(
                self.method, p, x1, x2, noise, local, consts, learn_scale,
                masks, row_offset, b_total, bf16)
        sp = flat_views(p, local)
        if self.kind == "mopoe":
            _, m, g = fs.fwd_bwd_reference(
                sp, x1, x2, *fs.split_noise(noise, local), local, consts,
                learn_scale, row_offset, b_total, bf16)
        else:
            _, m, g = fm.method_fwd_bwd_reference(
                self.method, sp, x1, x2, noise, local, consts, learn_scale,
                masks, row_offset, b_total, bf16)
        return m, flatten_split(g)

    def moved_bytes(self, p, inp, dims) -> int:
        """The bytes one step must move, from this run's tensors: the
        params it reads, its batch, noise and masks in, every gradient and
        the metrics out."""
        from multivae_tpu_torch.params import flat_views

        x1, x2, noise, masks = inp
        read = nbytes(*[v for k, v in flat_views(p, dims).items()
                        if self.mod_idx is None
                        or k[3] == str(self.mod_idx + 1)])
        xs = (x1, x2) if self.mod_idx is None else (
            (x1,) if self.mod_idx == 0 else (x2,))
        return read + nbytes(*xs, noise, masks) + nbytes(p) + 4 * 19

    def bound(self, p, inp, dims) -> dict:
        """The step's bound from this run's tensors: :meth:`moved_bytes`
        and the operations of its passes (the bfloat16 branch's:
        :func:`bf16_bound`)."""
        n_bytes = self.moved_bytes(p, inp, dims)
        if self.bf16:
            return bf16_bound(self, n_bytes, dims.b)
        return bound(n_bytes, step_flops(dims.b, self.enc_passes,
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


def time_flat_adam(p0, gen, hyper, device) -> dict:
    """``flat_adam`` in place on one state, beside torch's fused Adam on one
    flat parameter (the library call; the port never calls it): events
    around back-to-back calls in turns plain, kernel, kernel, plain, then
    the kernel and the library call in CUDA graph replays -- their device
    time, which the host's enqueue rate sets in the event times (the plain
    version builds its step count on the host: events only; the library's
    step is captured with its count on the card)."""
    import torch

    from multivae_tpu_torch.ops import adam as adam_ops

    q = p0.clone()
    mu, nu = torch.zeros_like(q), torch.zeros_like(q)
    g = torch.randn(q.numel(), generator=gen, device=device) * 1e-3
    r = p0.clone()
    rmu, rnu = torch.zeros_like(r), torch.zeros_like(r)

    def run_ker():
        adam_ops.adam_update(q, mu, nu, g, 1, hyper)

    def run_ref():
        adam_ops.adam_update_reference(r, rmu, rnu, g, 1, hyper)

    def library(capturable):
        lib_p = torch.nn.Parameter(p0.clone())
        lib_p.grad = g.clone()
        return torch.optim.Adam([lib_p], lr=hyper.lr,
                                betas=(hyper.b1, hyper.b2), eps=hyper.eps,
                                fused=True, capturable=capturable)

    t = [cuda_ms(run_ref, 50), cuda_ms(run_ker, 50), cuda_ms(run_ker, 50),
         cuda_ms(run_ref, 50)]
    lib_ev_ms = cuda_ms(library(False).step, 50)
    gt = [graph_ms(run_ker, 50), graph_ms(run_ker, 50)]
    lib_ms = graph_ms(library(True).step, 50)
    out = dict(ms=(gt[0] + gt[1]) / 2, plain_ms=(t[0] + t[3]) / 2,
               library_ms=lib_ms, ms_events=(t[1] + t[2]) / 2,
               library_ms_events=lib_ev_ms,
               **bound(nbytes(q, mu, nu, g) + nbytes(q, mu, nu),
                       12.0 * q.numel()))
    log("train-kernel", f"flat_adam n={q.numel()}: kernel {gt[0]:.4f}/"
        f"{gt[1]:.4f} ms by graph replay ({t[1]:.4f}/{t[2]:.4f} by events "
        f"around back-to-back calls), plain {t[0]:.4f}/{t[3]:.4f} by "
        f"events, torch.optim.Adam(fused=True) {lib_ms:.4f} by graph replay "
        f"(capturable; {lib_ev_ms:.4f} by events, not capturable) ms per "
        f"update in place; bound {out['bound_ms']:.5f} ms by "
        f"{out['bound_by']} = {100 * out['bound_ms'] / out['ms']:.1f} % of "
        f"the kernel's graph-replay time")
    return out


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

    result["flat_adam"].update(time_flat_adam(p0, gen, hyper, device))

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
# stacks past four hidden layers, as the JAX kernel takes them (its VMEM
# guard): at hidden 128 5 + 1 and 6 + 6, at hidden 64 8 + 8
DEEP_STACKS = {"5+1": (5, 1, 128), "6+6": (6, 6, 128), "8+8": (8, 8, 64)}
ALL_ARCHS = {**DEEP_ARCHS, "1+0": FLAT_ARCH, **{
    arch: dict(num_hidden_layer_encoder=n_enc, num_hidden_layer_decoder=n_dec,
               learn_output_sample_scale=False)
    for arch, (n_enc, n_dec, _) in DEEP_STACKS.items()}}
VARIANTS = {"laplace": dict(likelihood="laplace"),
            "bernoulli": dict(likelihood="bernoulli"),
            "categorical": dict(likelihood="categorical"),
            "unfactorized": dict(factorized_representation=False)}
VARIANT_ARCHS = ("1+0", "deep-A")


def generic_flops(dims, enc_passes: int, dec_passes: int) -> float:
    """Matmul FLOPs one layer-stack step needs: per row, modality and pass,
    4 per multiply-add of an encoder's first layer (forward and weight
    gradient: nothing takes the gradient of the data) and 6 per
    multiply-add of every other product (forward, weight gradient, the
    gradient of its input)."""
    per_row = 0
    for d, s in zip(dims.ds, dims.ss):
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


def rounding_level_units(method, p, inp, dims, consts, uni=True):
    """Hidden units of the layer stacks that may take either ReLU branch at
    the rounding level: in some row the unit's input, computed by the plain
    version in float64, is within ``ROUNDING`` of zero relative to the sum
    of its terms' sizes, so two float32 sums in different orders can land
    on different sides. ``inp``: the M batches, the noise and the masks.
    Returns the mask of the gradient elements behind such units (the unit's
    own input weights and bias, every layer below it in its network and,
    below a decoder, the encoders) and their description."""
    import torch

    from multivae_tpu_torch.ops import fused_generic as fg
    from multivae_tpu_torch.ops import latent_multi
    from multivae_tpu_torch.ops.fused_methods import latent_fwd_bwd
    from multivae_tpu_torch.params import flat_views

    inp = [None if t is None else t.double() for t in inp]
    xs, noise, masks = inp[:dims.m], inp[dims.m], inp[dims.m + 1]
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
    nets = Recording(flat_views(p.double(), dims), xs, dims, True, masks)
    if fg.multi_latents(method, dims, uni):
        latent_multi.latent_fwd_bwd(method, nets, noise, dims.b, dims.cd,
                                    dims.ss, consts, uni)
    else:
        latent_fwd_bwd(method, nets, noise, dims.b, dims.cd, dims.s1,
                       dims.s2, consts)
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
    plain version, and the noise and masks it takes. ``mods`` (a dict of
    ``input_dim`` and ``style_dim``, and ``hidden_dim`` where it is not
    the flagship's) gives a modality count other than the flagship's two;
    ``uni`` False is poe without its unimodal ELBOs. A step's inputs are
    ``(x_1 .. x_M, noise, masks)``."""

    kernel = "generic_step"

    def __init__(self, arch: str, method="joint_elbo", masked=False,
                 variant=None, mods=None, label=None, uni=True):
        self.arch, self.method, self.masked = arch, method, masked
        self.variant = variant
        self.uni = bool(uni) or method != "poe"
        self.cfg_kw = {**ALL_ARCHS[arch], **VARIANTS.get(variant, {}),
                       **(mods or {})}
        self.likelihood = self.cfg_kw.get("likelihood", "normal")
        self.name = (f"generic_step[{label + ' ' if label else ''}{arch}, "
                     + (f"{variant}, " if variant else "") + method
                     + ("" if self.uni else " without unimodal ELBOs")
                     + (", masks" if masked else "") + "]")
        poe = method == "poe" and self.uni
        self.dec_passes = 2 if poe else 1
        self.enc_passes = 2 if poe and masked else 1

    def setup(self, device, b: int, seed: int):
        """Seeded params (flat, the general layout) and the dims."""
        from multivae_tpu_torch.models import build_model, make_modalities
        from multivae_tpu_torch.params import generic_dims, model_flat_params

        cfg = flagship_cfg(self.method, seed=seed, **self.cfg_kw)
        model = build_model(cfg, make_modalities(
            cfg.input_dim, cfg.style_dim, cfg.likelihood), device, seed=seed)
        dims = generic_dims(cfg, b)
        return dims, model_flat_params(model, dims)

    def inputs(self, dims, gen, device, steps=None):
        import torch

        from multivae_tpu_torch.ops import fused_generic as fg
        from multivae_tpu_torch.ops import latent_multi

        lead = () if steps is None else (steps,)
        b = dims.b

        def randn(*shape):
            return torch.randn(lead + shape, generator=gen, device=device)

        w = latent_multi.noise_width(self.method, dims.cd, dims.ss,
                                     self.uni)
        xs = [randn(b, d) for d in dims.ds]
        noise = randn(b, w)
        if self.likelihood == "bernoulli":  # the cohort thresholded at 0
            xs = [(x > 0).float() for x in xs]
        elif self.likelihood == "categorical":  # one-hot rows
            xs = [torch.nn.functional.one_hot(torch.randint(
                0, d, lead + (b,), generator=gen, device=device), d).float()
                for d in dims.ds]
        masks = None
        if self.masked:
            n = fg.n_dropout_masks(self.method, MASK_RATE, dims.n_enc,
                                   dims.n_dec, dims.m, self.uni)
            keep = torch.rand(lead + (n, b, dims.h), generator=gen,
                              device=device) < 1 - MASK_RATE
            masks = keep.float() / (1 - MASK_RATE)
        return (*xs, noise, masks)

    def step(self, version, p, inp, dims, consts, learn_scale=True):
        from multivae_tpu_torch.ops import fused_generic as fg
        from multivae_tpu_torch.params import flat_views, flatten_named

        xs, noise, masks = inp[:dims.m], inp[dims.m], inp[dims.m + 1]
        if version == "kernel":
            return fg.generic_step_flat(self.method, p, xs, noise, dims,
                                        consts, learn_scale, masks,
                                        unimodal_elbos=self.uni)
        _, m, g = fg.generic_fwd_bwd_reference(
            self.method, flat_views(p, dims), xs, noise, dims, consts,
            learn_scale, masks, unimodal_elbos=self.uni)
        return m, flatten_named(g, dims)

    def launch_epoch(self, p, mu, nu, count, stacks, dims, consts, hyper,
                     phase_times=None):
        """A group of steps with their Adam updates in ONE launch of the
        persistent kernel, as :meth:`Route.launch_epoch`."""
        from multivae_tpu_torch.ops import fused_generic as fg

        xs, noises, masks = (stacks[:dims.m], stacks[dims.m],
                             stacks[dims.m + 1])
        return fg.generic_epoch_flat(self.method, p, mu, nu, count, xs,
                                     noises, dims, consts, hyper, True, masks,
                                     None, phase_times,
                                     unimodal_elbos=self.uni)

    def phases(self, dims):
        from multivae_tpu_torch.ops import fused_generic as fg

        return fg.phases(dims)

    def geometry(self, dims, device):
        from multivae_tpu_torch.ops import fused_generic as fg

        return fg.launch_geometry(dims, device, self.method, self.masked,
                                  self.uni)

    def excuse(self, p, inp, dims, consts):
        return rounding_level_units(self.method, p, inp, dims, consts,
                                    self.uni)

    def bound(self, p, inp, dims) -> dict:
        """Params, batches, noise and masks read once, every gradient and
        the metrics written once; the operations of its passes
        (categorical's row pass: ~10 per output element and decode)."""
        from multivae_tpu_torch.ops import latent_multi

        n_metrics = latent_multi.n_step_metrics(dims.m, self.method, self.uni)
        moved = 2 * nbytes(p) + nbytes(*inp) + 4 * n_metrics
        flops = generic_flops(dims, self.enc_passes, self.dec_passes)
        if self.likelihood == "categorical":
            flops += 10.0 * dims.b * sum(dims.ds) * self.dec_passes
        return bound(moved, flops)


def stepwise_epoch(route, dims, p0, consts, hyper, gen, device, phase,
                   n=8):
    """An ``n``-step epoch of one layer-stack route: along the kernels' own
    trajectory every step is recomputed by the plain version from the same
    state (the step bound), then the free-running plain epoch is held by
    :func:`hold_epoch`, which accepts what parts downstream of Adam's trap or
    of a rounding-level ReLU. Returns its error."""
    import torch

    from multivae_tpu_torch.ops import adam as adam_ops

    stacks = route.inputs(dims, gen, device, steps=n)
    steps = [tuple(None if t is None else t[i] for t in stacks)
             for i in range(n)]
    name = f"{route.name} + flat_adam {n}-step epoch"
    p, q = p0.clone(), p0.clone()
    sp, sq = adam_ops.init_adam_state(p), adam_ops.init_adam_state(q)
    ker_grads, ref_grads = [], []
    branch = torch.zeros_like(p, dtype=torch.bool)
    worst = 0.0
    for i, inp in enumerate(steps):
        ker = route.step("kernel", p, inp, dims, consts)

        def excuse(inp=inp):
            mask, text = route.excuse(p, inp, dims, consts)
            branch.logical_or_(mask)
            return mask, text

        worst = max(worst, check_step(
            name, ker, route.step("plain", p, inp, dims, consts),
            split_pairs(dims), f"step {i} from the kernels' state", phase,
            quiet=True, excuse=excuse))
        adam_ops.adam_update(p, sp.mu, sp.nu, ker[1], i + 1, hyper)
        ker_grads.append(ker[1])
        _, g = route.step("plain", q, inp, dims, consts)
        adam_ops.adam_update_reference(q, sq.mu, sq.nu, g, i + 1, hyper)
        ref_grads.append(g)
    torch.cuda.synchronize()
    log(phase, f"{name}: every step recomputed by the plain version from "
        f"the kernels' state: metrics+grads max_abs_err {worst:.3e}")
    return hold_epoch(phase, name, (p, sp.mu, sp.nu), (q, sq.mu, sq.nu),
                      ker_grads, ref_grads, dims, branch=branch,
                      downstream_ok=True)


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
                            excuse=lambda: route.excuse(p, inp, dims,
                                                        consts)))
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
        err = stepwise_epoch(route, dims, p0, consts, hyper, gen, device,
                             "generic-kernel")
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


def epoch_batch_counts(datadir: str, **cfg_kw):
    """``(complete, clinical-only)`` batch sizes of one training epoch of
    the cohort, from the port's data layer and sampler (``cfg_kw``: the
    blocks' widths where they are not the flagship's)."""
    from multivae_tpu_torch.data import MissingModalitySampler
    from multivae_tpu_torch.train.experiment import MultimodalExperiment

    cfg = flagship_cfg(dataset="synthetic", datasetdir=datadir,
                       batch_size=256, **cfg_kw)
    exp = MultimodalExperiment(cfg, "cpu")
    exp.set_datasets()
    ds = exp.dataset_train
    start = time.perf_counter()
    complete, clinical = [], []
    for idxs in MissingModalitySampler(ds, batch_size=256, seed=cfg.seed):
        data, _, _ = ds.gather(idxs)
        (complete if len(data) == len(cfg.input_dim) else clinical).append(
            len(idxs))
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
                                  **{**SLICE_TRAIN, **kw})
    line = [ln for ln in out.getvalue().splitlines()
            if "train wall per epoch (s):" in ln][-1]
    return run, [float(w) for w in line.split(":", 1)[1].split()]


WARM_UP_KEPT = []  # each profiled epoch's warm-up kernels in its trace


def profile_epoch(datadir, run_dir, device):
    """Device busy time of one training epoch (the package's tracer,
    ``train/profiling.py``, its trace under ``run_dir/profile``), its host
    wall, and the kernels' device time by name."""
    import torch

    from multivae_tpu_torch.train import profiling, trainer
    from multivae_tpu_torch.train.config import Config
    from multivae_tpu_torch.train.experiment import MultimodalExperiment
    from multivae_tpu_torch.train.routes import Routes

    cfg = Config.load(os.path.join(run_dir, "flags.json"))
    cfg.datasetdir = datadir
    exp = MultimodalExperiment(cfg, device)
    exp.set_datasets()
    exp.set_optimizers()
    routes = Routes(cfg, exp.models[0], exp.device)
    trainer.train_one_epoch(exp, 0, None, trainer.epoch_generator(cfg, 0, 0),
                            routes=routes)
    torch.cuda.synchronize()
    with profiling.trace(os.path.join(run_dir, "profile"), device,
                         1) as prof:
        start = time.perf_counter()
        trainer.train_one_epoch(exp, 0, None,
                                trainer.epoch_generator(cfg, 0, 1), 1,
                                routes=routes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    WARM_UP_KEPT.append(profiling.warm_up_kept(prof))
    return wall, profiling.device_ms_by_name(prof)


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
    of the launch and step counts. A step's recorded arguments end with its
    ``bf16`` flag (the plain step's last positional argument)."""
    from multivae_tpu_torch.ops import (adam, fused_methods, fused_presence,
                                        fused_sharded, fused_step)

    rec = {"steps": [], "updates": [], "state": None, "shards": {}}
    modules = (fused_step, fused_methods, fused_presence, fused_sharded)
    owner = {"step_flat": fused_step, "method_step_flat": fused_methods,
             "presence_step_flat": fused_presence,
             "dp_step_flat": fused_sharded,
             "dp_method_step_flat": fused_sharded}
    orig = {name: getattr(m, name) for name, m in owner.items()}

    def recorder(kind, fn):
        # step_flat and presence_step_flat take bf16 tenth
        def step(*args, bf16=False):
            args, bf16 = args[:9], args[9] if len(args) > 9 else bf16
            out = fn(*args, bf16=bf16)
            rec["steps"].append((kind, [cpu(a) for a in args] + [bf16],
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
                        masks=None, bf16=False):
        out = orig["method_step_flat"](method, p, x1, x2, noise, dims,
                                       consts, learn_scale, masks, bf16)
        rec["steps"].append((
            "method", [cpu(a) for a in (p, x1, x2, noise, dims, consts,
                                        learn_scale, masks, method, bf16)],
            [cpu(o) for o in out]))
        return out

    def dp_mopoe_recorder(p, mu, nu, t, x1, x2, noise, dims, consts, hyper,
                          learn_scale, mesh, bf16=False):
        args = [cpu(a) for a in (p, x1, x2, *fused_step.split_noise(
            noise, dims), dims, consts, learn_scale, bf16)]
        m = orig["dp_step_flat"](p, mu, nu, t, x1, x2, noise, dims, consts,
                                 hyper, learn_scale, mesh, bf16)
        rec["steps"].append(("complete", args,
                             [cpu(m), rec["updates"][-1][1]]))
        return m

    def dp_method_recorder(method, p, mu, nu, t, x1, x2, noise, dims,
                           consts, hyper, learn_scale, mesh, masks=None,
                           bf16=False):
        args = [cpu(a) for a in (p, x1, x2, noise, dims, consts,
                                 learn_scale, masks, method, bf16)]
        m = orig["dp_method_step_flat"](method, p, mu, nu, t, x1, x2, noise,
                                        dims, consts, hyper, learn_scale,
                                        mesh, masks, bf16)
        # the shard count of a data-parallel method step, by step index
        rec["shards"][len(rec["steps"])] = len(mesh.axis_devices("data"))
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

        def epoch(*args, bf16=False):
            head, (p, mu, nu, count), rest = (args[:lead],
                                              args[lead:lead + 4],
                                              args[lead + 4:])
            if p.device.type != "cuda":
                # the CPU loops the recorded step and update itself
                return epoch_fn(*args, bf16=bf16)
            q, qm, qv = (x.clone() for x in (p, mu, nu))
            metrics = epoch_fn(*args, bf16=bf16)
            hyper = next(a for a in rest if isinstance(a, adam.AdamHyper))
            saved = [dict(c) for c in counts]
            rows = []
            for i in range(metrics.shape[0]):
                m, g = one_step(q, i, *head, *rest, bf16=bf16)
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
                  learn_scale=True, bf16=False):
        return new["step_flat"](q, x1s[i], x2s[i], *fused_step.split_noise(
            noise[i], dims), dims, consts, learn_scale, bf16=bf16)

    def presence_one(q, i, xs, noise, dims, consts, hyper, learn_scale,
                     mod_idx, method="joint_elbo", masks=None, bf16=False):
        return new["presence_step_flat"](
            q, xs[i], noise[i], dims, consts, learn_scale, mod_idx, method,
            None if masks is None else masks[i], bf16=bf16)

    def method_one(q, i, method, x1s, x2s, noise, dims, consts, hyper,
                   learn_scale=True, masks=None, bf16=False):
        return new["method_step_flat"](
            method, q, x1s[i], x2s[i], noise[i], dims, consts, learn_scale,
            None if masks is None else masks[i], bf16)

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


def plain_steps():
    """The plain step of each kind :func:`recording_train_loop` records,
    called with a step's recorded arguments (its ``bf16`` flag last)."""
    from multivae_tpu_torch.ops import (fused_methods, fused_presence,
                                        fused_step)
    from multivae_tpu_torch.ops.fused_sharded import mean_rescale

    def dp_method(p, x1, x2, noise, d, consts, ls, masks, method, n_dev,
                  bf16):
        # the row slices' partial sums, summed in shard order (the JAX
        # kernel rounds each shard's products before the psum)
        local = d._replace(b=d.b // n_dev)
        msum = gsum = None
        for k in range(n_dev):
            rows = slice(k * local.b, (k + 1) * local.b)
            m, g = fused_methods.slice_method_step_flat(
                method, p, x1[rows], x2[rows], noise[rows], local, consts,
                ls, None if masks is None else [mk[rows] for mk in masks],
                k * local.b, d.b, bf16)
            msum = m if msum is None else msum + m
            gsum = g if gsum is None else gsum + g
        return mean_rescale(msum, n_dev), gsum

    return {"complete": fused_step.step_flat,
            "presence": fused_presence.presence_step_flat,
            "method": lambda p, x1, x2, noise, d, consts, ls, masks, method,
            bf16: fused_methods.method_step_flat(method, p, x1, x2, noise, d,
                                                 consts, ls, masks, bf16),
            # a data-parallel method step: its shard count before bf16
            "dp_method": dp_method}


def hold_plain_step(plain, kind, args, ker, dims, phase, label,
                    referee64=False):
    """Hold one recorded step ``ker = (metrics, grads)`` of ``kind`` to its
    plain version (:func:`plain_steps`) on the host from the same ``args``,
    every element at the step bounds (``referee64``: as
    :func:`hold_slice_epoch` says). Returns the largest absolute difference
    and the largest factor the gradients' absolute bound was scaled by;
    raises on an element outside."""
    import torch

    from multivae_tpu_torch.params import flat_views

    def on_host(x):
        if referee64 and torch.is_tensor(x) and x.is_floating_point():
            return x.double()
        return x

    km, kg = ker
    rm, rg = plain[kind](*[on_host(a) for a in args])
    g_atol, scale, worst = STEP_ATOL, 1.0, 0.0
    if referee64:
        g_atol = torch.empty_like(rg)
        for t, v in zip(flat_views(g_atol, dims).values(),
                        flat_views(rg, dims).values()):
            t.fill_(STEP_ATOL * max(1.0, float(v.abs().max())))
        scale = float(g_atol.max()) / STEP_ATOL
    for a, b, rtol, atol in ((km[:1], rm[:1], LOSS_RTOL, 0.0),
                             (km, rm, STEP_RTOL, STEP_ATOL),
                             (kg, rg, STEP_RTOL, g_atol)):
        err, bad = close(a, b, rtol, atol)
        worst = max(worst, err)
        if bool(bad.any()):
            j = int(torch.argmax((a - b).abs() * bad))
            log(phase, f"a {kind} step, tensor of {a.numel()}: "
                f"{int(bad.sum())} elements outside rtol {rtol} / atol "
                f"{atol if isinstance(atol, float) else 'scaled'}; worst "
                f"[{j}] {float(a.reshape(-1)[j]):.9e} vs "
                f"plain {float(b.reshape(-1)[j]):.9e}")
            raise SystemExit(f"a {kind} step of the epoch of {label} "
                             f"disagrees with the plain version")
    return worst, scale


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

    def tensors_equal(a, b):
        return torch.equal(a, b) if torch.is_tensor(a) else a == b

    same_inputs = len(card["steps"]) == len(host["steps"]) and all(
        ck == hk and all(tensors_equal(a, b)
                         for a, b in zip(ca[1:], ha[1:]))
        for (ck, ca, _), (hk, ha, _) in zip(card["steps"], host["steps"]))
    if not same_inputs:
        raise SystemExit(f"the epochs of {labels[0]} and {labels[1]} were "
                         f"fed different inputs")
    plain = plain_steps()
    worst_step, worst_scale = 0.0, 1.0
    for kind, args, (km, kg) in card["steps"]:
        err, scale = hold_plain_step(plain, kind, args, (km, kg), dims,
                                     phase, labels[0], referee64)
        worst_step, worst_scale = max(worst_step, err), max(worst_scale,
                                                            scale)
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


# the float32 train kernels whose launches and steps the slices check
SLICE_STEP_KERNELS = ("mopoe_step", "dp_step", "method_step",
                      "dp_method_step", "presence_step", "generic_step")


def step_counters():
    """The counts of train steps run by the persistent kernels' launches
    (one launch may run a group of steps): each kernel's counter dict,
    from the port's registry (``train/profiling.py``)."""
    from multivae_tpu_torch.train import profiling

    steps = profiling.kernel_counters("steps")
    return {k: steps[k] for k in SLICE_STEP_KERNELS}


def slice_counters():
    """Each float32 train kernel's launch counter dict and flat Adam's,
    from the port's registry (``train/profiling.py``)."""
    from multivae_tpu_torch.train import profiling

    launches = profiling.kernel_counters("launches")
    return {k: launches[k] for k in SLICE_STEP_KERNELS + ("flat_adam",)}


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

    def epoch(method, p, mu, nu, count, xs, noise, dims, consts, hyper,
              learn_scale=True, masks=None, order=None, phase_times=None,
              unimodal_elbos=True):
        q, qm, qv = (x.clone() for x in (p, mu, nu))
        metrics = epoch_fn(method, p, mu, nu, count, xs, noise, dims,
                           consts, hyper, learn_scale, masks, order,
                           phase_times, unimodal_elbos=unimodal_elbos)
        counts = (adam.KERNEL_LAUNCHES, fused_generic.KERNEL_LAUNCHES,
                  fused_generic.KERNEL_STEPS)
        saved = [dict(c) for c in counts]
        rows = []
        for i in range(noise.shape[0]):
            args = (method, q, [x[i] for x in xs], noise[i], dims, consts,
                    learn_scale, None if masks is None else masks[i])
            out = fused_generic.generic_step_flat(
                *args, unimodal_elbos=unimodal_elbos)
            rec["steps"].append(([[cpu(x) for x in a] if isinstance(a, list)
                                  else cpu(a) for a in args]
                                 + [unimodal_elbos],
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
                            clinical, batching_s, phase="generic-slice",
                            names=("clinical", "rois")):
    """``train_exp`` of one slice on the layer-stack step on the card with
    every count set to 0 just before and read just after; checks the
    launches of its routes (the full complete batches on the layer-stack
    step, every other batch on the general autograd step), the losses, the
    metric families, the checkpoints and a resumed run; then recomputes the
    first epoch's kernel steps by the plain version from the card's own
    state. ``kw``: train_exp's flags beside the train slice's (a modality
    count other than two with its ``input_dims`` and ``style_dim``, and
    ``names``). Returns the launches."""
    import types

    import pandas as pd
    import torch

    from multivae_tpu_torch import workflows
    from multivae_tpu_torch.ops import fused_generic, fused_presence
    from multivae_tpu_torch.params import dims_from, flat_size
    from multivae_tpu_torch.train.config import Config

    epochs = GENERIC_SLICE_EPOCHS
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
    model = types.SimpleNamespace(
        factorized_representation=styled, modalities=[
            types.SimpleNamespace(name=n, style_dim=s) for n, s in zip(
                names, kw.get("style_dim", SLICE_TRAIN["style_dim"]))])
    method = kw["method"]
    complete_fam = frozenset(fused_generic.generic_metric_names(model,
                                                                method))
    # the general step's families: total_loss's, no style family without
    # style latents
    clinical_fam = frozenset(
        n for n in fused_presence.presence_metric_names(model, method, 0)
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
        (method_, p, xs, noise, dims, consts, learn_scale, masks,
         uni) = args
        worst = max(worst, check_step(
            f"generic_step[{tag}]", out,
            fused_generic.generic_step_flat(*args[:-1], unimodal_elbos=uni),
            split_pairs(dims),
            f"step {i} of the first epoch, from the card's state", phase,
            quiet=True, excuse=lambda: rounding_level_units(
                method_, p, (*xs, noise, masks), dims, consts, uni)))
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


# ------------------------------------------- modality counts other than two
# four-block: the flagship's data with its 444-wide ROI block split into the
# three measures that make it up (148 columns each), the flagship's model
FOUR_BLOCK = dict(input_dim=[7, 148, 148, 148], style_dim=[3, 20, 20, 20])
FOUR_BLOCK_NAMES = ("clinical", "rois", "mod2", "mod3")
# three blocks: four-block without its last
THREE_BLOCK = dict(input_dim=[7, 148, 148], style_dim=[3, 20, 20])
# M = 8 at small widths, and M = 10 (1023 subsets, more than a batch has
# rows) with 8 + 8 hidden layers, whose tables outgrow shared memory
EIGHT = dict(input_dim=[16, 8, 12, 10, 6, 9, 14, 7],
             style_dim=[2, 3, 2, 1, 2, 3, 1, 2], hidden_dim=64, class_dim=8)
TEN = dict(input_dim=[9, 7, 5, 8, 6, 4, 7, 5, 6, 3], style_dim=[2] * 10,
           hidden_dim=32, class_dim=4)
MULTIMODAL_SLICES = (
    ("train four-block joint_elbo", dict(method="joint_elbo",
                                         dropout_rate=0.0)),
    ("train four-block poe dropout 0.2", dict(method="poe",
                                              dropout_rate=MASK_RATE)),
)


def split_roi_block(datadir: str) -> None:
    """Rewrite a synthetic cohort's ROI block into three blocks by the
    measure each column holds (the ``_thickness`` / ``_area`` /
    ``_meancurv`` suffix of ``rois_names.npy``): ``rois``, ``mod2``,
    ``mod3``. A subject without ROIs lacks all three."""
    data = np.load(os.path.join(datadir, "rois_data.npy"))
    names = np.load(os.path.join(datadir, "rois_names.npy"),
                    allow_pickle=True)
    subjects = np.load(os.path.join(datadir, "rois_subjects.npy"),
                       allow_pickle=True)
    for block, measure in (("rois", "thickness"), ("mod2", "area"),
                           ("mod3", "meancurv")):
        cols = [i for i, n in enumerate(names)
                if str(n).endswith("_" + measure)]
        np.save(os.path.join(datadir, f"{block}_data.npy"),
                np.ascontiguousarray(data[:, cols]))
        np.save(os.path.join(datadir, f"{block}_names.npy"), names[cols])
        np.save(os.path.join(datadir, f"{block}_subjects.npy"), subjects)


def multimodal_kernel_check(device, entry):
    """Phase multimodal-kernel: the layer-stack step at modality counts
    other than two, past four hidden layers and for poe without its
    unimodal ELBOs, each held to its plain version: four-block (the four
    methods, masks on and off, poe without unimodal ELBOs, B=256 and 137,
    learned scale on and off), three-block and M = 8 at small widths (the
    four methods), the JAX kernel's deep stacks at the flagship widths,
    M = 10 (1023 subsets) and M = 10 with 8 + 8 layers (tables in device
    memory); for every route ONE launch of 8
    steps with Adam against 8 one-step launches and ``flat_adam`` (equal
    bits, two runs equal); two 8-step epochs recomputed step by step; the
    four-block joint_elbo step and poe + masks step timed as a one-step
    launch and per step of a 6-step launch beside their bounds. Adds to
    ``entry`` (``generic_step``'s record)."""
    import torch

    from multivae_tpu_torch.ops import adam as adam_ops
    from multivae_tpu_torch.ops import fused_generic as fg
    from multivae_tpu_torch.ops import fused_step as fs
    from multivae_tpu_torch.ops import latent_multi

    phase = "multimodal-kernel"
    consts = fs.FusedConsts(1.0, 0.7, 1.2)
    hyper = adam_ops.AdamHyper(2e-3, 0.9, 0.999)
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    launch_gen = torch.Generator(device=device).manual_seed(SEED + 22)
    four = [GenericRoute("1+0", m, masked, mods=FOUR_BLOCK,
                         label="four-block")
            for m in fg.PORTED_METHODS for masked in (False, True)]
    four += [GenericRoute("1+0", "poe", masked, mods=FOUR_BLOCK,
                          label="four-block", uni=False)
             for masked in (False, True)]
    # the split layout's architecture takes the layer-stack step for poe
    # without its unimodal ELBOs
    flagship = [GenericRoute("1+0", "poe", masked, label="flagship",
                             uni=False) for masked in (False, True)]
    others = [GenericRoute("1+0", m, m == "poe", mods=THREE_BLOCK,
                           label="three-block")
              for m in fg.PORTED_METHODS]
    others += [GenericRoute("1+0", m, m == "poe", mods=EIGHT, label="M=8")
               for m in fg.PORTED_METHODS]
    others.append(GenericRoute("2+0 per-sample", "poe", True, mods=EIGHT,
                               label="M=8", uni=False))
    for arch, (_, _, hidden) in DEEP_STACKS.items():
        for method, masked in (("joint_elbo", False), ("poe", True),
                               ("jsd", False)):
            others.append(GenericRoute(arch, method, masked,
                                       mods=dict(hidden_dim=hidden),
                                       label=f"hidden {hidden}"))
    others += [GenericRoute("1+0", "joint_elbo", mods=TEN, label="M=10"),
               GenericRoute("8+8", "poe", True, mods=TEN, label="M=10")]
    n_cases, geo = 0, {}
    for route in four + flagship + others:
        rows = GENERIC_ROWS if route in four + flagship else (256,)
        worst = 0.0
        for b in rows:
            dims, p = route.setup(device, b, SEED + b)
            for learn_scale in (True, False):
                inp = route.inputs(dims, gen, device)
                worst = max(worst, check_step(
                    route.name,
                    route.step("kernel", p, inp, dims, consts, learn_scale),
                    route.step("plain", p, inp, dims, consts, learn_scale),
                    split_pairs(dims), f"B={b} learn_scale={learn_scale}",
                    phase, quiet=True,
                    excuse=lambda: route.excuse(p, inp, dims, consts)))
                n_cases += 1
        entry["max_abs_err"] = max(entry["max_abs_err"], worst)
        dims, p0 = route.setup(device, 256, SEED)
        launch_vs_steps(route, p0, dims, consts, hyper, launch_gen, device,
                        phase=phase)
        g = route.geometry(dims, device)
        geo[route.name] = g
        log(phase, f"{route.name} M={dims.m} B={list(rows)} learn_scale "
            f"on/off: metrics+grads max_abs_err {worst:.3e} ok; "
            f"{latent_multi.n_step_metrics(dims.m, route.method, route.uni)} "
            f"metrics, "
            f"{p0.numel()} params, {g['grid_blocks']} blocks, "
            f"{g['phases']} phases, tables in "
            + ("device memory" if g["tables_in_device_memory"]
               else "shared memory"))
    log(phase, f"{n_cases} steps held to the plain version (loss rtol "
        f"{LOSS_RTOL}; metrics and grads rtol {STEP_RTOL} / atol "
        f"{STEP_ATOL})")
    if not geo[others[-1].name]["tables_in_device_memory"]:
        raise SystemExit("the M=10 8+8 route was to keep its tables in "
                         "device memory")
    split_route_check(flagship[1], device, launch_gen, phase)

    timed_routes = (four[0], four[7])  # joint_elbo; poe with masks
    for route in timed_routes:
        dims, p0 = route.setup(device, 256, SEED)
        err = stepwise_epoch(route, dims, p0, consts, hyper, gen, device,
                             phase)
        entry["epoch_err"] = max(entry.get("epoch_err", 0.0), err)

    # ---- timing, in turns: plain, kernel, kernel, plain
    for route in timed_routes:
        dims, p = route.setup(device, 256, SEED)
        inp = route.inputs(dims, gen, device)
        ker = lambda: route.step("kernel", p, inp, dims, consts)
        ref = lambda: route.step("plain", p, inp, dims, consts)
        t = [cuda_ms(ref, 30), cuda_ms(ker, 30), cuda_ms(ker, 30),
             cuda_ms(ref, 30)]
        timed = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
                     library_ms=None, **route.bound(p, inp, dims))
        timed.update(time_launch(route, p, dims, consts, hyper, gen, device,
                                 phase))
        entry["variants"][route.name] = timed
        fl = generic_flops(dims, route.enc_passes, route.dec_passes)
        log(phase, f"{route.name} B=256: kernel {t[1]:.4f}/{t[2]:.4f} ms, "
            f"plain {t[0]:.4f}/{t[3]:.4f} ms per one-step launch; bound "
            f"{timed['bound_ms']:.5f} ms by {timed['bound_by']} "
            f"({fl / 1e6:.1f} MFLOP, {p.numel()} params); kernel "
            f"{fl / (timed['ms'] * 1e-3) / 1e12:.3f} TFLOP/s = "
            f"{100 * timed['bound_ms'] / timed['ms']:.2f} % of the bound's "
            f"rate")


def split_route_check(route, device, gen, phase, n=5):
    """The trainer's epoch of the full complete batches for poe without its
    unimodal ELBOs at the split layout's architecture: the state, kept in
    the split layout, gathered into the general layout around ONE
    ``generic_step`` launch must end bit for bit where the launch on the
    general layout ends."""
    import torch

    from multivae_tpu_torch.models import build_model, make_modalities
    from multivae_tpu_torch.ops import adam as adam_ops
    from multivae_tpu_torch.ops import fused_generic as fg
    from multivae_tpu_torch.ops import fused_step as fs
    from multivae_tpu_torch.params import (FusedDims, dims_from,
                                           generic_dims, layout_index,
                                           model_flat_params)
    from multivae_tpu_torch.train import routes

    cfg = flagship_cfg(route.method, seed=SEED, dropout_rate=MASK_RATE,
                       **route.cfg_kw)
    cfg.poe_unimodal_elbos = False
    model = build_model(cfg, make_modalities(
        cfg.input_dim, cfg.style_dim, cfg.likelihood), device, seed=SEED)
    split, general = dims_from(cfg, 256), generic_dims(cfg, 256)
    [(_, _, step)] = routes.Routes(cfg, model, device).full_parts(n)
    epoch = step.epoch
    if not isinstance(split, FusedDims) or step.name != routes.LAYER_STACK:
        raise SystemExit("poe without unimodal ELBOs at the split layout's "
                         "architecture was to take the layer-stack step")
    index = layout_index(split, general, model.mod_names).to(device)
    p = model_flat_params(model, split)
    q = p[index]
    stacks = route.inputs(general, gen, device, steps=n)
    xs = dict(zip(model.mod_names, stacks[:2]))
    before = fg.KERNEL_LAUNCHES["generic_step"]
    opt, _, _ = epoch(p, adam_ops.init_adam_state(p), xs, stacks[2],
                      stacks[3])
    launches = fg.KERNEL_LAUNCHES["generic_step"] - before
    mu, nu = torch.zeros_like(q), torch.zeros_like(q)
    route.launch_epoch(q, mu, nu, 0, stacks, general, fs.consts_from(cfg),
                       adam_ops.adam_hyper(cfg))
    torch.cuda.synchronize()
    same = all(torch.equal(a[index], b)
               for a, b in ((p, q), (opt.mu, mu), (opt.nu, nu)))
    log(phase, f"trainer epoch of {n} full batches, poe without unimodal "
        f"ELBOs at the split layout's architecture, masks: {launches} "
        f"generic_step launch; params and moments equal bits to the launch "
        f"on the general layout {same}")
    if launches != 1 or not same or opt.count != n:
        raise SystemExit("the trainer's split-architecture route of the "
                         "layer-stack step disagrees with its launch")


def multimodal_slice(device, card: str):
    """Phase multimodal-slice: ``workflows.train_exp`` on the card on the
    four-block cohort (the train slices' cohort with its ROI block split
    by measure) for joint_elbo and for poe with dropout 0.2. Returns each
    run's launches, ``{path: {kernel: count}}``."""
    phase = "multimodal-slice"
    by_path = {}
    with tempfile.TemporaryDirectory() as root:
        datadir, _, _, _ = slice_cohort(root, phase)
        split_roi_block(datadir)
        complete, clinical, batching_s = epoch_batch_counts(datadir,
                                                            **FOUR_BLOCK)
        log(phase, f"four blocks {FOUR_BLOCK_NAMES} of widths "
            f"{FOUR_BLOCK['input_dim']}: complete batches {complete}, "
            f"clinical-only batches {clinical}; host batching "
            f"{batching_s:.4f} s per epoch")
        if (complete != sorted(EPOCH_COMPLETE)
                or clinical != sorted(EPOCH_PRESENCE)):
            raise SystemExit("unexpected four-block epoch batches")
        train = dict(input_dims=FOUR_BLOCK["input_dim"],
                     style_dim=FOUR_BLOCK["style_dim"])
        for path, kw in MULTIMODAL_SLICES:
            by_path[path] = generic_train_and_check(
                root, path, {**train, **kw}, datadir, device, card, complete,
                clinical, batching_s, phase=phase, names=FOUR_BLOCK_NAMES)
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


# bf16 slices: (path, method, dropout rate, data_parallel, epochs)
BF16_SLICES = (
    ("train joint_elbo bf16", "joint_elbo", 0.0, 1, 3),
    ("train poe dropout 0.2 bf16", "poe", MASK_RATE, 1, 3),
    ("train joint_elbo bf16 data_parallel 4", "joint_elbo", 0.0,
     DATA_PARALLEL, 1),
    ("train poe dropout 0.2 bf16 data_parallel 4", "poe", MASK_RATE,
     DATA_PARALLEL, 1),
)
BF16_LOSS_RTOL = 0.05  # an epoch's mean train loss against the f32 run's


def train_kernel_counters(kind: str = "launches") -> dict:
    """Each train kernel's ``kind`` counter dict (``profiling``'s registry,
    the avatar sweep left out), the bfloat16 instances' (``*_bf16``)
    beside the float32 ones."""
    from multivae_tpu_torch.train import profiling

    return {k: c for k, c in profiling.kernel_counters(kind).items()
            if k != "avatar_sweep"}


def launch_counts() -> dict:
    """Every launch counter of the train kernels."""
    return {k: c[k] for k, c in train_kernel_counters().items()}


def zero_launch_counts() -> None:
    for kind in ("launches", "steps"):
        for k, c in train_kernel_counters(kind).items():
            c[k] = 0


def precision_run(datadir, outdir, epochs, precision, method, rate,
                  data_parallel=1):
    """Train the flagship through its entry points with ``precision`` (no
    CLI flag or ``train_exp`` argument takes it: a ``Config``, a
    ``MultimodalExperiment`` and ``trainer.run_epochs``); returns the run
    and the train wall of each epoch."""
    from multivae_tpu_torch.train import trainer
    from multivae_tpu_torch.train.config import Config
    from multivae_tpu_torch.train.experiment import MultimodalExperiment
    from multivae_tpu_torch.utils.filehandling import create_dir_structure

    cfg = Config(dataset="synthetic", datasetdir=datadir,
                 dir_experiment=outdir, input_dim=[7, 444], class_dim=20,
                 style_dim=[3, 20], batch_size=256, end_epoch=epochs,
                 method=method, dropout_rate=rate,
                 data_parallel=data_parallel, fused_training=True,
                 precision=precision).derive()
    exp = MultimodalExperiment(cfg, "cuda")
    create_dir_structure(cfg)
    exp.set_datasets()
    exp.set_optimizers()
    with contextlib.redirect_stdout(io.StringIO()):
        walls = trainer.run_epochs(exp, use_tensorboard=False,
                                   progress=False)
    return cfg.str_experiment, walls


def epoch_losses(rundir: str, steps: int) -> list:
    """The mean train loss of each epoch of a run (``steps`` a epoch)."""
    import pandas as pd

    csv = pd.read_csv(os.path.join(rundir, "logs", "metrics.csv"))
    tr = csv[(csv.phase == "train") & (csv.metric == "loss")]
    losses = tr.sort_values("step").value.to_numpy()
    return [float(losses[i:i + steps].mean())
            for i in range(0, len(losses), steps)]


def hold_bf16_epoch(card, dims, label, phase="bf16-slice"):
    """Hold a recorded epoch (:func:`recording_train_loop`) step by step
    along the kernels' own trajectory: every bf16 step recomputed by the
    plain bf16 and f32 versions on the host from the same inputs and held
    by the ratio rule (:func:`hold_bf16`), every f32 step (the data-parallel
    remainder groups) at the step bounds as :func:`hold_slice_epoch` holds
    a cohort's steps (``referee64``), every Adam update at the Adam bound.
    Returns the worst ratio."""
    plain = plain_steps()
    worst, n16, n32, worst32, scale32 = 0.0, 0, 0, 0.0, 1.0
    for i, (kind, args, (km, kg)) in enumerate(card["steps"]):
        if i in card["shards"]:
            # scheme B rounds each shard's products: the sum of the plain
            # row slices is its plain version
            kind, args = "dp_method", args[:-1] + [card["shards"][i],
                                                   args[-1]]
        if args[-1]:
            ratio, _ = hold_bf16(
                f"{label} step {i} ({kind})", (km, kg),
                lambda bf16: plain[kind](*args[:-1], bf16), dims,
                "held on the host", phase)
            worst, n16 = max(worst, ratio), n16 + 1
            continue
        err, scale = hold_plain_step(plain, kind, args, (km, kg), dims,
                                     phase, f"{label} (f32 step {i})", True)
        worst32, scale32 = max(worst32, err), max(scale32, scale)
        n32 += 1
    worst_adam = hold_adam_updates(card["updates"], phase, label)
    log(phase, f"{label}: first epoch held step by step along the kernels' "
        f"trajectory: {n16} bf16 steps by the ratio rule (worst "
        f"{worst:.4f}), {n32} f32 steps as dp-slice holds its cohort steps "
        f"(plain in float64, gradient atol {STEP_ATOL} x its tensor's "
        f"largest element, at most x {scale32:.1f}; max_abs_err "
        f"{worst32:.3e}), {len(card['updates'])} Adam updates "
        f"{worst_adam:.3e}")
    return worst


def bf16_slice(device, card: str):
    """Phase bf16-slice: the flagship trained with ``precision="bfloat16"``
    on the train slice's cohort through ``MultimodalExperiment`` and
    ``trainer.run_epochs``: joint_elbo for 3 epochs and a fourth by
    ``workflows.resume_exp``, poe with dropout 0.2 for 3 epochs, joint_elbo
    and poe with dropout at ``data_parallel=4`` for 1 epoch; each run's
    launches per kernel and
    instance (every count set to 0 just before, read just after), each
    epoch's mean train loss beside an f32 run from the same seed, the wall
    per epoch, a profiled epoch's busy time and idle share, and a first
    epoch recorded and held step by step. Returns each run's launches."""
    import torch

    from multivae_tpu_torch import workflows
    from multivae_tpu_torch.params import dims_from
    from multivae_tpu_torch.train.config import Config

    by_path, worst = {}, 0.0
    dims = dims_from(flagship_cfg(), 256)
    with tempfile.TemporaryDirectory() as root:
        datadir, complete, clinical, _ = slice_cohort(root, "bf16-slice")
        steps = len(complete) + len(clinical)
        for path, method, rate, n_dp, epochs in BF16_SLICES:
            out = os.path.join(root, path.replace(" ", "_"))
            runs, losses = {}, {}
            for precision in ("float32", "bfloat16"):
                zero_launch_counts()
                torch.cuda.synchronize()
                runs[precision], walls = precision_run(
                    datadir, os.path.join(out, precision), epochs, precision,
                    method, rate, n_dp)
                counts = launch_counts()
                losses[precision] = epoch_losses(
                    os.path.join(out, precision, runs[precision]), steps)
            by_path[path] = {k: v for k, v in counts.items() if v}
            # the JAX routes under bf16 (ops/bf16.py): full complete batches
            # of joint_elbo without dropout on the MoPoE step, the partial
            # complete batch and every complete batch of poe on the method
            # step, the clinical-only batches on the presence step; under
            # data_parallel the row slices in bf16 and the rest in f32
            groups = len(set(clinical)) * epochs
            hand = method == "joint_elbo" and not rate
            if n_dp > 1:
                want = {("dp_step_bf16" if hand else "dp_method_step_bf16"):
                        5 * n_dp * epochs, "flat_adam": 5 * epochs,
                        ("mopoe_step" if hand else "method_step"): epochs,
                        "presence_step": groups}
            elif method == "joint_elbo":
                want = {"mopoe_step_bf16": epochs,
                        "method_step_bf16": epochs,
                        "presence_step_bf16": groups}
            else:
                want = {"method_step_bf16": 2 * epochs,
                        "presence_step_bf16": groups}
            rundir = os.path.join(out, "bfloat16", runs["bfloat16"])
            flags = Config.load(os.path.join(rundir, "flags.json"))
            gaps = [abs(a - b) / abs(b) for a, b in zip(losses["bfloat16"],
                                                         losses["float32"])]
            checks = {
                "launches": by_path[path] == want,
                "flags.json precision": flags.precision == "bfloat16",
                "losses finite": bool(np.isfinite(losses["bfloat16"]).all()),
                f"epoch losses within {BF16_LOSS_RTOL} of f32": bool(
                    len(gaps) == epochs and max(gaps) <= BF16_LOSS_RTOL),
            }
            wall = float(np.median(walls[1:])) if len(walls) > 1 else walls[0]
            log("bf16-slice", f"[{path}] {epochs} epochs: launches "
                f"{by_path[path]} (expected {want}); mean train loss per "
                f"epoch bf16 {[round(x, 4) for x in losses['bfloat16']]} vs "
                f"f32 {[round(x, 4) for x in losses['float32']]} (largest "
                f"relative gap {max(gaps):.2e}); train wall per epoch first "
                f"{walls[0]:.4f} s, median of the rest {wall:.4f} s ({card});"
                f" checks " + ", ".join(f"{k}={v}" for k, v in
                                         checks.items()))
            if not all(checks.values()):
                raise SystemExit(f"bf16 slice wrong ({path}): {checks}")
            ep_wall, by_name = profile_epoch(datadir, rundir, device)
            busy = sum(by_name.values())
            log("bf16-slice", f"[{path}] profiled training epoch: wall "
                f"{ep_wall * 1e3:.3f} ms, device busy {busy:.3f} ms (idle "
                f"share {100 * (1 - busy / (ep_wall * 1e3)):.1f} %); top: "
                + ", ".join(f"{k[:40]} {v:.3f}" for k, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:5])
                if busy > 0 else f"[{path}] profiled training epoch: wall "
                f"{ep_wall * 1e3:.3f} ms; device time not measured")
            if method == "joint_elbo" and n_dp == 1:
                zero_launch_counts()
                with contextlib.redirect_stdout(io.StringIO()):
                    workflows.resume_exp(
                        "synthetic", datadir, os.path.join(out, "bfloat16"),
                        runs["bfloat16"], epochs + 1, use_tensorboard=False,
                        device="cuda")
                resumed = {k: v for k, v in launch_counts().items() if v}
                after = epoch_losses(rundir, steps)
                ok = (resumed == {k: v // epochs for k, v in want.items()}
                      and len(after) == epochs + 1
                      and bool(np.isfinite(after).all())
                      and after[-1] < after[0])
                log("bf16-slice", f"[{path}] resumed for epoch {epochs + 1}"
                    f" from flags.json (precision {flags.precision}): "
                    f"launches {resumed}, mean train loss {after[-1]:.4f} "
                    f"(epoch 1 {after[0]:.4f}) ok={ok}")
                if not ok:
                    raise SystemExit(f"the resumed bf16 run is wrong")
            # the first epoch, recorded and held step by step
            with recording_train_loop() as rec:
                precision_run(datadir, os.path.join(out, "held"), 1,
                              "bfloat16", method, rate, n_dp)
            worst = max(worst, hold_bf16_epoch(rec, dims, path))
    log("bf16-slice", f"worst ratio over the held epochs {worst:.4f}")
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
        if n_samples == N_SAMPLES:
            # one flagship round's sweep, whole and over the mesh (cell
            # grid, noise, posteriors and the launches; events around
            # back-to-back calls, and the host's clock of one call)
            g = torch.Generator(device=device).manual_seed(SEED + 7)
            ms = {}
            for name, fn, extra in (
                    ("avatar_sweep", daa.avatar_sweep, ()),
                    ("avatar_sweep_sharded", daa.avatar_sweep_sharded,
                     (mesh,))):
                ev = cuda_ms(lambda: fn(model, data, scores, True, g,
                                        *extra, cfg), iters=10)
                torch.cuda.synchronize()
                start = time.perf_counter()
                fn(model, data, scores, True, g, *extra, cfg)
                torch.cuda.synchronize()
                ms[name] = (ev, 1e3 * (time.perf_counter() - start))
            log("ensemble-slice", "one flagship round's sweep on one card, "
                "events / host clock (ms): " + "; ".join(
                    f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in ms.items())
                + f" ({card})")
    by_path["daa_sharded"] = {"avatar_sweep": sharded_launches}
    return by_path


# ------------------------------------------------------------- eval slice
EVAL_EPOCHS = 4
EVAL_TRAIN = dict(method="joint_elbo", calc_nll=True, calc_prd=True,
                  calc_clf=True, calc_coherence=True, eval_freq=2,
                  eval_freq_fid=2, save_samples=True)
EVAL_FAMILIES = ("Likelihoods", "PRD", "Latent Representation",
                 "Generation")
# card against CPU on one checkpoint with the same noise: the IWAE rows
# (float32 sums in another order) to a relative 1e-4; the PRD rows (k-means
# of generations that agree to float32 rounding, where one point may change
# cluster) to 0.01 absolute; accuracies and coherences equal, or each
# differing prediction within FLIP_MARGIN of its classifier's boundary
IWAE_RTOL, PRD_ATOL, FLIP_MARGIN = 1e-4, 0.01, 1e-3
SAMPLED_DAA = dict(sampling_strategy="likelihood", n_validation=2,
                   n_samples=N_SAMPLES, n_subjects=B, M=100, seed=SEED)
SAMPLED_ROIS = 16


@contextlib.contextmanager
def timing_evals(seconds: dict):
    """Add the host-clock seconds of each eval family's functions (each
    ends in a fetch) to ``seconds`` while the block runs."""
    from multivae_tpu_torch.eval import (coherence, likelihood,
                                         representation, sample_quality)

    parts = ((likelihood, "estimate_likelihoods", "Likelihoods"),
             (sample_quality, "generate_conditional_samples",
              "cond_generation"),
             (sample_quality, "calc_prd_score", "PRD"),
             (representation, "train_clf_lr_all_subsets",
              "Latent Representation"),
             (representation, "test_clf_lr_all_subsets",
              "Latent Representation"),
             (coherence, "train_modality_classifiers", "Generation"),
             (coherence, "evaluate_coherence", "Generation"))
    saved = []
    for module, name, part in parts:
        real = getattr(module, name)

        def timed(*args, _real=real, _part=part, **kwargs):
            start = time.perf_counter()
            out = _real(*args, **kwargs)
            seconds[_part] = (seconds.get(_part, 0.0)
                              + time.perf_counter() - start)
            return out

        saved.append((module, name, real))
        setattr(module, name, timed)
    try:
        yield seconds
    finally:
        for module, name, real in saved:
            setattr(module, name, real)


def eval_train(outdir, datadir, card, complete, clinical):
    """``train_exp`` with every eval flag and ``save_samples`` on the card,
    every count set to 0 just before and read just after: the step
    kernels' launches (the cadence launches none), the four families at
    epochs 2 and 4, the sample dumps, and each cadence hit's seconds by
    part. Returns ``(run, launches)``."""
    import pandas as pd
    import torch

    from multivae_tpu_torch.train import trainer

    phase = "eval-slice"
    counters = slice_counters()
    for c in counters.values():
        for k in c:
            c[k] = 0
    hits = []
    real = trainer.run_eval_cadence

    def recording(exp, model_idx, logger, epoch_done):
        seconds = real(exp, model_idx, logger, epoch_done)
        hits.append((epoch_done, seconds))
        return seconds

    trainer.run_eval_cadence = recording
    torch.cuda.synchronize()
    start = time.perf_counter()
    try:
        run, walls = train_run(datadir, outdir, EVAL_EPOCHS, "cuda",
                               **EVAL_TRAIN)
    finally:
        trainer.run_eval_cadence = real
    total = time.perf_counter() - start
    launches = {k: c[k] for k, c in counters.items()}
    rundir = os.path.join(outdir, run)
    csv = pd.read_csv(os.path.join(rundir, "logs", "metrics.csv"))
    train_steps = np.sort(csv[csv.phase == "train"].step.unique())
    ev = csv[csv.phase.isin(EVAL_FAMILIES)]
    steps_per_epoch = len(complete) + len(clinical)
    # the epoch of each eval row: the train steps logged before it
    epochs_of = {s: int((train_steps < s).sum()) // steps_per_epoch
                 for s in ev.step.unique()}
    fid = os.path.join(rundir, "fid")
    groups = sorted(os.listdir(fid)) if os.path.isdir(fid) else []
    n_real = len(os.listdir(os.path.join(fid, "real", "rois"))) \
        if groups else 0
    whole_groups = len(set(complete))
    checks = {
        "cadence at epochs 2 and 4": sorted(epochs_of.values()) == [2, 4]
        and [e for e, _ in hits] == [2, 4],
        "four families at each": all(
            set(ev[ev.step == s].phase) == set(EVAL_FAMILIES)
            for s in epochs_of),
        "eval values finite": bool(np.isfinite(ev.value).all()),
        "accuracies in [0, 1]": bool(ev[ev.phase.isin(
            ["Latent Representation", "Generation"])].value.between(
                0, 1).all()),
        "mopoe_step launches": launches["mopoe_step"]
        == whole_groups * EVAL_EPOCHS,
        "presence_step launches": launches["presence_step"]
        == len(set(clinical)) * EVAL_EPOCHS,
        "no other kernel": all(launches[k] == 0 for k in (
            "method_step", "generic_step", "flat_adam", "dp_step",
            "dp_method_step")),
        "fid groups": groups == ["clinical", "clinical_rois", "random",
                                 "real", "rois"],
        "fid rows": n_real > 0 and all(
            len(os.listdir(os.path.join(fid, g, m))) == n_real
            for g in groups for m in ("clinical", "rois")),
    }
    log(phase, f"train_exp {EVAL_EPOCHS} epochs with calc_nll, calc_prd, "
        f"calc_clf, calc_coherence (eval_freq 2, eval_freq_fid 2) and "
        f"save_samples: {total:.3f} s (set-up and sample dumps included); "
        f"train wall per epoch {', '.join(f'{w:.4f}' for w in walls)} s; "
        f"launches {launches}; fid dump {groups}, {n_real} rows a group; "
        f"checks " + ", ".join(f"{k}={v}" for k, v in checks.items()))
    for epoch_done, seconds in hits:
        log(phase, f"cadence hit after epoch {epoch_done}: "
            f"{sum(seconds.values()):.3f} s host clock = "
            + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
            + f" ({card})")
    if not all(checks.values()):
        raise SystemExit(f"eval slice train wrong: {checks}")
    return run, launches


def _decisions(clf, x):
    """``(predictions, distance to the boundary)`` of a logistic
    regression: ``|logit|`` for two classes, the top-two gap for more."""
    d = clf.decision_function(np.asarray(x))
    if d.ndim == 1:
        return d > 0, np.abs(d)
    top = np.sort(d, axis=1)
    return d.argmax(axis=1), top[:, -1] - top[:, -2]


def flip_margins(outdir, run, family, metric):
    """The predictions behind one accuracy or coherence row, recomputed on
    the card and on the CPU: ``(flipped samples, the largest distance to
    the boundary among them on either run)``."""
    from multivae_tpu_torch.eval import (coherence, representation,
                                         sample_quality)
    from multivae_tpu_torch.train.experiment import load_trained

    exps = {dev: load_trained(outdir, run, dev)[0] for dev in ("cuda", "cpu")}
    preds, margins = {}, {}
    if family == "Latent Representation":
        for dev, exp in exps.items():
            clf = representation.train_clf_lr_all_subsets(exp)[metric]
            feats, _ = representation._subset_latents(
                exp, exp.member_datasets(0)[1], 0)
            preds[dev], margins[dev] = _decisions(clf, feats[metric])
    else:
        clfs = coherence.train_modality_classifiers(exps["cpu"])
        for dev, exp in exps.items():
            if metric == "Random":
                rand = sample_quality.generate_random_samples(exp, 0, 256)
                both = [_decisions(clfs[m], x) for m, x in rand.items()]
                preds[dev] = np.stack([p for p, _ in both])
                margins[dev] = np.min([m for _, m in both], axis=0)
            else:
                s_key, m_key = metric.split("/")
                gen, _ = sample_quality.generate_conditional_samples(exp)
                preds[dev], margins[dev] = _decisions(clfs[m_key],
                                                      gen[s_key][m_key])
    flipped = preds["cuda"] != preds["cpu"]
    if flipped.ndim > 1:
        flipped = flipped.any(axis=0)
    if not flipped.any():
        return 0, 0.0
    return int(flipped.sum()), float(np.minimum(
        margins["cuda"], margins["cpu"])[flipped].max())


def eval_compare(outdir, run, datadir, card):
    """``eval_exp`` of the run's last checkpoint on the card and on the CPU
    with the same noise (drawn on the CPU): every row held to the other
    (module constants), the wall of each command and of each part."""
    import pandas as pd
    import torch

    from multivae_tpu_torch import workflows

    phase = "eval-slice"
    tables, walls, parts = {}, {}, {}
    for dev in ("cuda", "cpu"):
        parts[dev] = {}
        with timing_evals(parts[dev]), \
                contextlib.redirect_stdout(io.StringIO()):
            if dev == "cuda":
                torch.cuda.synchronize()
            start = time.perf_counter()
            path = workflows.eval_exp("synthetic", datadir, outdir, run,
                                      device=dev)
            walls[dev] = time.perf_counter() - start
        tables[dev] = pd.read_table(path)
        os.replace(path, path.replace(".tsv", f"_{dev}.tsv"))
    card_t, host_t = tables["cuda"], tables["cpu"]
    same_rows = (list(zip(card_t.family, card_t.metric))
                 == list(zip(host_t.family, host_t.metric)))
    bad, worst = [], {}
    for (family, metric), a, b in zip(zip(card_t.family, card_t.metric),
                                      card_t.value, host_t.value):
        if family == "Likelihoods":
            err = abs(a - b) / max(abs(b), 1e-12)
            ok = err <= IWAE_RTOL
        elif family == "PRD":
            err = abs(a - b)
            ok = err <= PRD_ATOL
        else:
            err = abs(a - b)
            ok = a == b
            if not ok:
                n_flip, margin = flip_margins(outdir, run, family, metric)
                ok = n_flip > 0 and margin < FLIP_MARGIN
                log(phase, f"row {family}/{metric}: card {a!r}, CPU {b!r}; "
                    f"{n_flip} predictions differ, the farthest "
                    f"{margin:.3e} from the boundary (excused below "
                    f"{FLIP_MARGIN}): {'excused' if ok else 'NOT excused'}")
        worst[family] = max(worst.get(family, 0.0), err)
        if not ok:
            bad.append((family, metric, a, b))
    checks = {
        "same rows": same_rows and len(card_t) > 0,
        "four families": set(card_t.family) == set(EVAL_FAMILIES),
        "all rows within bounds": not bad,
        "values finite": bool(np.isfinite(card_t.value).all()),
    }
    log(phase, f"eval_exp of the last checkpoint: card {walls['cuda']:.3f}"
        f" s ({', '.join(f'{k} {v:.3f}' for k, v in parts['cuda'].items())})"
        f", CPU {walls['cpu']:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in parts["cpu"].items())
        + f"); {len(card_t)} rows; card vs CPU, largest difference per "
        f"family (Likelihoods relative, bound {IWAE_RTOL}; PRD absolute, "
        f"bound {PRD_ATOL}; accuracies equal): "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + "; checks " + ", ".join(f"{k}={v}" for k, v in checks.items())
        + f" ({card})")
    if not all(checks.values()):
        raise SystemExit(f"eval card vs CPU wrong: {checks}; rows {bad}")


def sampled_daa(root, outdir, run, datadir, card):
    """``daa_exp`` of the trained run on the card with one seed, once per
    artifact mode (full, stats-only, sampled), each in a copy of the run
    of its own: the sampled ROI indices, the sampled avatars against the
    full artifact's columns (bit for bit: both cross as float16), the
    sampled regression outputs against stats-only (bit for bit); the wall
    per round of each mode. Returns the sampled run's launches."""
    import shutil

    import torch

    from multivae_tpu_torch import workflows
    from multivae_tpu_torch.analysis import daa
    from multivae_tpu_torch.ops import fused_daa

    phase = "eval-slice"
    res, walls, launches = {}, {}, {}
    for mode in ("full", "stats-only", "sampled"):
        mode_out = os.path.join(root, f"daa_{mode}")
        shutil.copytree(os.path.join(outdir, run),
                        os.path.join(mode_out, run),
                        ignore=shutil.ignore_patterns("fid", "eval", "logs"))
        fused_daa.KERNEL_LAUNCHES["avatar_sweep"] = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res[mode] = workflows.daa_exp(
                "synthetic", datadir, mode_out, run, artifact=mode,
                sampled_rois=SAMPLED_ROIS, device="cuda", **SAMPLED_DAA)
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - start
        launches[mode] = fused_daa.KERNEL_LAUNCHES["avatar_sweep"]

    def load(mode, name):
        return np.load(os.path.join(res[mode], name), mmap_mode="r")

    want_idx = np.sort(np.random.default_rng(SEED + 17).choice(
        444, SAMPLED_ROIS, replace=False))
    idx = np.asarray(load("sampled", daa.SAMPLED_ROIS_FILE))
    sub = np.asarray(load("sampled", daa.SAMPLED_AVATARS_FILE))
    full = load("full", "rois_digital_avatars.npy")
    n_val = SAMPLED_DAA["n_validation"]
    checks = {
        "indices = default_rng(seed + 17) choice": np.array_equal(
            idx, want_idx),
        "sampled shape": sub.shape == (n_val, B, 7, N_SAMPLES,
                                       SAMPLED_ROIS),
        "sampled = full columns, bit for bit": np.array_equal(
            sub, np.asarray(full[..., idx])),
        "pvalues sampled = stats-only, bit for bit": np.array_equal(
            load("sampled", "pvalues.npy"), load("stats-only",
                                                 "pvalues.npy")),
        "coefs sampled = stats-only, bit for bit": np.array_equal(
            load("sampled", "coefs.npy"), load("stats-only", "coefs.npy")),
        "one sweep launch a round": all(v == n_val
                                        for v in launches.values()),
        "significant_rois.tsv": all(os.path.isfile(os.path.join(
            r, "significant_rois.tsv")) for r in res.values()),
    }
    log(phase, f"daa_exp of the trained run, seed {SEED}, {n_val} rounds "
        f"of B={B} x 7 scores x P={N_SAMPLES} (likelihood strategy, "
        f"float16 wire), wall per round: "
        + ", ".join(f"{m} {w / n_val:.3f} s" for m, w in walls.items())
        + f"; sweep launches {launches}; sampled ROIs {idx.tolist()}; "
        f"checks " + ", ".join(f"{k}={v}" for k, v in checks.items())
        + f" ({card})")
    if not all(checks.values()):
        raise SystemExit(f"daa sampled wrong: {checks}")
    return {"avatar_sweep": launches["sampled"]}


def eval_slice(device, card: str, root: str):
    """Phase eval-slice under ``root``: ``train_exp`` with the eval cadence
    and the sample dumps, ``eval_exp`` on the card against the CPU, and
    ``daa_exp`` with the full, stats-only and sampled artifacts (each a
    copy of the run under ``root/daa_<mode>``). Returns ``({path: {kernel:
    count}}, run)`` for the train run (``eval``) and the sampled
    ``daa``."""
    datadir, complete, clinical, _ = slice_cohort(root, "eval-slice")
    outdir = os.path.join(root, "out")
    run, launches = eval_train(outdir, datadir, card, complete, clinical)
    eval_compare(outdir, run, datadir, card)
    sampled = sampled_daa(root, outdir, run, datadir, card)
    return {"eval": launches, "daa-sampled": sampled}, run


# ---------------------------------------------------------- analysis slice
TRAVERSE = dict(n_frames=20, n_subjects=4, seed=SEED)
TRAVERSE_SCORE = 0
# the rsa command on the card against the CPU (its defaults: one round of
# 301 subjects, the latent means): the latent dissimilarities to rtol and
# atol 1e-5, the Kendall taus and their p-values to 1e-4 absolute
RSA_DIS_TOL, RSA_TAU_ATOL = 1e-5, 1e-4
COVARIATES = dict(continuous_covs=["age"], categorical_covs=["sex", "site"])
# host plotting libraries the renderers need
PLOT_LIBS = ("matplotlib", "PIL")


def walled(walls: dict, name: str, fn):
    """``fn()`` with its output swallowed; its wall on the host's clock,
    the card synchronized before and after, into ``walls[name]``."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = fn()
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - start
    return out


def avi_frames(path: str) -> int:
    """``dwTotalFrames`` of an AVI's main header, checked against its
    ``idx1`` entries."""
    raw = open(path, "rb").read()
    at = raw.index(b"avih") + 8
    total = int(np.frombuffer(raw[at + 16:at + 20], dtype="<u4")[0])
    return total if raw.count(b"00dc") == 2 * total else -1


def traverse_check(outdir, run, card, render, checks, walls):
    """``avatar-plot`` on the card (``avatar_traverse`` alone when a host
    plotting library is missing), every count set to 0 just before and
    read just after; the kernel's inputs recorded from that run, held
    against the plain version through the wrapper's CPU route (and the
    frames with them), and timed. Returns ``(launches, entry)``."""
    import torch

    from multivae_tpu_torch import workflows
    from multivae_tpu_torch.ops import fused_daa
    from multivae_tpu_torch.train.experiment import load_trained

    phase = "analysis-slice"
    datadir = os.path.join(os.path.dirname(outdir), "data")
    recorded, traversed = [], []
    real_cells, real_traverse = fused_daa.sweep_cells, workflows.avatar_traverse

    def cells(*args, **kwargs):
        recorded.append((args, kwargs))
        return real_cells(*args, **kwargs)

    def traverse(*args, **kwargs):
        out = real_traverse(*args, **kwargs)
        traversed.append(out)
        return out

    counters = {**slice_counters(),
                "avatar_sweep": fused_daa.KERNEL_LAUNCHES}
    fused_daa.sweep_cells, workflows.avatar_traverse = cells, traverse
    for c in counters.values():
        for k in c:
            c[k] = 0
    try:
        if render:
            gif = walled(walls, "avatar-plot", lambda: workflows.
                         avatar_plot_exp("synthetic", datadir, outdir, run,
                                         score=f"score_{TRAVERSE_SCORE}",
                                         device="cuda", **TRAVERSE))
        else:
            def numbers():
                exp, cfg = load_trained(outdir, run, "cuda")
                return workflows.avatar_traverse(exp, cfg, TRAVERSE_SCORE,
                                                 **TRAVERSE)
            walled(walls, "avatar-plot (avatar_traverse)", numbers)
    finally:
        fused_daa.sweep_cells = real_cells
        workflows.avatar_traverse = real_traverse
    launches = {k: c[k] for k, c in counters.items()}
    (args, kwargs), = recorded
    (traverse_values, frames), = traversed
    sp, post, cdata, eps, dims, sample = args[:6]
    method = kwargs["method"]
    n_cells = cdata.shape[0]
    n_frames = TRAVERSE["n_frames"]
    n_scores = dims.d1
    # the plain version on the same inputs, through the wrapper's CPU route
    ref = fused_daa.sweep_cells({k: v.cpu() for k, v in sp.items()},
                                tuple(t.cpu() for t in post), cdata.cpu(),
                                eps.cpu(), dims, sample, method=method)
    ker = fused_daa._launch_sweep(sp, post, cdata, eps, dims, sample, method)
    err = float((ker.cpu() - ref).abs().max())
    ref_frames = fused_daa.avatar_layout(ref, n_frames, n_scores)[
        :, TRAVERSE_SCORE].mean(dim=0).numpy()
    frames_err = float(np.abs(frames - ref_frames).max())
    checks.update({
        "avatar-plot: one avatar_sweep launch, no other kernel": launches
        == {**{k: 0 for k in launches}, "avatar_sweep": 1},
        f"avatar-plot: B=4, 20 frames x {n_scores} scores = "
        f"{20 * n_scores} cells, means": (dims.b, n_cells, sample)
        == (4, 20 * n_scores, False),
        "avatar-plot: kernel = plain (atol = rtol = 1e-4)":
            bool(torch.isfinite(ker).all()) and torch.allclose(
                ker.cpu(), ref, rtol=RTOL, atol=ATOL),
        "avatar-plot: frames = plain frames (atol = rtol = 1e-4)":
            frames.shape == (n_frames, dims.d2) and np.allclose(
                frames, ref_frames, rtol=RTOL, atol=ATOL),
        "avatar-plot: traverse of 20 values": len(traverse_values) == 20,
    })
    if render:
        avi = gif[:-4] + ".avi"
        checks["avatar-plot: GIF written"] = os.path.getsize(gif) > 0
        checks["avatar-plot: AVI of 20 frames"] = avi_frames(avi) == n_frames

    # the traverse's launch timed: in turns plain, kernel, kernel, plain by
    # CUDA graph replay, the plain version on the card
    def run_ker():
        fused_daa._launch_sweep(sp, post, cdata, eps, dims, sample, method)

    def run_ref():
        fused_daa.sweep_cells_reference(sp, post, cdata, eps, dims, sample,
                                        method)

    g = [graph_ms(run_ref, 10), graph_ms(run_ker, 20), graph_ms(run_ker, 20),
         graph_ms(run_ref, 10)]
    rows = n_cells * dims.b
    # the cells, the ROI posteriors and the weights read once (no noise at
    # the latent means), the avatars written once; the clinical encoder,
    # its content heads and the ROI decoder per row of every cell
    used = [sp[k] for k in sp if k.startswith(("enc1_Wh", "enc1_bh",
                                               "enc1_Wc", "enc1_bc",
                                               "dec2_W", "dec2_bd"))]
    flops = 2.0 * rows * (dims.d1 * dims.h + 2 * dims.h * dims.cd
                          + (dims.s2 + dims.cd) * dims.d2)
    n_sms = torch.cuda.get_device_properties(cdata.device).multi_processor_count
    entry = dict(plan=fused_daa.sweep_plan(dims, n_sms, rows)._asdict(),
                 ms=(g[1] + g[2]) / 2, plain_ms=(g[0] + g[3]) / 2,
                 max_abs_err=err, frames_max_abs_err=frames_err,
                 **bound(nbytes(cdata, *post, *used) + rows * dims.d2 * 4,
                         flops))
    log(phase, f"avatar-plot traverse: launches {launches}, "
        f"B={dims.b} x {n_cells} cells ({rows} rows), sample_latents="
        f"{sample}; plan {entry['plan']}; kernel vs plain (CPU route) "
        f"max_abs_err {err:.3e}, frames {frames_err:.3e}; kernel "
        f"{g[1]:.4f}/{g[2]:.4f} ms, plain on the card {g[0]:.4f}/{g[3]:.4f}"
        f" ms by graph replay; bound {entry['bound_ms']:.5f} ms by "
        f"{entry['bound_by']} ({card})")
    return launches, entry


def rsa_check(outdir, run, card, checks, walls, n_scores):
    """``rsa_exp`` on the card and on the CPU (the command's defaults):
    latent dissimilarities, Kendall taus and p-values held to the other."""
    from multivae_tpu_torch import workflows

    datadir = os.path.join(os.path.dirname(outdir), "data")
    rsadir = os.path.join(outdir, run, "rsa")
    res = {}
    for dev in ("cuda", "cpu"):
        taus = walled(walls, f"rsa ({dev})", lambda: workflows.rsa_exp(
            "synthetic", datadir, outdir, run, device=dev))
        res[dev] = (taus, np.load(os.path.join(
            rsadir, "latent_dissimilarity.npy")))
    (t_card, d_card), (t_cpu, d_cpu) = res["cuda"], res["cpu"]
    dis_err = float(np.abs(d_card - d_cpu).max())
    tau_err = float(np.abs(t_card[..., 0] - t_cpu[..., 0]).max())
    p_err = float(np.abs(t_card[..., 1] - t_cpu[..., 1]).max())
    n_subjects = d_card.shape[-1]
    checks.update({
        "rsa: shapes": t_card.shape == t_cpu.shape == (1, 4, 1,
                                                       n_scores + 3, 2)
        and d_card.shape == (1, 4, n_subjects, n_subjects),
        "rsa: finite": bool(np.isfinite(t_card).all()
                            and np.isfinite(d_card).all()),
        f"rsa: dissimilarities card = CPU (rtol = atol = {RSA_DIS_TOL})":
            np.allclose(d_card, d_cpu, rtol=RSA_DIS_TOL, atol=RSA_DIS_TOL),
        f"rsa: taus card = CPU (atol {RSA_TAU_ATOL})": tau_err
        <= RSA_TAU_ATOL,
        f"rsa: p-values card = CPU (atol {RSA_TAU_ATOL})": p_err
        <= RSA_TAU_ATOL,
    })
    log("analysis-slice", f"rsa_exp (1 round, {n_subjects} subjects, 4 "
        f"latents x {n_scores + 3} scores and covariates): card {walls['rsa (cuda)']:.3f} s, CPU "
        f"{walls['rsa (cpu)']:.3f} s; card vs CPU largest difference: "
        f"dissimilarity {dis_err:.3e} (of up to {float(d_cpu.max()):.3f}), "
        f"tau {tau_err:.3e}, p-value {p_err:.3e} ({card})")


def glob_one(outdir, run, name):
    """The one ``daa`` result file ``name`` under ``<outdir>/<run>``."""
    import glob

    found = glob.glob(os.path.join(outdir, run, "daa", "*", name))
    if len(found) != 1:
        raise SystemExit(f"expected one {name} under {outdir}, got {found}")
    return found[0]


def analysis_slice(root, run, card):
    """Phase analysis-slice, on the eval slice's trained run and its
    ``daa`` copies (full, stats-only, sampled). Returns ``({"avatar-plot":
    {kernel: count}}, the traverse's kernel entry)``."""
    import importlib.util

    from multivae_tpu_torch import workflows
    from multivae_tpu_torch.analysis import avatars
    from multivae_tpu_torch.viz.surface import SurfaceAtlas

    phase = "analysis-slice"
    datadir = os.path.join(root, "data")
    out = {m: os.path.join(root, f"daa_{m}") for m in ("full", "stats-only",
                                                       "sampled")}
    missing = [m for m in PLOT_LIBS if importlib.util.find_spec(m) is None]
    render = not missing
    if missing:
        log(phase, f"host libraries missing: {', '.join(missing)}; not run: "
            "avatar_plot_exp's GIF and AVI (avatar_traverse runs), "
            "analyze_avatars, the figures of assess_robustness and "
            "univariate_tests (robustness_counts and univariate_pvalues "
            "run), hist_plot_exp, daa_plot_most_connected, "
            "daa_plot_score_metric, rsa_plot_exp")
    names = [np.load(os.path.join(datadir, f), allow_pickle=True)
             for f in ("clinical_names.npy", "rois_names.npy")]
    n_scores, n_rois = len(names[0]), len(names[1])
    checks, walls = {}, {}
    launches, entry = traverse_check(out["full"], run, card, render, checks,
                                     walls)
    rsa_check(out["full"], run, card, checks, walls, n_scores)

    daa_kw = dict(SAMPLED_DAA)
    anova = walled(walls, "anova", lambda: workflows.anova_exp(
        "synthetic", datadir, out["full"], run, **daa_kw))
    checks["anova: p-values of every (round, score, ROI) in [0, 1]"] = (
        anova.shape == (1, daa_kw["n_validation"], n_scores, n_rois)
        and bool(((anova >= 0) & (anova <= 1)).all()))

    counts = {}
    for mode in ("full", "stats-only"):
        if render:
            counts[mode] = walled(
                walls, f"daa-robustness ({mode})",
                lambda: avatars.assess_robustness(
                    "synthetic", datadir, out[mode], run, **daa_kw))
        else:
            pvalues = np.load(glob_one(out[mode], run, "pvalues.npy"))
            counts[mode] = walled(
                walls, f"robustness_counts ({mode})",
                lambda: avatars.robustness_counts(
                    pvalues, *names, daa_kw["n_validation"], 1))
    checks["daa-robustness: counts full = stats-only"] = all(
        list(counts["full"][k]) == list(counts["stats-only"][k])
        and all(counts["full"][k][i].equals(counts["stats-only"][k][i])
                for i in counts["full"][k])
        for k in ("per_model", "per_vote_prop"))

    if render:
        for mode in ("full", "sampled"):
            figdir = walled(walls, f"daa-analysis ({mode})",
                            lambda: avatars.analyze_avatars(
                                "synthetic", datadir, out[mode], run,
                                **daa_kw))
            checks[f"daa-analysis ({mode}): figures"] = os.path.isfile(
                os.path.join(figdir, "avatars_vs_scores.png"))

    uni_out = os.path.join(root, "univariate")
    if render:
        pvalues, _ = walled(walls, "univariate-tests",
                            lambda: avatars.univariate_tests(
                                "synthetic", datadir, outdir=uni_out,
                                **COVARIATES))
    else:
        pvalues, _ = walled(walls, "univariate_pvalues",
                            lambda: avatars.univariate_pvalues(
                                datadir, **COVARIATES))
    sig = pvalues < 0.05 / n_scores / n_rois
    block = n_rois // 12
    driven = [int(sig[s, s * block:(s + 1) * block].sum()) for s in range(3)]
    checks["univariate: the driven blocks of scores 0-2 significant"] = (
        driven == [block] * 3)
    log(phase, f"univariate: {int(sig.sum())} significant (score, ROI) "
        f"associations of {sig.size}; in the blocks scores 0-2 drive: "
        f"{driven} of {block} each")

    if render:
        rois = names[1]
        atlas = SurfaceAtlas.synthetic(
            roi_names=sorted({str(n).rsplit("_", 1)[0] for n in rois}),
            subdiv=2).save(os.path.join(root, "atlas.npz"))
        walled(walls, "hist-plot", lambda: workflows.hist_plot_exp(
            ["synthetic"], [datadir], ["score_0"], root))
        walled(walls, "daa-plot-most-connected",
               lambda: workflows.daa_plot_most_connected(
                   "synthetic", datadir, out["full"], run, trust_level=0.0,
                   plot_associations=True, surface_atlas=atlas))
        walled(walls, "daa-plot-score-metric",
               lambda: workflows.daa_plot_score_metric(
                   "synthetic", datadir, out["full"], run, "score_0",
                   "thickness", trust_level=0.0, device="cuda"))
        walled(walls, "rsa-plot", lambda: workflows.rsa_plot_exp(
            "synthetic", datadir, out["full"], run))
        resdir = os.path.dirname(glob_one(out["full"], run, "coefs.npy"))
        for name in ("hist.png", "atlas.npz"):
            checks[f"{name} written"] = os.path.isfile(os.path.join(root,
                                                                    name))
        for name in ("most_connected_rois.png",
                     "associated_rois_for_score_0_in_thickness.png"):
            checks[f"{name} written"] = os.path.isfile(os.path.join(resdir,
                                                                    name))
        checks["dissimilarity.png written"] = os.path.isfile(os.path.join(
            out["full"], run, "rsa", "dissimilarity.png"))
    log(phase, "walls on the host's clock: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items()) + f" ({card})")
    for k, v in checks.items():
        log(phase, f"check {k}: {v}")
    if not all(checks.values()):
        raise SystemExit(f"analysis slice wrong: "
                         f"{[k for k, v in checks.items() if not v]}")
    return {"avatar-plot": launches}, entry


# every source under csrc/ and the kernels (entry points) the record lists
# ----------------------------------------------------- the bfloat16 branch
PEAK_BF16_FLOPS = 989e12   # bf16 x bf16 -> f32 on the tensor cores, dense
# the ratio rule: |kernel - plain bf16| <= BF16_RATIO |plain bf16 - plain
# f32| per loss, metric and gradient tensor; where the bf16 branch moves a
# value by no more than BF16_ROUNDOFF of its size (float32 round-off), the
# kernel matches the plain bf16 version to BF16_ROUNDOFF of that size; else
# the round-off reach (roundoff_reach) holds it
BF16_RATIO, BF16_ROUNDOFF = 0.1, 1e-5
BF16_KERNELS = ("mopoe_step_bf16", "method_step_bf16", "presence_step_bf16",
                "dp_step_bf16", "dp_method_step_bf16")
BF16_ROWS = (256, 64, 164)  # the flagship epoch's batches


def step_flops_split(batch: int, enc_passes=(1, 1), dec_passes=(1, 1)):
    """:func:`step_flops` as ``(forward, backward)``: 2 of an encoder
    hidden layer's 4 per multiply-add and 2 of every other product's 6 are
    the forward's."""
    d, s = FLAGSHIP["input_dim"], FLAGSHIP["style_dim"]
    h, cd = FLAGSHIP["hidden_dim"], FLAGSHIP["class_dim"]
    fwd = sum(enc_passes[e] * (2 * d[e] * h + 2 * h * 2 * (cd + s[e]))
              + dec_passes[e] * 2 * (s[e] + cd) * d[e] for e in range(2))
    total = step_flops(1, enc_passes, dec_passes)
    return float(fwd * batch), float((total - fwd) * batch)


def bf16_bound(route, n_bytes: float, batch: int) -> dict:
    """The bound of a bfloat16 step: bytes over the memory rate against the
    products' time, the tensor cores' share at the bf16 peak and, under
    scheme B, the backward products' (a float32 cotangent, on the FMA
    units) at the f32 peak, one after the other as the phases run them."""
    fwd, bwd = step_flops_split(batch, route.enc_passes, route.dec_passes)
    if route.kind == "mopoe":  # scheme A: every product on the tensor cores
        t_ops = (fwd + bwd) / PEAK_BF16_FLOPS
    else:
        t_ops = fwd / PEAK_BF16_FLOPS + bwd / PEAK_F32_FLOPS
    t_bytes = n_bytes / PEAK_BYTES_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# the round-off reach: where a tensor is outside the ratio rule, the plain
# bf16 version runs again with the float32 result of every product moved by
# the round-off bound of its sum (ops/bf16.py roundoff_moved): all up, all
# down, and up or down per element at random BF16_REACH_RUNS times. The
# largest distance of those runs from the plain bf16 version is how far
# float32 round-off (the order of a sum, the kernel's tile against the
# library's) reaches through the bfloat16 roundings: a value within its
# round-off of a rounding boundary rounds either way, and a metric or a
# gradient downstream moves with it. The kernel holds where it is no
# farther; a rounding point in the wrong place lies beyond that reach
# (bf16_planted_faults shows it on the card).
BF16_REACH_RUNS = 6


def split_step(out, dims) -> dict:
    """A step's ``(metrics, flat grads)`` as named tensors: ``metric j``
    (the loss is metric 0) and the split tensors."""
    from multivae_tpu_torch.params import flat_views

    m, g = out
    named = {f"metric {j}": m[j:j + 1] for j in range(m.numel())}
    named.update(flat_views(g, dims))
    return named


def distance(a, b) -> float:
    return float((a.double() - b.double()).norm())


def roundoff_reach(plain, p16, dims) -> dict:
    """Per named tensor (:func:`split_step`): the largest distance from the
    plain bf16 output ``p16`` of ``plain(True)`` run with every product's
    float32 result moved within its round-off bound."""
    from multivae_tpu_torch.ops import bf16 as bf16_ops

    runs = [(0, 1), (0, -1)] + [(SEED + i, 0) for i in range(BF16_REACH_RUNS)]
    reach = dict.fromkeys(p16, 0.0)
    for seed, sign in runs:
        with bf16_ops.roundoff_moved(seed, sign):
            moved = split_step(plain(True), dims)
        for k, v in p16.items():
            reach[k] = max(reach[k], distance(moved[k], v))
    return reach


def judge_bf16(ker, plain, dims):
    """Each named tensor of a bf16 step ``ker`` against ``plain(True)`` (the
    plain bf16 version) and ``plain(False)`` (the plain f32 one): held by
    the ratio rule, by round-off where the bf16 branch moves it by round-off
    alone, or by the round-off reach (computed only if a tensor needs it).
    Returns ``(p16 named, {name: (rule or None, distance, ratio, reach)})``;
    rule None is a tensor outside all three."""
    import math

    import torch

    p16, p32 = plain(True), plain(False)
    if isinstance(p16[0], torch.Tensor) and p16[0].is_cuda:
        torch.cuda.synchronize()
    kv, v16, v32 = (split_step(x, dims) for x in (ker, p16, p32))
    verdict, reach = {}, None
    for k in kv:
        d, ref = distance(kv[k], v16[k]), distance(v16[k], v32[k])
        size = float(v16[k].double().norm())
        ratio = d / ref if ref > 0 else (0.0 if d == 0 else math.inf)
        if d <= BF16_RATIO * ref:
            verdict[k] = ("ratio", d, ratio, None)
        elif ref <= BF16_ROUNDOFF * size and d <= BF16_ROUNDOFF * size:
            verdict[k] = ("round-off", d, ratio, None)
        else:
            reach = reach or roundoff_reach(plain, v16, dims)
            verdict[k] = ("reach" if d <= reach[k] else None, d, ratio,
                          reach[k])
    return v16, verdict


def hold_bf16(name, ker, plain, dims, tag, phase="bf16-kernel"):
    """Hold one step's ``(metrics, grads)`` of a bfloat16 kernel to its
    plain bf16 version per metric and per split tensor (:func:`judge_bf16`;
    ``plain(bf16)`` computes the plain version); returns the worst ratio of
    the tensors the ratio rule holds and the largest absolute difference
    from the plain bf16 version. Raises on a tensor outside the rule and
    the round-off reach, or a value not finite."""
    import torch

    torch.cuda.synchronize()
    km, kg = ker
    if not (torch.isfinite(km).all() and torch.isfinite(kg).all()):
        raise SystemExit(f"{name} {tag}: values not finite")
    v16, verdict = judge_bf16(ker, plain, dims)
    kv = split_step(ker, dims)
    max_err = max(float((kv[k] - v16[k]).abs().max()) for k in kv)
    held = [(r, k) for k, (rule, _, r, _) in verdict.items()
            if rule == "ratio"]
    worst, where = max(held) if held else (0.0, "")
    reached = [f"{k} {d:.3e} <= {reach:.3e} (ratio {r:.3f})"
               for k, (rule, d, r, reach) in verdict.items()
               if rule == "reach"]
    bad = [f"{k} {d:.3e} > {reach:.3e} (ratio {r:.3f})"
           for k, (rule, d, r, reach) in verdict.items() if rule is None]
    n_round = sum(rule == "round-off" for rule, *_ in verdict.values())
    log(phase, f"{name} {tag}: loss {float(km[0]):.6f}, plain bf16 "
        f"{float(v16['metric 0'][0]):.6f}; worst ratio |kernel - plain bf16|"
        f" / |plain bf16 - plain f32| {worst:.4f} ({where}) over "
        f"{len(held)} of {len(verdict)} tensors, {n_round} at round-off, "
        f"max_abs_err {max_err:.3e}"
        + (f"; within the round-off reach: {'; '.join(reached)}"
           if reached else "")
        + (" ok" if not bad else "; OUTSIDE: " + "; ".join(bad)))
    if bad:
        raise SystemExit(f"{name} disagrees with its plain bf16 version "
                         f"({tag})")
    return worst, max_err


def kernel_registers(log_text: str) -> dict:
    """ptxas' registers, stack and spills per kernel entry (``-v``),
    keyed by the entry's mangled name."""
    import re

    out, current = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[current].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


def sass_hmma_counts(library) -> dict:
    """The count of bf16 ``HMMA`` instructions in each kernel function of a
    built library (``cuobjdump --dump-sass``)."""
    import re

    from multivae_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "--dump-sass", str(library)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts, current = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = 0
        elif current is not None and re.search(r"\bHMMA\.\S*BF16", line):
            counts[current] += 1
    return counts


def instance(mangled: str) -> str:
    """``kernel<bf16>`` / ``kernel<f32>`` of a persistent kernel's mangled
    name (the template argument ``ILb1E`` / ``ILb0E``)."""
    import re

    m = re.search(r"([a-z]+_steps_kernel)ILb([01])E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{'bf16' if m.group(2) == '1' else 'f32'}>"


@contextlib.contextmanager
def rounded_decoder_outputs(dims):
    """A planted fault in the plain versions: every decoder output (the
    ``[B, d]`` mean the NLL takes) rounded to bfloat16, a rounding point
    where the kernels' loss epilogue has none."""
    from multivae_tpu_torch.ops import bf16 as bf16_ops
    from multivae_tpu_torch.ops import fused_methods as fm
    from multivae_tpu_torch.ops import fused_step as fs

    dot = bf16_ops.dot

    def rounded(a, b, bf16):
        r = dot(a, b, bf16)
        if bf16 and r.shape[0] == dims.b and r.shape[-1] in (dims.d1,
                                                             dims.d2):
            return bf16_ops.round_bf16(r)
        return r
    saved = fs.dot, fm.dot
    fs.dot = fm.dot = rounded
    try:
        yield
    finally:
        fs.dot, fm.dot = saved


def bf16_planted_faults(device):
    """The check of :func:`hold_bf16` against rounding faults planted in
    the plain bf16 version on the card at B=256, each of which it must
    refuse: the float32 loss and metrics beside the bf16 gradients, every
    decoder output rounded before the loss (a wrong rounding point in the
    loss epilogue), and one small bias gradient (the present encoder's
    style log-variance, 3 or 20 wide) and the decoder's output bias rounded
    to bfloat16 (bias gradients are float32 sums). Returns the count of
    faults refused."""
    import torch

    from multivae_tpu_torch.ops import bf16 as bf16_ops
    from multivae_tpu_torch.ops import fused_step as fs
    from multivae_tpu_torch.params import flat_views

    consts = fs.FusedConsts(1.0, 0.7, 1.2)
    _, dims, p, _, _, _ = train_setup(device, 256, SEED + 31)
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    refused = 0
    for route in (Route("mopoe", bf16=True),
                  Route("method", "poe", masked=True, bf16=True),
                  Route("presence", "jsd", 1, bf16=True)):
        f32 = Route(route.kind, route.method, route.mod_idx, route.masked)
        inp = route.inputs(dims, gen, device)

        def plain(bf16):
            return (route if bf16 else f32).step("plain", p, inp, dims,
                                                 consts)
        (m16, g16), (m32, _) = plain(True), plain(False)
        with rounded_decoder_outputs(dims):
            faults = {"float32 loss and metrics": (m32, g16),
                      "decoder outputs rounded before the loss":
                          plain(True)}
        e = 2 if route.mod_idx == 1 else 1
        for name in (f"enc{e}_bslv", f"dec{e}_bd"):
            g = g16.clone()
            view = flat_views(g, dims)[name]
            view.copy_(bf16_ops.round_bf16(view))
            faults[f"{name} rounded"] = (m16, g)
        for fault, ker in faults.items():
            _, verdict = judge_bf16(ker, plain, dims)
            out = [f"{k} {d:.3e} (ratio {r:.3f}"
                   + (f", reach {reach:.3e})" if reach is not None else ")")
                   for k, (rule, d, r, reach) in verdict.items()
                   if rule is None]
            log("bf16-kernel", f"planted fault in the plain "
                f"{route.name} B=256, {fault}: "
                + (f"refused, {len(out)} tensors outside: "
                   + "; ".join(out[:4]) + ("; ..." if len(out) > 4 else "")
                   if out else "NOT REFUSED"))
            if not out:
                raise SystemExit(f"the bf16 check let a planted fault pass "
                                 f"({route.name}: {fault})")
            refused += 1
    return refused


def bf16_kernel_check(device):
    """Phase bf16-kernel: the bfloat16 instances of the three persistent
    step kernels. Every route of :func:`all_routes` in bf16 (one-step
    launches at B=256, 64 and 164) held to the plain bf16 version on the
    card by the ratio rule against the plain f32 version; every route's
    8-step launch bit-equal to its one-step launches; the row-slice entry
    points of the complete routes over 4 shards, each shard by the ratio
    rule and the slice that is the whole batch bit-equal to the unsharded
    kernel; f32 and bf16 times per step side by side with each bf16 bound;
    registers and spills per instance and the bf16 HMMA count in each
    kernel's SASS. Returns the record entries of :data:`BF16_KERNELS`."""
    import torch

    from multivae_tpu_torch.ops import _build
    from multivae_tpu_torch.ops import adam as adam_ops
    from multivae_tpu_torch.ops import fused_step as fs

    consts = fs.FusedConsts(1.0, 0.7, 1.2)
    hyper = adam_ops.AdamHyper(2e-3, 0.9, 0.999)
    result = {k: {"max_abs_err": 0.0, "worst_ratio": 0.0, "variants": {}}
              for k in BF16_KERNELS}

    # the instances: registers and spills, and the tensor-core products
    hmma = {}
    for source in ("mopoe_step", "method_step", "presence_step"):
        regs = kernel_registers(BUILD_LOGS.get(source, ""))
        counts = sass_hmma_counts(_build.library_path(source))
        for mangled, r in regs.items():
            log("bf16-kernel", f"{source}.cu {instance(mangled)}: "
                f"{r.get('registers')} registers, {r.get('stack')} B stack, "
                f"spill stores {r.get('spill_stores')} B, loads "
                f"{r.get('spill_loads')} B")
        for mangled, n in counts.items():
            if "_steps_kernel" in mangled:
                hmma[instance(mangled)] = n
                log("bf16-kernel", f"{source}.cu {instance(mangled)}: {n} "
                    f"bf16 HMMA instructions in the SASS")
        kernel = f"{source.replace('_step', '')}_steps_kernel"
        if hmma.get(f"{kernel}<bf16>", 0) < 1:
            raise SystemExit(f"{source}: the bf16 instance has no HMMA")
        if hmma.get(f"{kernel}<f32>", 0) != 0:
            raise SystemExit(f"{source}: the f32 instance has HMMA")
        result[f"{source}_bf16"]["sass_hmma"] = hmma[f"{kernel}<bf16>"]
        result[f"{source}_bf16"]["ptxas"] = {
            instance(k): v for k, v in regs.items()}
    result["dp_step_bf16"]["sass_hmma"] = result["mopoe_step_bf16"][
        "sass_hmma"]
    result["dp_method_step_bf16"]["sass_hmma"] = result["method_step_bf16"][
        "sass_hmma"]

    routes = [Route(r.kind, r.method, r.mod_idx, r.masked, bf16=True)
              for r in all_routes()]
    def record(key, worst, err):
        entry = result[key]
        entry["worst_ratio"] = max(entry["worst_ratio"], worst)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)

    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    for b in BF16_ROWS:
        cfg, dims, p, _, _, _ = train_setup(device, b, SEED + b)
        for route in routes:
            # B=256 every route, 64 the complete ones, 164 the presence ones
            if b == 64 and route.kind == "presence" or (
                    b == 164 and route.kind != "presence"):
                continue
            inp = route.inputs(dims, gen, device)
            f32 = Route(route.kind, route.method, route.mod_idx,
                        route.masked)
            ker = route.step("kernel", p, inp, dims, consts)
            record(f"{route.kernel}_bf16", *hold_bf16(
                route.name, ker, lambda bf16: (route if bf16 else f32).step(
                    "plain", p, inp, dims, consts), dims, f"B={b}"))

    n_faults = bf16_planted_faults(device)

    # a group of steps in one launch is its steps one by one, bit for bit
    cfg, dims, p0, _, _, _ = train_setup(device, 256, SEED)
    launch_gen = torch.Generator(device=device).manual_seed(SEED + 14)
    for route in routes:
        launch_vs_steps(route, p0, dims, consts, hyper, launch_gen, device,
                        phase="bf16-kernel")
    for route in routes:
        if route.kind == "method":
            launch_vs_steps(route, p0, dims._replace(b=64), consts, hyper,
                            launch_gen, device, phase="bf16-kernel")
    geo = {r.name: r.geometry(dims, device) for r in routes
           if r.name in ("mopoe_step[bf16]", "method_step[poe, masks, bf16]",
                         "presence_step[joint_elbo, mod_idx=0, bf16]")}
    log("bf16-kernel", "bf16 instances at B=256, cooperative grid blocks "
        "and grid barriers per step (with Adam / one step without): "
        + "; ".join(f"{k} {v['grid_blocks']} blocks, "
                    f"{v['barriers_per_step_adam']} / "
                    f"{v['barriers_per_step']} barriers"
                    for k, v in geo.items()))

    # the row-slice entry points: 4 shards of 64 rows
    n_dev = 4
    local = dims._replace(b=dims.b // n_dev)
    for route in routes:
        if route.kind == "presence":
            continue
        f32 = Route(route.kind, route.method, route.mod_idx, route.masked)
        inp = route.inputs(dims, gen, device)
        whole = route.step("kernel", p0, inp, dims, consts)
        same = route.slice_step("kernel", p0, inp, dims, consts, True, 0,
                                dims.b)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(same, whole)):
            raise SystemExit(f"{route.dp_kernel}_bf16 of {route.name} with "
                             f"row_offset=0, b_total=b is not the unsharded "
                             f"kernel bit for bit")
        kers, _ = sharded(route, "kernel", p0, inp, dims, consts, n_dev)
        for k in range(n_dev):
            rows = slice(k * local.b, (k + 1) * local.b)

            def plain(bf16, rows=rows, k=k):
                return (route if bf16 else f32).slice_step(
                    "plain", p0, shard_inputs(inp, rows), local, consts,
                    True, k * local.b, dims.b)
            record(f"{route.dp_kernel}_bf16", *hold_bf16(
                f"{route.dp_kernel} of {route.name}", kers[k], plain, local,
                f"B=256 shard {k} of {n_dev}"))
        log("bf16-kernel", f"{route.dp_kernel} of {route.name}: "
            f"row_offset=0 b_total=b equal bits to the unsharded bf16 "
            f"kernel ok")

    # ---- times: f32 and bf16 side by side; plain bf16, kernel f32, kernel
    # bf16, kernel bf16, kernel f32, plain bf16
    headline = {"mopoe_step": "mopoe_step[bf16]",
                "method_step": "method_step[poe, bf16]",
                "presence_step": "presence_step[joint_elbo, mod_idx=0, bf16]"}
    p = p0.clone()
    for route in routes:
        f32 = Route(route.kind, route.method, route.mod_idx, route.masked)
        inp = route.inputs(dims, gen, device)
        t = [cuda_ms(lambda: route.step("plain", p, inp, dims, consts), 10),
             cuda_ms(lambda: f32.step("kernel", p, inp, dims, consts), 30),
             cuda_ms(lambda: route.step("kernel", p, inp, dims, consts), 30),
             cuda_ms(lambda: route.step("kernel", p, inp, dims, consts), 30),
             cuda_ms(lambda: f32.step("kernel", p, inp, dims, consts), 30),
             cuda_ms(lambda: route.step("plain", p, inp, dims, consts), 10)]
        l16 = time_launch(route, p0, dims, consts, hyper, gen, device,
                          "bf16-kernel")
        l32 = time_launch(f32, p0, dims, consts, hyper, gen, device,
                          "bf16-kernel")
        entry = dict(ms=(t[2] + t[3]) / 2, plain_ms=(t[0] + t[5]) / 2,
                     f32_ms=(t[1] + t[4]) / 2, library_ms=None,
                     step_ms_in_launch=l16["step_ms_in_launch"],
                     f32_step_ms_in_launch=l32["step_ms_in_launch"],
                     phase_us=l16["phase_us"], **route.bound(p, inp, dims))
        result[f"{route.kernel}_bf16"]["variants"][route.name] = entry
        if headline[route.kernel] == route.name:
            result[f"{route.kernel}_bf16"].update(entry,
                                                  timed_variant=route.name)
        log("bf16-kernel", f"{route.name} B=256: one-step launch bf16 "
            f"{t[2]:.4f}/{t[3]:.4f} ms, f32 {t[1]:.4f}/{t[4]:.4f} ms, plain "
            f"bf16 {t[0]:.4f}/{t[5]:.4f} ms; per step in a 6-step launch "
            f"bf16 {l16['step_ms_in_launch']:.4f} ms, f32 "
            f"{l32['step_ms_in_launch']:.4f} ms; bf16 bound "
            f"{entry['bound_ms']:.5f} ms by {entry['bound_by']} = "
            f"{100 * entry['bound_ms'] / l16['step_ms_in_launch']:.2f} % of "
            f"the bound's rate in a launch")
    for route in routes:
        if route.name not in ("mopoe_step[bf16]",
                              "method_step[poe, masks, bf16]"):
            continue
        inp = route.inputs(dims, gen, device)
        sl = shard_inputs(inp, slice(local.b, 2 * local.b))
        t = [cuda_ms(lambda: route.slice_step("plain", p, sl, local, consts,
                                              True, local.b, dims.b), 10),
             cuda_ms(lambda: route.slice_step("kernel", p, sl, local, consts,
                                              True, local.b, dims.b), 30),
             cuda_ms(lambda: route.slice_step("kernel", p, sl, local, consts,
                                              True, local.b, dims.b), 30),
             cuda_ms(lambda: route.slice_step("plain", p, sl, local, consts,
                                              True, local.b, dims.b), 10)]
        variant = f"{route.dp_kernel} of {route.name}, rows 64-127 of 256"
        entry = dict(ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
                     library_ms=None, **route.bound(p, sl, local))
        key = f"{route.dp_kernel}_bf16"
        result[key]["variants"][variant] = entry
        result[key].update(entry, timed_variant=variant)
        log("bf16-kernel", f"{variant}: kernel {t[1]:.4f}/{t[2]:.4f} ms, "
            f"plain bf16 {t[0]:.4f}/{t[3]:.4f} ms per slice step; bound "
            f"{entry['bound_ms']:.5f} ms by {entry['bound_by']}")
    log("bf16-kernel", "worst ratio per kernel: " + ", ".join(
        f"{k} {result[k]['worst_ratio']:.4f}" for k in BF16_KERNELS)
        + f"; planted faults refused {n_faults}")
    return result


SOURCES = ("avatar_sweep", "mopoe_step", "presence_step", "flat_adam",
           "method_step", "generic_step")
KERNELS = SOURCES + ("dp_step", "dp_method_step")
SOURCE_OF = {**{k: k for k in SOURCES}, "dp_step": "mopoe_step",
             "dp_method_step": "method_step"}
SOURCE_OF.update({f"{k}_bf16": SOURCE_OF[k] for k in (
    "mopoe_step", "method_step", "presence_step", "dp_step",
    "dp_method_step")})
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
                 "multivae_tpu/ops/fused_methods.py:382",
    # the bfloat16 instances: the matmul_bf16 branch of the same bodies
    "mopoe_step_bf16": "multivae_tpu/ops/fused_step.py:505, "
                       "multivae_tpu/ops/fused_step.py:587",
    "method_step_bf16": "multivae_tpu/ops/fused_methods.py:341",
    "presence_step_bf16": "multivae_tpu/ops/fused_presence.py:247",
    "dp_step_bf16": "multivae_tpu/ops/fused_sharded.py:69",
    "dp_method_step_bf16": "multivae_tpu/ops/fused_sharded.py:110"}


BUILD_LOGS = {}  # nvcc's output per source, from the build phase


# ------------------------------------------------------------------------
# the general step's routes: tensor parallel, the data-parallel general step
GENERAL_EPOCHS = 2
TP_SLICES = (("train tp 4", 4, 1), ("train tp 2x2", 2, 2))  # (path, T, D)
DP_GENERAL_SLICES = (
    ("train dp-general deep-A joint_elbo", dict(
        num_hidden_layer_decoder=1, out_scale_per_subject=True), False),
    ("train dp-general four-block joint_elbo", dict(
        input_dims=FOUR_BLOCK["input_dim"],
        style_dim=FOUR_BLOCK["style_dim"]), True),
    ("train dp-general flagship fused_training=False",
     dict(fused_training=False), False),
)
# a step held to the plain single-entry step: the loss at rtol 1e-5, the
# metrics at rtol 1e-4 / atol 1e-5, each tensor's gradient by its relative
# L2 distance (a ReLU whose input lies within float32 round-off of 0 may
# take the other branch for one row in another order of the sums)
GENERAL_GRAD_REL = 1e-3


@contextlib.contextmanager
def holding_general_steps(name: str):
    """Wrap the trainer's ``name`` (``tp_step`` or ``dp_general_step``):
    each call's state is cloned before it, and after it the plain
    single-entry step (``train_step.general_grads``: autograd of the
    model on the whole batch, on the state's device) recomputes the step
    from the clone and is held to the call's loss, metrics and the
    gradient its Adam update took. The run goes on from the call's own
    state. Yields the running record."""
    import copy

    import torch

    from multivae_tpu_torch.ops import fused_sharded
    from multivae_tpu_torch.params import flat_views
    from multivae_tpu_torch.train import train_step, trainer

    real, real_update = getattr(trainer, name), fused_sharded.adam_update
    rec = {"steps": 0, "loss": 0.0, "metric": 0.0, "grad": 0.0,
           "grad_at": "", "failed": []}
    seen, scratch = {}, {}

    def update(p, mu, nu, g, t, hyper):
        seen["g"] = g.clone()
        return real_update(p, mu, nu, g, t, hyper)

    def step(cfg, model, p, opt, batch, noise, dims, hyper, mesh,
             masks=None):
        p0 = p.clone()
        out = real(cfg, model, p, opt, batch, noise, dims, hyper, mesh,
                   masks)
        if not isinstance(model, torch.nn.Module):
            model = model(p.device)      # the replicas of the dp step
        plain = scratch.setdefault(id(model), copy.deepcopy(model))
        loss, metrics, g = train_step.general_grads(cfg, plain, p0, batch,
                                                    noise, dims, masks)
        i = rec["steps"]
        rec["steps"] += 1
        err = abs(float(out[1]) - float(loss)) / abs(float(loss))
        rec["loss"] = max(rec["loss"], err)
        if err > 1e-5:
            rec["failed"].append(f"step {i} loss {err:.3e}")
        for k, v in metrics.items():
            d = abs(float(out[2][k]) - float(v))
            rec["metric"] = max(rec["metric"], d)
            if d > 1e-5 + 1e-4 * abs(float(v)):
                rec["failed"].append(f"step {i} {k} {d:.3e}")
        got, want = flat_views(seen.pop("g"), dims), flat_views(g, dims)
        for k in want:
            rel = float(torch.linalg.vector_norm(got[k] - want[k])
                        / torch.linalg.vector_norm(want[k]).clamp_min(1e-30))
            if rel > rec["grad"]:
                rec["grad"], rec["grad_at"] = rel, f"step {i} {k}"
            if rel > GENERAL_GRAD_REL:
                rec["failed"].append(f"step {i} grad {k} {rel:.3e}")
        return out

    setattr(trainer, name, step)
    fused_sharded.adam_update = update
    try:
        yield rec
    finally:
        setattr(trainer, name, real)
        fused_sharded.adam_update = real_update


def general_route_run(phase, path, datadir, root, card, step_name, **kw):
    """``train_exp`` on the card for ``GENERAL_EPOCHS`` epochs, every batch
    on ``step_name`` held step by step (:func:`holding_general_steps`),
    with every count set to 0 just before and read just after: the route
    launches ``flat_adam`` once a step and no other kernel. Prints the
    mesh's entries and the wall per epoch of the same run without the
    hold; returns the launches of the held run."""
    import pandas as pd

    from multivae_tpu_torch.models import build_model, make_modalities
    from multivae_tpu_torch.train.routes import Routes

    width = dict(input_dim=kw.get("input_dims", SLICE_TRAIN["input_dims"]),
                 style_dim=kw.get("style_dim", SLICE_TRAIN["style_dim"]))
    cfg = flagship_cfg(**width, **{k: v for k, v in kw.items() if k in (
        "num_hidden_layer_decoder", "data_parallel", "tensor_parallel",
        "fused_training")}, learn_output_sample_scale=kw.get(
            "out_scale_per_subject", False))
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu")
    mesh = Routes(cfg, model, "cuda:0").step_mesh
    log(phase, f"{path}: mesh {mesh}")
    zero_launch_counts()
    with holding_general_steps(step_name) as rec:
        run, walls = train_run(datadir, os.path.join(root, path.replace(
            " ", "_")), GENERAL_EPOCHS, "cuda", **kw)
    counts = launch_counts()
    # the same run without the hold, whose plain recomputation and
    # per-metric fetches would be inside the walls
    _, clean = train_run(datadir, os.path.join(root, path.replace(
        " ", "_") + "_clean"), GENERAL_EPOCHS, "cuda", **kw)
    rundir = os.path.join(root, path.replace(" ", "_"), run)
    csv = pd.read_csv(os.path.join(rundir, "logs", "metrics.csv"))
    losses = csv[(csv.phase == "train") & (csv.metric == "loss")].value
    steps = GENERAL_EPOCHS * (len(EPOCH_COMPLETE) + len(EPOCH_PRESENCE))
    checks = {
        f"{steps} steps held": rec["steps"] == steps,
        "every step within bounds": not rec["failed"],
        f"flat_adam {steps}": counts["flat_adam"] == steps,
        "no step kernel": not any(v for k, v in counts.items()
                                  if k != "flat_adam"),
        "losses finite": bool(np.isfinite(losses).all()),
        "checkpoint": os.path.isfile(os.path.join(
            rundir, "checkpoints", f"{GENERAL_EPOCHS - 1:04d}",
            "model.npz")),
    }
    log(phase, f"{path}: wall per epoch (s) {clean} ({walls} with every "
        f"step held); steps against the "
        f"plain single-entry step: largest loss rel {rec['loss']:.3e}, "
        f"metric abs {rec['metric']:.3e}, gradient rel L2 "
        f"{rec['grad']:.3e} ({rec['grad_at']}); launches "
        f"{ {k: v for k, v in counts.items() if v} }; mean loss epoch 1 "
        f"{losses.iloc[:8].mean():.4f} -> epoch {GENERAL_EPOCHS} "
        f"{losses.iloc[-8:].mean():.4f}; checks "
        + ", ".join(f"{k}={v}" for k, v in checks.items()) + f" ({card})")
    if not all(checks.values()):
        raise SystemExit(f"{phase} {path}: {checks} {rec['failed'][:5]}")
    return counts


def tp_slice(datadir, root, card):
    """Phase tp-slice: ``train_exp(tensor_parallel=4)`` and
    ``(tensor_parallel=2, data_parallel=2)`` at the flagship widths, every
    step held to the plain single-entry step from the card's own state.
    Returns the launches, ``{path: {kernel: count}}``."""
    return {path: general_route_run(
        "tp-slice", path, datadir, root, card, "tp_step",
        tensor_parallel=t, data_parallel=d) for path, t, d in TP_SLICES}


def dp_general_slice(datadir, four_block_dir, root, card):
    """Phase dp-general-slice: ``train_exp(data_parallel=4)`` of deep-A and
    the four-block joint_elbo (the configs the method step does not take),
    and of the flagship with ``fused_training=False``, every step held to
    the plain single-entry step. Returns the launches."""
    return {path: general_route_run(
        "dp-general-slice", path, four_block_dir if four else datadir, root,
        card, "dp_general_step", data_parallel=DATA_PARALLEL, **kw)
        for path, kw, four in DP_GENERAL_SLICES}


def profile_slice(datadir, root, card):
    """Phase profile-slice: ``train --profile-dir`` through the CLI on the
    card (2 epochs of the flagship joint_elbo): the first epoch's Chrome
    trace holds every launch of the MoPoE and presence step kernels in that
    epoch (half of the two epochs' counts: both epochs have the same
    batches); each kernel's device ms from the trace, and how many of the
    tracer's warm-up kernels the trace kept (fewer than launched: the
    session lost its first records, which the warm-up absorbed). Returns
    the launches."""
    from multivae_tpu_torch import cli
    from multivae_tpu_torch.train import profiling

    phase = "profile-slice"
    trace_dir = os.path.join(root, "trace")
    zero_launch_counts()
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["train", "--dataset", "synthetic", "--datasetdir",
                  datadir, "--outdir", os.path.join(root, "profiled"),
                  "--input-dims", "7", "444", "--latent-dim", "20",
                  "--style-dim", "3", "20", "--batch-size", "256",
                  "--num-epochs", "2", "--use-tensorboard", "false",
                  "--profile-dir", trace_dir, "--device", "cuda"])
    wall = time.perf_counter() - start
    counts = launch_counts()
    files = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, "epoch_0000.pt.trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    kernel_ms = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            kernel_ms[ev["name"]] = kernel_ms.get(ev["name"], 0.0) + float(
                ev.get("dur", 0.0)) / 1e3
    in_trace = {k: sum(1 for ev in events if ev.get("cat") == "kernel"
                       and k in ev["name"])
                for k in ("mopoe_steps_kernel", "presence_steps_kernel",
                          profiling.WARM_UP_KERNEL)}
    top = sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:4]
    checks = {"one trace": files == ["epoch_0000.pt.trace.json"],
              "mopoe_step 4, presence_step 4": (
                  counts["mopoe_step"], counts["presence_step"]) == (4, 4),
              **{f"{k} x2 in the trace": in_trace[k] == 2
                 for k in ("mopoe_steps_kernel", "presence_steps_kernel")}}
    log(phase, f"train --profile-dir: {wall:.3f} s for 2 epochs, "
        f"{len(events)} trace events, kernels in the trace {in_trace} (the "
        f"tracer's warm-up launched {profiling.WARM_UP_LAUNCHES} "
        f"{profiling.WARM_UP_KERNEL}), device ms by kernel (top 4) "
        + ", ".join(f"{n[:48]} {ms:.4f}" for n, ms in top)
        + "; checks " + ", ".join(f"{k}={v}" for k, v in checks.items())
        + f" ({card})")
    if not all(checks.values()):
        raise SystemExit(f"{phase}: {checks}")
    return {"train --profile-dir": counts}


def write_jax_layout_run(root, cfg, fmt: str, count: int = 40) -> str:
    """A flagship run directory with seeded weights and Adam state at
    epoch 4: the JAX package's files (``model``, ``opt_state``, msgpack
    from :func:`flax_msgpack_bytes`) or the port's ``.npz``."""
    import torch

    from multivae_tpu_torch.models import build_model, make_modalities
    from multivae_tpu_torch.ops.adam import AdamState
    from multivae_tpu_torch.params import (dims_from, model_flat_params,
                                           split_flat_to_ravel,
                                           state_dict_to_tree)
    from multivae_tpu_torch.train.checkpoint import save_checkpoint

    run = "synthetic_jax_layout"
    rundir = os.path.join(root, fmt, run)
    ckpt = os.path.join(rundir, "checkpoints", "0004")
    os.makedirs(ckpt)
    cfg.save(os.path.join(rundir, "flags.json"))
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu")
    dims = dims_from(cfg, cfg.batch_size)
    gen = torch.Generator().manual_seed(SEED)
    p = model_flat_params(model, dims)
    mu = 1e-3 * torch.randn(p.shape, generator=gen)
    nu = 1e-6 * torch.rand(p.shape, generator=gen)
    if fmt == "npz":
        save_checkpoint(ckpt, model, AdamState(count, mu, nu),
                        dims=dims)
        return run
    names = model.mod_names
    with open(os.path.join(ckpt, "opt_state"), "wb") as fh:
        fh.write(flax_msgpack_bytes({
            "count": np.asarray(count, np.int32),
            "mu": split_flat_to_ravel(mu, dims, names),
            "nu": split_flat_to_ravel(nu, dims, names)}))
    with open(os.path.join(ckpt, "model"), "wb") as fh:
        fh.write(flax_msgpack_bytes(state_dict_to_tree(model.state_dict())))
    return run


def jax_checkpoint_slice(datadir, root, card):
    """Phase jax-checkpoint-slice: a flagship run directory in the JAX
    package's layout (msgpack, written here) and the same run in the
    port's (``.npz``): ``daa_exp`` of each on the card (the sweep kernel)
    and one resumed epoch of each, their outputs equal bit for bit.
    Returns the launches of the JAX-layout run's two paths."""
    import warnings

    from multivae_tpu_torch import workflows
    from multivae_tpu_torch.ops import fused_daa

    phase = "jax-checkpoint-slice"
    cfg = flagship_cfg(dataset="synthetic", datasetdir=datadir,
                       batch_size=256, seed=SEED, end_epoch=5)
    runs = {fmt: write_jax_layout_run(root, cfg, fmt)
            for fmt in ("jax", "npz")}
    size = os.path.getsize(os.path.join(root, "jax", runs["jax"],
                                        "checkpoints", "0004", "model"))
    by_path, out, walls = {}, {}, {}
    for fmt, run in runs.items():
        outdir = os.path.join(root, fmt)
        fused_daa.KERNEL_LAUNCHES["avatar_sweep"] = 0
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            resdir = workflows.daa_exp(
                "synthetic", datadir, outdir, run, n_validation=1,
                n_samples=50, n_subjects=50, M=100, device="cuda")
        walls[f"daa {fmt}"] = time.perf_counter() - start
        daa_launches = fused_daa.KERNEL_LAUNCHES["avatar_sweep"]
        zero_launch_counts()
        start = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught, \
                contextlib.redirect_stdout(io.StringIO()):
            warnings.simplefilter("always")
            workflows.resume_exp("synthetic", datadir, outdir, run, 6,
                                 use_tensorboard=False, device="cuda")
        walls[f"resume {fmt}"] = time.perf_counter() - start
        ckpt = os.path.join(outdir, run, "checkpoints", "0005")
        out[fmt] = {
            "daa": {n: np.load(os.path.join(resdir, n)) for n in (
                "pvalues.npy", "coefs.npy", "rois_digital_avatars.npy")},
            "resume": {f"{f}/{k}": v[k] for f in ("model.npz",
                                                   "opt_state.npz")
                       for v in [np.load(os.path.join(ckpt, f))]
                       for k in v.files},
            "warned": any("threefry" in str(w.message) for w in caught)}
        if fmt == "jax":
            by_path["daa of a JAX-layout run"] = {
                "avatar_sweep": daa_launches}
            by_path["resume of a JAX-layout run"] = launch_counts()

    def same(part):
        a, b = out["jax"][part], out["npz"][part]
        return sorted(a) == sorted(b) and all(
            np.array_equal(a[k], b[k]) for k in a)

    resumed = by_path["resume of a JAX-layout run"]
    checks = {"daa equal bits": same("daa"),
              "resumed epoch equal bits": same("resume"),
              "avatar_sweep launched": by_path[
                  "daa of a JAX-layout run"]["avatar_sweep"] > 0,
              "mopoe_step 2, presence_step 2": (
                  resumed["mopoe_step"], resumed["presence_step"]) == (2, 2),
              "the JAX-layout resume warned": out["jax"]["warned"],
              "the npz resume did not": not out["npz"]["warned"]}
    log(phase, f"JAX-layout checkpoint {size} bytes (msgpack, written "
        f"here); walls (s) " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         walls.items())
        + "; checks " + ", ".join(f"{k}={v}" for k, v in checks.items())
        + f" ({card})")
    if not all(checks.values()):
        raise SystemExit(f"{phase}: {checks}")
    return by_path


PIPE_STAGES, PIPE_MICRO = 4, 8
PIPE_WIDTHS = dict(in_dim=444, hidden=512, out_dim=7, batch=256)


def pipeline_slice(device, card):
    """Phase pipeline-slice: the GPipe schedule (S = 4 stages on one card's
    entries, M = 8 microbatches) of the pipelined MLP against the
    sequential loss and its gradients (loss rtol 1e-5, each gradient
    within 1e-4 of its largest element), the padded first-layer rows'
    gradient exactly 0, and the walls of 5 pipelined and 5 sequential SGD
    steps."""
    import torch

    from multivae_tpu_torch.parallel import pipeline as pipe

    phase = "pipeline-slice"
    w = PIPE_WIDTHS
    gen = torch.Generator().manual_seed(SEED)
    params = pipe.init_pipelined_mlp(w["in_dim"], w["hidden"], w["out_dim"],
                                     PIPE_STAGES, generator=gen)
    params = {k: {kk: vv.to(device) for kk, vv in v.items()}
              for k, v in params.items()}
    x = torch.randn(w["batch"], w["in_dim"], generator=gen).to(device)
    y = torch.randn(w["batch"], w["out_dim"], generator=gen).to(device)
    mesh = pipe.pipe_mesh(PIPE_STAGES, [device] * PIPE_STAGES)

    def loss_and_grads(fn, **kw):
        leaves = {k: {kk: vv.clone().requires_grad_() for kk, vv in
                      v.items()} for k, v in params.items()}
        flat = [leaves[a][b] for a in ("stack", "head") for b in ("w", "b")]
        loss = fn(leaves, x, y, **kw)
        return loss.detach(), torch.autograd.grad(loss, flat)

    loss_p, grads_p = loss_and_grads(pipe.pipelined_mlp_loss,
                                     n_micro=PIPE_MICRO, mesh=mesh)
    loss_s, grads_s = loss_and_grads(pipe.sequential_mlp_loss)
    loss_err = abs(float(loss_p - loss_s)) / abs(float(loss_s))
    grad_err = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(grads_p, grads_s))
    padded = float(grads_p[0][0][w["in_dim"]:].abs().max())

    def walled(step):
        q = params
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(5):
            q, loss = step(q, x, y)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) / 5, float(loss)

    def sequential_step(q, x, y):
        leaves = {k: {kk: vv.clone().requires_grad_() for kk, vv in
                      v.items()} for k, v in q.items()}
        loss = pipe.sequential_mlp_loss(leaves, x, y)
        flat = [leaves[a][b] for a in ("stack", "head") for b in ("w", "b")]
        grads = iter(torch.autograd.grad(loss, flat))
        new = {a: {b: (leaves[a][b] - 1e-2 * next(grads)).detach()
                   for b in ("w", "b")} for a in ("stack", "head")}
        return new, loss.detach()

    pipe_s, pipe_loss = walled(pipe.make_pipelined_train_step(
        mesh, PIPE_MICRO, lr=1e-2))
    seq_s, seq_loss = walled(sequential_step)
    checks = {"loss": loss_err <= 1e-5, "gradients": grad_err <= 1e-4,
              "padded rows 0": padded == 0.0,
              "5 steps agree": abs(pipe_loss - seq_loss)
              <= 1e-4 * abs(seq_loss)}
    log(phase, f"S={PIPE_STAGES} M={PIPE_MICRO} {w}: mesh {mesh}; loss "
        f"rel {loss_err:.3e}, gradient err / max {grad_err:.3e}, padded "
        f"rows' gradient {padded}; per SGD step pipelined "
        f"{1e3 * pipe_s:.3f} ms, sequential {1e3 * seq_s:.3f} ms; checks "
        + ", ".join(f"{k}={v}" for k, v in checks.items()) + f" ({card})")
    if not all(checks.values()):
        raise SystemExit(f"{phase}: {checks}")


# ------------------------------------------------------------------------
# the JAX package's checkpoint format, written here without flax or msgpack
# (the card's machine has neither): tests/test_torch_port_jax_checkpoint.py
# holds these bytes equal to flax.serialization.to_bytes of the same tree
def _msgpack_sized(n: int, small: int, codes, small_max: int) -> bytes:
    import struct

    if n < small_max:
        return bytes([small | n]) if small is not None else b""
    for code, fmt, limit in codes:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} elements is more than msgpack holds")


def _msgpack_ext(code: int, data: bytes) -> bytes:
    import struct

    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        head = bytes([fixed[n]])
    elif n < 1 << 8:
        head = bytes([0xC7, n])
    elif n < 1 << 16:
        head = b"\xc8" + struct.pack(">H", n)
    else:
        head = b"\xc9" + struct.pack(">I", n)
    return head + struct.pack(">b", code) + data


def flax_msgpack_bytes(value) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for a state dict
    (nested dicts of numpy arrays and plain values): msgpack with binary
    strings, each array an ext 1 and each numpy scalar an ext 3 whose
    payload is msgpack of ``[shape, dtype name, C-order buffer]``."""
    import struct

    big = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
    if isinstance(value, dict):
        return _msgpack_sized(len(value), 0x80, big, 16) + b"".join(
            flax_msgpack_bytes(k) + flax_msgpack_bytes(v)
            for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return _msgpack_sized(len(value), 0x90, ((0xDC, ">H", 1 << 16),
                                                 (0xDD, ">I", 1 << 32)),
                              16) + b"".join(map(flax_msgpack_bytes, value))
    if isinstance(value, str):
        raw = value.encode("utf-8")
        return _msgpack_sized(len(raw), 0xA0, ((0xD9, ">B", 1 << 8),
                                               (0xDA, ">H", 1 << 16),
                                               (0xDB, ">I", 1 << 32)),
                              32) + raw
    if isinstance(value, bytes):
        return _msgpack_sized(len(value), None, ((0xC4, ">B", 1 << 8),
                                                 (0xC5, ">H", 1 << 16),
                                                 (0xC6, ">I", 1 << 32)),
                              0) + value
    if value is None or isinstance(value, bool):
        return {None: b"\xc0", False: b"\xc2", True: b"\xc3"}[value]
    if isinstance(value, int):
        if 0 <= value < 128 or -32 <= value < 0:
            return struct.pack(">b" if value < 0 else ">B", value)
        sizes = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) \
            if value >= 0 else ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                                (0xD3, ">q"))
        for code, fmt in sizes:
            try:
                return bytes([code]) + struct.pack(fmt, value)
            except struct.error:
                continue
        raise ValueError(f"{value} does not fit 64 bits")
    if isinstance(value, float):
        return b"\xcb" + struct.pack(">d", value)
    if isinstance(value, (np.ndarray, np.generic)):
        arr = np.asarray(value)
        payload = flax_msgpack_bytes([list(arr.shape), arr.dtype.name,
                                      arr.tobytes("C")])
        return _msgpack_ext(1 if isinstance(value, np.ndarray) else 3,
                            payload)
    raise TypeError(f"{type(value).__name__} is not in flax's state dicts")


def build_phase() -> dict:
    """Phase build: every kernel source at once, one nvcc each. Returns
    ptxas' register, shared-memory and spill lines per source."""
    from multivae_tpu_torch.ops import _build

    start = time.perf_counter()
    built = _build.build_kernels(SOURCES)
    lines = {}
    for name, res in built.items():
        BUILD_LOGS[name] = res.log
        lines[name] = " | ".join(
            ln.strip() for ln in res.log.splitlines()
            if "registers" in ln or "spill" in ln)
        log("build", f"{name}.cu built in {res.seconds:.2f} s -> "
            f"{res.path.name}; " + lines[name])
    log("build", f"all {len(built)} kernels in "
        f"{time.perf_counter() - start:.2f} s (parallel nvcc)")
    return lines


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
    ptxas = build_phase()

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
        entries = {"avatar_sweep": dict(max_abs_err=max_err,
                                        ptxas=ptxas["avatar_sweep"],
                                        **timing)}
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
        timed("multimodal-kernel",
              multimodal_kernel_check(device, entries["generic_step"]))
        by_path.update(timed("multimodal-slice",
                             multimodal_slice(device, smi)))
        with tempfile.TemporaryDirectory() as root:
            paths, run = timed("eval-slice", eval_slice(device, smi, root))
            by_path.update(paths)
            paths, traverse = timed("analysis-slice",
                                    analysis_slice(root, run, smi))
            by_path.update(paths)
        entries["avatar_sweep"]["traverse"] = traverse
        entries.update(timed("bf16-kernel", bf16_kernel_check(device)))
        by_path.update(timed("bf16-slice", bf16_slice(device, smi)))
        with tempfile.TemporaryDirectory() as root:
            datadir = slice_cohort(root, "tp-slice")[0]
            four = os.path.join(root, "four_block")
            shutil.copytree(datadir, four)
            split_roi_block(four)
            timed("cohorts", None)
            by_path.update(timed("tp-slice", tp_slice(datadir, root, smi)))
            by_path.update(timed("dp-general-slice", dp_general_slice(
                datadir, four, root, smi)))
            by_path.update(timed("profile-slice", profile_slice(
                datadir, root, smi)))
            by_path.update(timed("jax-checkpoint-slice",
                                 jax_checkpoint_slice(datadir, root, smi)))
        timed("pipeline-slice", pipeline_slice(device, smi))
    from multivae_tpu_torch.train import profiling
    log("profile", f"the tracer's warm-up kernels kept by each profiled "
        f"epoch's trace (of {profiling.WARM_UP_LAUNCHES}; fewer: the "
        f"session lost its first records): {WARM_UP_KEPT}")
    for k in KERNELS + BF16_KERNELS:
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
           if entries[k].get("variants") else {}),
        **{f: entries[k][f] for f in (
            "ms_events", "plain_ms_events", "library_ms_events", "plan",
            "phase_cycles_per_tile", "ptxas", "traverse", "worst_ratio",
            "sass_hmma", "f32_ms", "step_ms_in_launch",
            "f32_step_ms_in_launch")
            if f in entries[k]}}
        for k in KERNELS + BF16_KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
