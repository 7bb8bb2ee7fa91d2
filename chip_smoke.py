#!/usr/bin/env python3
"""Drive the PyTorch port's DAA path on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA Hopper card (the kernel is built for sm_90a) and the CUDA toolkit's
``nvcc``; it imports nothing of JAX. Phases, one line each:

1. device: the card's name and power limit;
2. build: ``multivae_tpu_torch/csrc/avatar_sweep.cu`` with nvcc;
3. kernel check: the avatar-sweep kernel against its plain PyTorch version
   at the flagship widths (clinical 7, ROIs 444, hidden 256, latent 20,
   style [3, 20]), B=50 and 200 x 7 cells, for the four methods with and
   without sampled latents (atol = rtol = 1e-4: float32 with another
   summation order), and both timed with CUDA events;
4. slice: a seeded-init flagship model written as a port run dir and loaded
   back, then ``run_daa`` on a numpy cohort (likelihood strategy,
   n_samples=200, n_validation=2, sampled latents, full artifact), counting
   the kernel's launches; then the same DAA run at a small size,
   deterministic, on the card and with the model on the CPU (the plain
   version), which must agree.

Any failed phase exits non-zero. The last two lines are the JSON record of
the kernels and ``{"ok": true, "device": {...}}``; before them, the line of
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
"""

from __future__ import annotations

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
    """Phase 3: kernel vs plain version, all methods and both branches."""
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
                timing = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
                log("kernel", f"joint_elbo sampled: kernel "
                    f"{t[1]:.4f}/{t[2]:.4f} ms, plain {t[0]:.4f}/"
                    f"{t[3]:.4f} ms per sweep of {cdata.shape[0]} cells")
    return max_err, timing


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
    """Phase 4: the DAA path end to end; returns the kernel launches."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from multivae_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log("device", f"{name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")

    built = _build.build_kernel("avatar_sweep")
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", f"avatar_sweep.cu built in {built.seconds:.2f} s -> "
        f"{built.path.name}; " + " | ".join(ptxas))

    max_err, (ker_ms, plain_ms) = kernel_check(device)
    launches, _ = slice_run(device, smi)

    print(json.dumps({"kernels": [{
        "name": "avatar_sweep", "route": "cuda",
        "source": "multivae_tpu_torch/csrc/avatar_sweep.cu",
        "replaces": "multivae_tpu/ops/fused_daa.py:54",
        "launches": launches, "max_abs_err": max_err,
        "ms": ker_ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
