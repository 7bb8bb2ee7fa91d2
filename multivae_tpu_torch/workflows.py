"""Analysis workflows of the port: the ``daa`` command.

Counterpart of ``multivae_tpu/workflows.py:258-309``.
"""

from __future__ import annotations

import os

import torch

from .analysis.daa import cohort_from_datasets, run_daa
from .train.experiment import load_run
from .utils.colors import print_text, print_title


def resolve_device(device: str) -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and no card is
    visible (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: CUDA is not available "
                           f"(pass --device cpu to run on the CPU)")
    return dev


def daa_exp(dataset, datasetdir, outdir, run, sampling_strategy="likelihood",
            n_validation=5, n_samples=200, n_subjects=50, M=1000,
            trust_level=0.75, seed=1037, reg_method="hierarchical",
            sample_latents=True, vote_prop=1.0, exact_reconstruction="auto",
            fetch_dtype="float16", artifact="full", device="cuda"):
    """Digital avatars analysis (``workflow.py:185-539``): perturb one
    clinical score at a time, decode ROI avatars on the avatar-sweep kernel,
    regress avatar on score per ROI and vote Bonferroni-significant
    associations.

    ``device`` runs the model and the sweep (``cuda`` by default; ``cpu``
    runs the kernel's plain PyTorch version). ``exact_reconstruction=False``
    forces the Monte-Carlo M-pass reconstruction average;
    ``fetch_dtype`` is the device->host wire dtype of the avatars (the
    on-disk artifact is float32 either way); ``artifact=stats-only`` skips
    the avatar artifact and reduces each round to device-side regression
    sufficient statistics."""
    dev = resolve_device(device)
    print_title(f"DIGITAL AVATARS ANALYSIS: {dataset}")
    expdir = os.path.join(outdir, run)
    daadir = os.path.join(expdir, "daa")
    os.makedirs(daadir, exist_ok=True)
    print_text(f"experimental directory: {expdir}")
    print_text(f"DAA directory: {daadir}")
    experiment, cfg = load_run(outdir, run, dev)
    experiment.set_datasets()
    cohorts = [cohort_from_datasets(*experiment.member_datasets(idx),
                                    datasetdir, experiment.mod_names)
               for idx in range(cfg.num_models)]
    return run_daa(cfg, experiment.models, cohorts, daadir,
                   sampling_strategy=sampling_strategy,
                   n_validation=n_validation, n_samples=n_samples,
                   n_subjects=n_subjects, M=M, trust_level=trust_level,
                   seed=seed, reg_method=reg_method,
                   sample_latents=sample_latents, vote_prop=vote_prop,
                   exact_reconstruction=exact_reconstruction,
                   fetch_dtype=fetch_dtype, artifact=artifact)
