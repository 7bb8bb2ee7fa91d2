"""Digital Avatars Analysis (DAA).

Counterpart of ``multivae_tpu/analysis/daa.py``. The pipeline: perturb one
clinical score at a time with artificial values, decode ROI "avatars"
through the trained model, regress each avatar ROI on the perturbed score
per validation round, and vote the Bonferroni-significant score->ROI links
across rounds (and ensemble members).

The avatar sweep runs on the hand-written kernel
(:func:`multivae_tpu_torch.ops.fused_daa.fused_avatar_sweep`) for every
configuration the kernel takes, and for every other one (deeper networks,
other likelihoods, the unfactorized latent) on the general sweep
(:func:`general_sweep_cells`): one forward of the whole model per (sample,
score) cell, as the JAX package's general branch, which is XLA there and
plain torch here. The regressions run on the host in float64
(:mod:`multivae_tpu_torch.analysis.stats`). With a data mesh
(:func:`avatar_sweep_sharded`, ``use_sharding``) the (sample, score) cells
are split over the mesh's entries, each slice through the same kernel or
general sweep with the unsharded sweep's noise, cell for cell.

Not ported yet (ROADMAP Queue 1 item 10): the ``sampled`` artifact mode.
"""

from __future__ import annotations

import collections
import copy
import csv
import os
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from numpy.lib.format import open_memmap

from ..ops.fused_daa import (
    avatar_layout,
    build_cell_grid,
    fused_avatar_sweep,
    prepare_sweep,
    supports_fused_sweep,
    sweep_cells,
)
from ..parallel import data_mesh, spread, visible_cards
from ..utils.colors import print_result, print_subtitle, print_text
from .stats import (
    fixed_regression_batch,
    fixed_regression_from_stats,
    hierarchical_regression_batch,
    hierarchical_regression_from_stats,
    mixed_regression_batch,
    mixed_regression_from_stats,
)

SAMPLING_STRATEGIES = ("linear", "uniform", "gaussian", "likelihood")
ARTIFACT_MODES = ("full", "stats-only")
SUFFSTATS_FILE = "regression_suffstats.npz"


@dataclass
class DaaCohort:
    """What the DAA needs of one ensemble member's data, as numpy arrays.

    ``train_clinical``: ``[N_train, n_scores]`` clinical block of the
    complete train subjects (the population statistics of the non-likelihood
    strategies); ``test_data``: ``{modality: [N_test, dim]}`` of the
    complete test subjects, from which each round draws its subjects;
    ``test_metadata``: ``[N_test, len(metadata_columns)]`` object array of
    their metadata, which holds ``participant_id`` and ``site``.
    """

    clinical_names: np.ndarray
    rois_names: np.ndarray
    train_clinical: np.ndarray
    test_data: Dict[str, np.ndarray]
    metadata_columns: List[str]
    test_metadata: np.ndarray


def cohort_from_datasets(trainset, testset, datasetdir: str,
                         mod_names: Sequence[str]) -> DaaCohort:
    """Build a :class:`DaaCohort` from the data layer's datasets: their
    complete subjects, scaled as the datasets serve them."""
    train_data, _, _ = trainset.gather(complete_indices(trainset))
    test_data, _, metadata = testset.gather(complete_indices(testset))
    return DaaCohort(
        clinical_names=np.load(os.path.join(datasetdir,
                                            "clinical_names.npy"),
                               allow_pickle=True),
        rois_names=np.load(os.path.join(datasetdir, "rois_names.npy"),
                           allow_pickle=True),
        train_clinical=train_data[mod_names[0]],
        test_data=test_data,
        metadata_columns=list(metadata.columns),
        test_metadata=metadata.to_numpy())


def complete_indices(dataset) -> np.ndarray:
    """Dataset indices whose samples carry every modality."""
    return np.asarray(dataset.idx_per_modality_subset[-1])


def _device_suffstats(avatars, scores_values, roundtrip_dtype=None):
    """Per-(subject, score, ROI) regression sufficient statistics on the
    device: ``Σ_p y``, ``Σ_p x·y`` and ``Σ_p y²`` of the ``[B, S, P, R]``
    avatars, each ``[B, S, R]``. Every regression design depends on the
    avatars only through them, so ``artifact="stats-only"`` fetches these
    instead of the avatar tensor. ``roundtrip_dtype`` first rounds the
    avatars through the full mode's wire dtype, so both modes give the same
    numbers at a matched ``fetch_dtype``."""
    y = avatars.float()
    if roundtrip_dtype is not None:
        y = y.to(roundtrip_dtype).float()
    x = scores_values.float().permute(1, 2, 0)           # [B, S, P]
    ysum = y.sum(dim=2)
    xysum = torch.einsum("bsp,bspr->bsr", x, y)
    yysum = torch.einsum("bspr,bspr->bsr", y, y)
    return ysum, xysum, yysum


def params_namespace(n_validation, n_subjects, M, n_samples, reg_method,
                     sampling_strategy, sample_latents, seed):
    """Result-directory naming namespace (``workflow.py:251-262``)."""
    return SimpleNamespace(
        n_validation=n_validation, n_subjects=n_subjects, M=M,
        n_samples=n_samples, reg_method=reg_method,
        sampling=sampling_strategy, sample_latents=sample_latents, seed=seed)


def resdir_name(params: SimpleNamespace) -> str:
    return "_".join("_".join([key, str(val)])
                    for key, val in params.__dict__.items())


@torch.no_grad()
def analytic_reconstruction_stats(model, data):
    """Exact expectation of the reference's M-pass averaging: with linear
    decoders and a per-feature output scale, the mean of the decodes is the
    decode of the latent means (joint via the deterministic mixture
    partition). Returns ``(clinical loc, clinical scale, rois loc)``."""
    latents = model.inference(data)
    joint_mu = latents["joint"][0]
    outs = []
    for mod in model.modalities:
        s_mu, _ = latents["modalities"][mod.name + "_style"]
        outs.append(model.decoders[mod.name](s_mu, joint_mu))
    (c_loc, c_scale), (r_loc, _) = outs
    return c_loc, c_scale, r_loc


@torch.no_grad()
def reconstruction_stats(model, data, M: int, generator: torch.Generator,
                         cfg=None, exact: object = "auto"):
    """Mean clinical loc/scale and rois loc over ``M`` stochastic
    reconstruction passes (``workflow.py:385-398``).

    On configurations the sweep kernel takes, the mean is computed in
    closed form (:func:`analytic_reconstruction_stats`); ``exact=False``
    forces the Monte-Carlo passes, ``exact=True`` the closed form.
    """
    if exact is True:
        if cfg is not None and not supports_fused_sweep(cfg, model, data):
            raise ValueError(
                "exact_reconstruction=True requires a linear-decoder "
                "(fused-supported) configuration; use the Monte-Carlo "
                "estimator (exact_reconstruction=False) instead")
        return analytic_reconstruction_stats(model, data)
    if exact is not False and cfg is not None \
            and supports_fused_sweep(cfg, model, data):
        return analytic_reconstruction_stats(model, data)
    names = model.mod_names
    sums = None
    for _ in range(M):
        rec = model(data, sample_latents=True, generator=generator)["rec"]
        parts = (rec[names[0]][0], rec[names[0]][1], rec[names[1]][0])
        sums = parts if sums is None else tuple(
            s + p for s, p in zip(sums, parts))
    return tuple(s / M for s in sums)


@torch.no_grad()
def general_sweep_inputs(model, data, scores_values,
                         generator: torch.Generator):
    """The general sweep's cells and noise: ``(cdata [n_cells, B, d1], eps
    [n_cells, B, noise_width])``, cell ``p * n_scores + s`` perturbing score
    ``s`` with sample ``p``; the noise is one draw from ``generator`` on
    the data's device, so the result depends neither on the chunk nor on
    the mesh."""
    names = model.mod_names
    clinical = data[names[0]]
    n_samples, b, n_scores = scores_values.shape
    eps = torch.randn((n_samples * n_scores, b, model.noise_width(names)),
                      generator=generator, dtype=torch.float32,
                      device=clinical.device)
    return build_cell_grid(clinical, scores_values), eps


@torch.no_grad()
def general_sweep_cells(model, cdata, rois, eps, sample_latents: bool,
                        chunk: int = 16):
    """ROI locs ``[n_cells, B, n_rois]``: per cell one forward of the whole
    model on the ``B``-row batch (the cell's clinical block, the round's ROI
    block), so every row partition is the batch's own (``daa.py:210-265``,
    the general branch); with ``sample_latents`` cell ``i`` takes the noise
    ``eps[i]``. ``chunk`` cells at a time go through one ``torch.func.vmap``
    of the forward."""
    names = model.mod_names

    def one(clinical, noise):
        out = model({names[0]: clinical, names[1]: rois},
                    sample_latents=sample_latents,
                    noise=noise if sample_latents else None)
        return out["rec"][names[1]][0]

    batched = torch.func.vmap(one)
    step = max(int(chunk), 1)
    return torch.cat([batched(cdata[i:i + step], eps[i:i + step])
                      for i in range(0, cdata.shape[0], step)])


def avatar_sweep(model, data, scores_values, sample_latents: bool,
                 generator: torch.Generator, cfg, chunk: int = 16):
    """ROI avatars ``[B, n_scores, n_samples, n_rois]`` for every (sample,
    score) perturbation of ``scores_values [n_samples, B, n_scores]``: on
    the avatar-sweep kernel where it takes the configuration, else on the
    general sweep (:func:`general_sweep_cells`, ``chunk`` cells at a
    time)."""
    if supports_fused_sweep(cfg, model, data):
        return fused_avatar_sweep(model, data, scores_values, sample_latents,
                                  generator, cfg)
    n_samples, _, n_scores = scores_values.shape
    cdata, eps = general_sweep_inputs(model, data, scores_values, generator)
    out = general_sweep_cells(model, cdata, data[model.mod_names[1]], eps,
                              sample_latents, chunk)
    return avatar_layout(out, n_samples, n_scores)


@torch.no_grad()
def avatar_sweep_sharded(model, data, scores_values, sample_latents: bool,
                         generator: torch.Generator, mesh, cfg,
                         chunk: int = 16):
    """:func:`avatar_sweep` with the (sample, score) cells split over the
    mesh's ``data`` axis (``daa.py:268-360``): every entry decodes an equal
    slice of the cell grid, on the avatar-sweep kernel where it takes the
    configuration, else on the general sweep (a copy of the model on each
    entry's device). The noise is the unsharded sweep's one draw, so the
    result does not depend on the mesh; a cell count the mesh does not
    divide is padded with repeated cells (zero noise) that are dropped. The
    data and the result live on the first entry's device; a slice whose
    entry is another device takes copies of what it reads."""
    devices = mesh.axis_devices("data")
    n_samples, _, n_scores = scores_values.shape
    n_cells = n_samples * n_scores
    fused = supports_fused_sweep(cfg, model, data)
    if fused:
        sp, posteriors, cdata, eps, dims = prepare_sweep(
            model, data, scores_values, generator, cfg)
    else:
        cdata, eps = general_sweep_inputs(model, data, scores_values,
                                          generator)
        rois = data[model.mod_names[1]]
        models = {}
    first = cdata.device
    if devices[0] != first:
        raise ValueError(f"the data is on {first}, the mesh's first data "
                         f"entry is {devices[0]}")
    pad = (-n_cells) % len(devices)
    if pad:
        cdata = torch.cat([cdata, cdata[:pad]])
        eps = torch.cat([eps, eps.new_zeros((pad,) + eps.shape[1:])])
    per = (n_cells + pad) // len(devices)
    parts = []
    for k, dev in enumerate(devices):
        cells = slice(k * per, (k + 1) * per)
        if fused:
            out = sweep_cells({n: t.to(dev) for n, t in sp.items()},
                              tuple(t.to(dev) for t in posteriors),
                              cdata[cells].to(dev), eps[cells].to(dev),
                              dims, sample_latents, method=cfg.method)
        else:
            if dev not in models:
                models[dev] = (model if dev == first
                               else copy.deepcopy(model).to(dev))
            out = general_sweep_cells(models[dev], cdata[cells].to(dev),
                                      rois.to(dev), eps[cells].to(dev),
                                      sample_latents, chunk)
        parts.append(out.to(first))
    return avatar_layout(torch.cat(parts)[:n_cells], n_samples, n_scores)


def sample_artificial_scores(strategy: str, clinical_values: np.ndarray,
                             n_samples: int, n_subjects: int,
                             rng: np.random.Generator):
    """Population-level artificial score values for the non-likelihood
    strategies (``workflow.py:337-354``). Returns
    ``[n_subjects, n_scores, n_samples]``."""
    n_scores = clinical_values.shape[1]
    min_per_score, max_per_score = np.quantile(
        clinical_values, [0.05, 0.95], 0)
    if strategy == "linear":
        grid = np.linspace(min_per_score, max_per_score, n_samples)  # [P, S]
        return np.repeat(grid.T[np.newaxis], n_subjects, axis=0)
    if strategy == "uniform":
        return rng.uniform(min_per_score[None, :, None],
                           max_per_score[None, :, None],
                           size=(n_subjects, n_scores, n_samples))
    if strategy == "gaussian":
        return rng.normal(0.0, 1.0, size=(n_subjects, n_scores, n_samples))
    raise ValueError(f"unknown sampling strategy {strategy}")


def _fetch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"fetch_dtype must name a torch float dtype, "
                         f"got: {name}")
    return dtype


def run_daa(cfg, models: Sequence[torch.nn.Module],
            cohorts: Sequence[DaaCohort], daadir: str,
            sampling_strategy: str = "likelihood", n_validation: int = 5,
            n_samples: int = 200, n_subjects: int = 50, M: int = 1000,
            trust_level: float = 0.75, seed: Optional[int] = 1037,
            reg_method: str = "hierarchical", sample_latents: bool = True,
            vote_prop: float = 1.0, exact_reconstruction="auto",
            fetch_dtype: str = "float16", artifact: str = "full",
            use_sharding="auto", chunk: int = 16) -> str:
    """Full DAA pipeline; returns the result directory.

    ``models`` and ``cohorts`` hold one entry per ensemble member
    (``cfg.num_models``); the models' device runs the sweep. Subjects and
    population-level scores are drawn from ``numpy.random.default_rng(
    seed)`` (the JAX package's stream); device-side draws (likelihood
    scores, latent noise, Monte-Carlo passes) from one ``torch.Generator``
    on that device seeded with ``seed``.

    ``exact_reconstruction``: the closed-form reconstruction mean on
    supported configs (``"auto"``/True) or the M-pass Monte Carlo
    (False). ``fetch_dtype``: wire dtype of the device->host avatar copy;
    the on-disk artifact stays float32. ``artifact``: ``"full"`` writes the
    ``rois_digital_avatars.npy`` memmap; ``"stats-only"`` reduces each round
    to the regression sufficient statistics on the device and never
    fetches the avatars (same regression outputs to float tolerance).
    ``use_sharding``: split each round's cell grid over the visible cards
    (:func:`avatar_sweep_sharded`); ``"auto"`` does so whenever the models
    are on a card and more than one is visible. ``chunk``: cells per
    batched forward of the general sweep (configurations the sweep kernel
    does not take).
    """
    if sampling_strategy not in SAMPLING_STRATEGIES:
        raise ValueError("sampling_strategy must be either linear, uniform"
                         "gaussian or likelihood")
    if artifact == "sampled":
        raise NotImplementedError(
            "artifact='sampled' is not ported yet: see ROADMAP.md, Queue 1 "
            "item 10")
    if artifact not in ARTIFACT_MODES:
        raise ValueError(f"artifact must be one of {ARTIFACT_MODES}, "
                         f"got: {artifact}")
    if isinstance(exact_reconstruction, str) \
            and exact_reconstruction != "auto":
        exact_reconstruction = exact_reconstruction.lower() in (
            "true", "1", "yes")
    wire = _fetch_dtype(fetch_dtype)
    n_models = cfg.num_models
    if len(models) != n_models or len(cohorts) != n_models:
        raise ValueError(f"need {n_models} models and cohorts, got "
                         f"{len(models)} and {len(cohorts)}")
    device = next(models[0].parameters()).device
    if isinstance(use_sharding, str):
        use_sharding = (use_sharding == "auto"
                        or use_sharding.lower() in ("true", "1", "yes"))
    mesh = None
    n_cards = len(visible_cards())
    if use_sharding and device.type == "cuda" and n_cards > 1:
        mesh = data_mesh(n_cards, spread(device, n_cards))
        print_text(f"avatar grid sharded over {n_cards} devices")
    clinical_names = cohorts[0].clinical_names
    rois_names = cohorts[0].rois_names
    n_scores = len(clinical_names)
    n_rois = len(rois_names)
    print_text(f"number of ROIs: {n_rois}")
    print_text(f"number of clinical scores: {n_scores}")

    params_ns = params_namespace(n_validation, n_subjects, M, n_samples,
                                 reg_method, sampling_strategy,
                                 sample_latents, seed)
    resdir = os.path.join(daadir, resdir_name(params_ns))
    os.makedirs(resdir, exist_ok=True)

    np_rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed if seed is not None else 0)

    # clamp to the available complete test subjects before sizing the memmap
    n_subjects = min(n_subjects, len(cohorts[0].test_metadata))

    stats_only = artifact == "stats-only"
    rois_digital_avatars = None
    if stats_only:
        print_text("artifact=stats-only: reducing each round to regression "
                   "sufficient statistics on device")
    else:
        shape = (n_models, n_validation, n_subjects, n_scores, n_samples,
                 n_rois)
        if n_models == 1:
            shape = shape[1:]
        rois_digital_avatars = open_memmap(
            os.path.join(resdir, "rois_digital_avatars.npy"),
            dtype="float32", mode="w+", shape=shape)

    all_sampled_scores, all_metadatas, all_rois_reconstructions = [], [], []
    all_suffstats = []  # per model: list of per-round (ysum, xysum, yysum)
    metadata_columns = None
    for model_idx, (model, cohort) in enumerate(zip(models, cohorts)):
        print_text(f"complete train subjects: {len(cohort.train_clinical)}")
        print_text(f"complete test subjects: {len(cohort.test_metadata)}")
        metadata_columns = cohort.metadata_columns
        scores_grid = None
        if sampling_strategy != "likelihood":
            print_text("Build the artificial values using population level "
                       "statistics")
            scores_grid = sample_artificial_scores(
                sampling_strategy, np.asarray(cohort.train_clinical),
                n_samples, n_subjects, np_rng)  # [B, S, P]

        n_complete = len(cohort.test_metadata)
        sampled_scores, metadatas, rois_recs, suffstats_rounds = \
            [], [], [], []
        for val_idx in range(n_validation):
            print_text(f"validation round {val_idx + 1}/{n_validation}")
            sel = np_rng.choice(n_complete, size=n_subjects, replace=False)
            data = {k: torch.as_tensor(np.asarray(v[sel], dtype=np.float32),
                                       device=device)
                    for k, v in cohort.test_data.items()}
            metadatas.append(cohort.test_metadata[sel])

            loc_hat, scale_hat, rois_reconstruction = reconstruction_stats(
                model, data, M, generator, cfg=cfg,
                exact=exact_reconstruction)
            rois_recs.append(rois_reconstruction.cpu().numpy())

            if sampling_strategy == "likelihood":
                eps = torch.randn((n_samples,) + tuple(loc_hat.shape),
                                  generator=generator, dtype=loc_hat.dtype,
                                  device=device)
                scores_values = loc_hat[None] + scale_hat[None] * eps
            else:
                scores_values = torch.as_tensor(
                    np.transpose(scores_grid, (2, 0, 1)),
                    dtype=torch.float32, device=device)       # [P, B, S]

            if mesh is not None:
                avatars = avatar_sweep_sharded(model, data, scores_values,
                                               sample_latents, generator,
                                               mesh, cfg, chunk)
            else:
                avatars = avatar_sweep(model, data, scores_values,
                                       sample_latents, generator, cfg, chunk)
            if stats_only:
                rt = None if wire == torch.float32 else wire
                suffstats_rounds.append(tuple(
                    s.cpu().numpy() for s in _device_suffstats(
                        avatars, scores_values, roundtrip_dtype=rt)))
            else:
                host = avatars.to(wire).cpu().float().numpy()
                if n_models == 1:
                    rois_digital_avatars[val_idx] = host
                else:
                    rois_digital_avatars[model_idx, val_idx] = host
            # stored layout: [B, n_samples, n_scores] (workflow.py:420-422)
            sampled_scores.append(
                scores_values.permute(1, 0, 2).cpu().numpy())
        all_sampled_scores.append(sampled_scores)
        all_metadatas.append(metadatas)
        all_rois_reconstructions.append(rois_recs)
        all_suffstats.append(suffstats_rounds)

    if n_models == 1:
        all_sampled_scores = all_sampled_scores[0]
        all_metadatas = all_metadatas[0]
        all_rois_reconstructions = all_rois_reconstructions[0]
    if stats_only:
        # [(n_models,) n_validation, B, S, R] per statistic
        stacked = {name: np.asarray([[rnd[i] for rnd in rounds]
                                     for rounds in all_suffstats])
                   for i, name in enumerate(("ysum", "xysum", "yysum"))}
        if n_models == 1:
            stacked = {k: v[0] for k, v in stacked.items()}
        np.savez(os.path.join(resdir, SUFFSTATS_FILE), **stacked)
    else:
        rois_digital_avatars.flush()
        del rois_digital_avatars
    np.save(os.path.join(resdir, "sampled_scores.npy"),
            np.asarray(all_sampled_scores))
    np.save(os.path.join(resdir, "metadatas.npy"),
            np.asarray(all_metadatas, dtype=object))
    np.save(os.path.join(resdir, "rois_reconstructions.npy"),
            np.asarray(all_rois_reconstructions))

    compute_significativity(
        resdir, cfg, clinical_names, rois_names, params_ns,
        metadata_columns, trust_level, vote_prop, reg_method)
    return resdir


def compute_significativity(resdir: str, cfg, clinical_names, rois_names,
                            params_ns, metadata_columns, trust_level: float,
                            vote_prop: float, reg_method: str):
    """Regression + voting stage (``workflow.py:443-539``); reads the saved
    artifacts so it can be re-run standalone. Writes ``pvalues.npy``,
    ``coefs.npy``, ``all_coefs.npy`` (hierarchical) and
    ``significant_rois.tsv``; returns the significant rows as dicts."""
    n_models = cfg.num_models
    n_scores = len(clinical_names)
    n_rois = len(rois_names)
    n_validation = params_ns.n_validation

    da_file = os.path.join(resdir, "rois_digital_avatars.npy")
    suff_file = os.path.join(resdir, SUFFSTATS_FILE)
    rois_da = suffstats = None
    if os.path.exists(da_file):
        rois_da = np.load(da_file, mmap_mode="r")
    elif os.path.exists(suff_file):
        with np.load(suff_file) as fh:
            suffstats = {k: fh[k] for k in ("ysum", "xysum", "yysum")}
    else:
        raise FileNotFoundError(
            f"{resdir} holds neither the avatar artifact "
            f"('rois_digital_avatars.npy', written by daa --artifact full) "
            f"nor the sufficient statistics ('{SUFFSTATS_FILE}', written "
            f"by --artifact stats-only); re-run the daa workflow before "
            f"the regression stage")
    all_sampled_scores = np.load(os.path.join(resdir, "sampled_scores.npy"))
    all_metadatas = np.load(os.path.join(resdir, "metadatas.npy"),
                            allow_pickle=True)
    all_rois_recs = np.load(os.path.join(resdir, "rois_reconstructions.npy"))
    if n_models == 1:
        if rois_da is not None:
            rois_da = rois_da[np.newaxis]
        else:
            suffstats = {k: v[np.newaxis] for k, v in suffstats.items()}
        all_sampled_scores = all_sampled_scores[np.newaxis]
        all_metadatas = all_metadatas[np.newaxis]
        all_rois_recs = all_rois_recs[np.newaxis]

    participant_id_idx = metadata_columns.index("participant_id")
    site_idx = metadata_columns.index("site")

    print_subtitle("Compute statistics (regression): digital avatar wrt "
                   "sampled scores...")
    coefs = np.zeros((n_models, n_validation, n_scores, n_rois))
    pvalues = np.zeros((n_models, n_validation, n_scores, n_rois))
    all_coefs = []
    for model_idx in range(n_models):
        all_coefs.append([])
        for val_idx in range(n_validation):
            avatars = (np.asarray(rois_da[model_idx, val_idx])
                       if rois_da is not None else None)
            scores_values = all_sampled_scores[model_idx, val_idx]
            metadata = all_metadatas[model_idx][val_idx]
            rois_rec = all_rois_recs[model_idx, val_idx]
            all_coefs[model_idx].append([])
            for score_idx in range(n_scores):
                x = scores_values[:, :, score_idx]          # [B, P]
                if avatars is not None:
                    y = avatars[:, score_idx, :, :]         # [B, P, R]
                else:
                    ss = {k: v[model_idx, val_idx, :, score_idx]
                          for k, v in suffstats.items()}    # each [B, R]
                if reg_method == "hierarchical":
                    if avatars is not None:
                        pvals, cfs, betas = \
                            hierarchical_regression_batch(x, y)
                    else:
                        pvals, cfs, betas = \
                            hierarchical_regression_from_stats(
                                x, ss["ysum"], ss["xysum"])
                    # per-score record: participant_id, site, per-roi betas
                    # (the ANOVA workflow's input, workflow.py:628-637)
                    rec = np.concatenate([
                        metadata[:, [participant_id_idx, site_idx]],
                        betas.astype(object)], axis=1)
                    all_coefs[model_idx][val_idx].append(rec)
                elif reg_method == "fixed":
                    if avatars is not None:
                        diff = (y - rois_rec[:, None, :]).reshape(-1,
                                                                  n_rois)
                        pvals, cfs = fixed_regression_batch(
                            x.reshape(-1), diff)
                    else:
                        pvals, cfs = fixed_regression_from_stats(
                            x, ss["ysum"], ss["xysum"], ss["yysum"],
                            offset_g=rois_rec)
                else:  # mixed: REML, all rois profiled together
                    if avatars is not None:
                        pvals, cfs = mixed_regression_batch(x, y)
                    else:
                        pvals, cfs = mixed_regression_from_stats(
                            x, ss["ysum"], ss["xysum"], ss["yysum"])
                pvalues[model_idx, val_idx, score_idx] = pvals
                coefs[model_idx, val_idx, score_idx] = cfs

    out_pvalues, out_coefs, out_all_coefs = pvalues, coefs, all_coefs
    if n_models == 1:
        out_pvalues = pvalues[0]
        out_coefs = coefs[0]
        out_all_coefs = all_coefs[0]
    np.save(os.path.join(resdir, "pvalues.npy"), out_pvalues)
    np.save(os.path.join(resdir, "coefs.npy"), out_coefs)
    if reg_method == "hierarchical":
        np.save(os.path.join(resdir, "all_coefs.npy"),
                np.asarray(out_all_coefs, dtype=object))
    print_text(f"p_values: {out_pvalues.shape}")
    print_text(f"regression coefficients: {out_coefs.shape}")

    print_subtitle("Compute statistics significativity...")
    significativity_thr = 0.05 / n_rois / n_scores
    vote_level = n_validation * trust_level
    print_text(f"voting trust level: {vote_level} / {n_validation}")
    idx_sign = ((pvalues < significativity_thr).sum(axis=1) >= vote_level)
    idx_sign = idx_sign.sum(0) >= vote_prop * n_models

    rows = []
    for idx, score in enumerate(clinical_names):
        for name in np.asarray(rois_names)[np.where(idx_sign[idx])]:
            roi, metric = str(name).rsplit("_", 1)
            rows.append({"metric": metric, "roi": roi, "score": str(score)})
    significant_file = os.path.join(resdir, "significant_rois.tsv")
    with open(significant_file, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=["metric", "roi", "score"],
                                delimiter="\t", lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    print_result(f"significant ROIs: {significant_file}")
    counts = collections.Counter((r["metric"], r["score"]) for r in rows)
    for (metric, score), count in sorted(counts.items()):
        print_text(f"{metric} {score}: {count} ROIs")
    return rows
