"""Workflows of the port: the ``train``, ``resume``, ``eval`` and ``daa``
commands.

Counterpart of ``multivae_tpu/workflows.py:28-309``.
"""

from __future__ import annotations

import os

import pandas as pd
import torch

from .analysis.daa import cohort_from_datasets, run_daa
from .train.config import Config
from .train.experiment import MultimodalExperiment, load_run
from .train.trainer import check_supported, run_epochs
from .utils.colors import print_result, print_text, print_title
from .utils.filehandling import create_dir_structure


def resolve_device(device: str) -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and no card is
    visible (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: CUDA is not available "
                           f"(pass --device cpu to run on the CPU)")
    return dev


def train_exp(dataset, datasetdir, outdir, input_dims, num_models=1,
              latent_dim=20, style_dim=(3, 20), data_seed="defaults",
              num_hidden_layer_encoder=1, num_hidden_layer_decoder=0,
              allow_missing_blocks=True, factorized_representation=True,
              likelihood="normal", learning_rate=0.002, batch_size=256,
              num_epochs=1500, eval_freq=25, eval_freq_fid=100, beta=1.0,
              data_multiplications=1, dropout_rate=0.0,
              initial_out_logvar=-3.0, learn_output_scale=True,
              out_scale_per_subject=False, method="joint_elbo",
              grad_scaling=False, use_tensorboard=True, log_every=1,
              data_parallel=1, tensor_parallel=1, ensemble_parallel="auto",
              fused_training=True, epoch_chunk=50, save_optimizer="all",
              profile_dir=None, calc_nll=False, calc_prd=False,
              calc_clf=False, calc_coherence=False, save_samples=False,
              device="cuda"):
    """Train the model (``workflow.py:41-182``); the JAX package's
    parameter surface plus ``device``.

    Creates the run directory ``<dataset>_<timestamp>``, trains every
    ensemble member, checkpoints every 5 epochs and at the end, and appends
    the run to the ``runs.tsv`` registry. ``device`` (``cuda`` by default)
    runs the kernels; ``cpu`` runs their plain PyTorch versions.
    ``epoch_chunk`` is accepted and the per-epoch loop runs. The
    ``calc_*`` flags log their evals on the ``eval_freq`` /
    ``eval_freq_fid`` cadence; ``save_samples`` writes each member's sample
    dumps (``fid/<group>/<modality>/NNNNNN.npy``) after training. Options
    whose route is not ported yet raise ``NotImplementedError`` naming
    their ROADMAP item: ``profile_dir`` and those listed by
    :func:`multivae_tpu_torch.train.trainer.unported_features`."""
    dev = resolve_device(device)
    if profile_dir is not None:
        raise NotImplementedError("profile_dir: tracing the port's epoch "
                                  "(ROADMAP Queue 1 item 9)")
    print_title(f"TRAIN: {dataset}")
    cfg = Config(
        dataset=dataset, datasetdir=datasetdir, dir_experiment=outdir,
        num_models=num_models, allow_missing_blocks=allow_missing_blocks,
        batch_size=batch_size, beta=beta, class_dim=latent_dim,
        data_multiplications=data_multiplications, end_epoch=num_epochs,
        eval_freq=eval_freq, eval_freq_fid=eval_freq_fid,
        factorized_representation=factorized_representation,
        initial_learning_rate=learning_rate,
        initial_out_logvar=initial_out_logvar, input_dim=list(input_dims),
        learn_output_scale=learn_output_scale,
        learn_output_sample_scale=out_scale_per_subject,
        likelihood=likelihood, method=method,
        num_hidden_layer_encoder=num_hidden_layer_encoder,
        num_hidden_layer_decoder=num_hidden_layer_decoder,
        dropout_rate=dropout_rate, style_dim=list(style_dim),
        data_seed=data_seed, grad_scaling=grad_scaling,
        data_parallel=int(data_parallel),
        tensor_parallel=int(tensor_parallel),
        ensemble_parallel=ensemble_parallel,
        fused_training=bool(fused_training),
        epoch_chunk=int(epoch_chunk), save_optimizer=save_optimizer,
        calc_nll=bool(calc_nll), calc_prd=bool(calc_prd),
        calc_clf=bool(calc_clf), calc_coherence=bool(calc_coherence),
    ).derive()
    exp = MultimodalExperiment(cfg, dev)
    check_supported(cfg, exp.models[0])
    create_dir_structure(cfg)
    exp.set_datasets()
    exp.set_optimizers()
    walls = run_epochs(exp, use_tensorboard=use_tensorboard,
                       log_every=log_every)
    print_text("train wall per epoch (s): "
               + " ".join(f"{w:.6f}" for w in walls))
    if save_samples:
        from .eval.sample_quality import save_generated_samples
        for model_idx in range(cfg.num_models):
            print_text(f"sample dumps: "
                       f"{save_generated_samples(exp, model_idx)}")
    _register_run(cfg)
    print_result(f"run: {cfg.str_experiment}")
    return cfg.str_experiment


def _register_run(cfg) -> None:
    """Append the run to ``<outdir>/runs.tsv`` (``workflow.py:155-182``)."""
    runs_path = os.path.join(cfg.dir_experiment, "runs.tsv")
    row = dict(
        name=[cfg.str_experiment], dataset=[cfg.dataset],
        out_scale_per_subject=[cfg.learn_output_sample_scale],
        n_hidden_layer_encoder=[cfg.num_hidden_layer_encoder],
        n_hidden_layer_decoder=[cfg.num_hidden_layer_decoder],
        allow_missing_blocks=[cfg.allow_missing_blocks])
    if os.path.exists(runs_path):
        runs = pd.concat((pd.read_table(runs_path), pd.DataFrame(row)))
    else:
        rows = {k: [] for k in row}
        for run in os.listdir(cfg.dir_experiment):
            flags_file = os.path.join(cfg.dir_experiment, run, "flags.json")
            if not os.path.isfile(flags_file):
                continue
            old = Config.load(flags_file)
            rows["name"].append(old.str_experiment)
            rows["dataset"].append(old.dataset)
            rows["out_scale_per_subject"].append(old.learn_output_sample_scale)
            rows["n_hidden_layer_encoder"].append(old.num_hidden_layer_encoder)
            rows["n_hidden_layer_decoder"].append(old.num_hidden_layer_decoder)
            rows["allow_missing_blocks"].append(old.allow_missing_blocks)
        runs = pd.DataFrame(rows)
    runs.to_csv(runs_path, index=False, sep="\t")


def resume_exp(dataset, datasetdir, outdir, run, num_epochs: int,
               use_tensorboard=True, log_every=1, device="cuda"):
    """Resume training an existing run up to ``num_epochs`` epochs in all,
    from its latest checkpoint (params and Adam state)."""
    dev = resolve_device(device)
    expdir = os.path.join(outdir, run)
    flags_file = os.path.join(expdir, "flags.json")
    if not os.path.isfile(flags_file):
        raise ValueError("You need first to train the model.")
    cfg = Config.load(flags_file)
    cfg.datasetdir = datasetdir
    cfg.dir_experiment = outdir
    cfg.dir_experiment_run = expdir
    cfg.str_experiment = run
    cfg.dir_checkpoints = os.path.join(expdir, "checkpoints")
    cfg.dir_logs = os.path.join(expdir, "logs")
    cfg.end_epoch = int(num_epochs)
    cfg.load_saved = True
    print_title(f"RESUME: {run} -> {num_epochs} epochs")
    exp = MultimodalExperiment(cfg, dev)
    exp.set_datasets()
    exp.set_optimizers()
    run_epochs(exp, use_tensorboard=use_tensorboard, log_every=log_every)
    print_result(f"resumed run: {run}")
    return run


def eval_exp(dataset, datasetdir, outdir, run, nll=True, prd=True,
             clf=True, coherence=True, load_epoch: int = -1,
             embedding: str = None, device="cuda"):
    """Post-hoc evaluation of a trained run (``multivae_tpu/workflows.py:
    134-226``): IWAE likelihoods, PRD, latent-probe classification and
    conditional-generation coherence of a saved checkpoint.
    ``load_epoch`` picks the newest checkpoint at or before it (default
    -1: the latest); ``embedding`` maps samples through a feature
    extractor before the PRD statistics (``.npz`` affine map or
    ``module:attr``). ``device`` runs the model (``cuda`` by default); the
    noise is drawn on the CPU, so a card run and a CPU run of one
    checkpoint see the same. Writes ``<run>/eval/eval_<epoch>.tsv``
    (``model, family, metric, value`` rows) and returns its path."""
    from .eval import coherence as coh
    from .eval import likelihood, representation, sample_quality

    dev = resolve_device(device)
    expdir = os.path.join(outdir, run)
    print_title(f"EVAL: {run}")
    latest = load_epoch in (-1, None)
    experiment, cfg = load_run(outdir, run, dev,
                               None if latest else int(load_epoch))
    experiment.set_datasets()
    evaldir = os.path.join(expdir, "eval")
    os.makedirs(evaldir, exist_ok=True)

    rows = []

    def add(model_idx, family, metric, value):
        rows.append({"model": model_idx, "family": family,
                     "metric": metric, "value": float(value)})

    for model_idx in range(cfg.num_models):
        cond_cache = []

        def cond_samples():
            if not cond_cache:
                cond_cache.append(sample_quality.generate_conditional_samples(
                    experiment, model_idx))
            return cond_cache[0]

        if nll:
            lhoods = likelihood.estimate_likelihoods(experiment, model_idx)
            for s_key in sorted(lhoods):
                for m_key, val in lhoods[s_key].items():
                    add(model_idx, "Likelihoods", f"{s_key}/{m_key}", val)
        if prd:
            for key, val in sample_quality.calc_prd_score(
                    experiment, model_idx, samples=cond_samples(),
                    embedding=embedding).items():
                add(model_idx, "PRD", key, val)
        if clf:
            clfs = representation.train_clf_lr_all_subsets(experiment,
                                                           model_idx)
            accs = representation.test_clf_lr_all_subsets(experiment, clfs,
                                                          model_idx)
            for l_key in sorted(accs):
                add(model_idx, "Latent Representation", l_key, accs[l_key])
        if coherence:
            # fit the modality classifiers first: with one label class
            # there are none, and no generation pass is made
            clfs_m = coh.train_modality_classifiers(experiment, model_idx)
            gen_eval = {}
            if clfs_m is not None:
                gen_eval = coh.evaluate_coherence(
                    experiment, model_idx, clfs=clfs_m,
                    samples=cond_samples())
            for l_key in sorted(gen_eval.get("cond", {})):
                for m_key, val in gen_eval["cond"][l_key].items():
                    add(model_idx, "Generation", f"{l_key}/{m_key}", val)
            if "random" in gen_eval:
                add(model_idx, "Generation", "Random", gen_eval["random"])

    frame = pd.DataFrame(rows, columns=["model", "family", "metric",
                                        "value"])
    epoch_tag = "latest" if latest else f"{int(load_epoch):04d}"
    out = os.path.join(evaldir, f"eval_{epoch_tag}.tsv")
    frame.to_csv(out, index=False, sep="\t")
    for _, r in frame.iterrows():
        print_text(f"model {r.model} {r.family}/{r.metric}: {r.value:.4f}")
    print_result(f"eval summary: {out}")
    return out


def daa_exp(dataset, datasetdir, outdir, run, sampling_strategy="likelihood",
            n_validation=5, n_samples=200, n_subjects=50, M=1000,
            trust_level=0.75, seed=1037, reg_method="hierarchical",
            sample_latents=True, vote_prop=1.0, exact_reconstruction="auto",
            fetch_dtype="float16", artifact="full", use_sharding="auto",
            chunk=16, sampled_rois=16, device="cuda"):
    """Digital avatars analysis (``workflow.py:185-539``): perturb one
    clinical score at a time, decode ROI avatars (on the avatar-sweep kernel
    where it takes the configuration), regress avatar on score per ROI and
    vote Bonferroni-significant associations.

    ``device`` runs the model and the sweep (``cuda`` by default; ``cpu``
    runs the kernel's plain PyTorch version). ``exact_reconstruction=False``
    forces the Monte-Carlo M-pass reconstruction average;
    ``fetch_dtype`` is the device->host wire dtype of the avatars (the
    on-disk artifact is float32 either way); ``artifact=stats-only`` skips
    the avatar artifact and reduces each round to device-side regression
    sufficient statistics; ``artifact=sampled`` does the same and keeps a
    ``sampled_rois``-column ROI subsample of the avatars
    (``rois_digital_avatars_sampled.npy``, ``sampled_rois_idx.npy``);
    ``use_sharding`` splits each round's cell grid
    over the visible cards (``auto``: whenever there is more than one);
    ``chunk`` is the number of cells per batched forward of the general
    sweep, which serves the configurations the avatar-sweep kernel does
    not take (deeper networks, other likelihoods, the unfactorized
    latent)."""
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
                   fetch_dtype=fetch_dtype, artifact=artifact,
                   use_sharding=use_sharding, chunk=chunk,
                   sampled_rois=sampled_rois)
