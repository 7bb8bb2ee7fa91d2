"""Workflows of the port: the ``train``, ``resume``, ``eval``, ``daa``,
``anova``, ``rsa`` and plot commands.

Counterpart of ``multivae_tpu/workflows.py``. The commands that run a
model (``train``, ``resume``, ``eval``, ``daa``, ``rsa``,
``daa-plot-score-metric``, ``avatar-plot``) take ``device`` (``cuda`` by
default); the others are host numpy, scipy and pandas, and the figures
matplotlib, imported by the functions that draw.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import torch

from .analysis.daa import cohort_from_datasets, run_daa
from .data.cohorts import split_roi_metric
from .train import profiling
from .train.config import Config
from .train.experiment import MultimodalExperiment, load_run, load_trained
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
    ``epoch_chunk`` is accepted and the per-epoch loop runs;
    ``profile_dir`` traces member 0's first epoch there
    (:mod:`multivae_tpu_torch.train.profiling`) and prints its counts. The
    ``calc_*`` flags log their evals on the ``eval_freq`` /
    ``eval_freq_fid`` cadence; ``save_samples`` writes each member's sample
    dumps (``fid/<group>/<modality>/NNNNNN.npy``) after training. A
    config past the layer-stack step's caps raises ``NotImplementedError``
    naming its ROADMAP item
    (:attr:`multivae_tpu_torch.train.routes.Routes.gaps`)."""
    dev = resolve_device(device)
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
                       log_every=log_every, profile_dir=profile_dir)
    print_text("train wall per epoch (s): "
               + " ".join(f"{w:.6f}" for w in walls))
    if profile_dir is not None:
        print_text("traced epoch's counts: " + " ".join(
            f"{k}={v}" for k, v in sorted(profiling.last_counts().items())
            if v))
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
    experiment, cfg = load_trained(outdir, run, dev)
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


def anova_exp(dataset, datasetdir, outdir, run, n_validation=5,
              n_samples=200, n_subjects=50, sampling_strategy="likelihood",
              M=1000, trust_level=0.75, seed=1037,
              reg_method="hierarchical", sample_latents=True, vote_prop=1.0):
    """Site-effect ANOVA on DAA per-subject betas (``workflow.py:542-654``)."""
    from .analysis.anova import run_anova
    from .analysis.daa import params_namespace, require_resdir, resdir_name

    if reg_method != "hierarchical":
        raise ValueError(
            "Anova only makes sense when using a hierachical regression")
    print_title(f"ANOVA: {dataset}")
    expdir = os.path.join(outdir, run)
    daadir = os.path.join(expdir, "daa")
    clinical_names = np.load(
        os.path.join(datasetdir, "clinical_names.npy"), allow_pickle=True)
    rois_names = np.load(
        os.path.join(datasetdir, "rois_names.npy"), allow_pickle=True)
    cfg = Config.load(os.path.join(expdir, "flags.json"))
    params = params_namespace(n_validation, n_subjects, M, n_samples,
                              reg_method, sampling_strategy, sample_latents,
                              seed)
    resdir = require_resdir(os.path.join(daadir, resdir_name(params)))
    return run_anova(resdir, clinical_names, rois_names, cfg.num_models,
                     n_validation, trust_level, vote_prop)


def rsa_exp(dataset, datasetdir, outdir, run, n_validation=1,
            n_subjects=301, sample_latents=False, seed=1037, device="cuda"):
    """Representational similarity analysis (``workflow.py:656-820``);
    ``device`` runs the model's inference (``cuda`` by default)."""
    from .analysis.rsa import run_rsa

    dev = resolve_device(device)
    print_title(f"RSA ANALYSIS: {dataset}")
    expdir = os.path.join(outdir, run)
    rsadir = os.path.join(expdir, "rsa")
    os.makedirs(rsadir, exist_ok=True)
    print_text(f"experimental directory: {expdir}")
    print_text(f"RSA directory: {rsadir}")
    experiment, cfg = load_trained(outdir, run, dev)
    return run_rsa(experiment, cfg, datasetdir, rsadir,
                   n_validation=n_validation, n_subjects=n_subjects,
                   sample_latents=sample_latents, seed=seed)


def hist_plot_exp(datasets, datasetdirs, scores, outdir):
    """Per-cohort score-distribution plot (``workflow.py:823-868``).

    Same artifact contract (one ``hist.png`` comparing the named score's
    distribution across cohorts) rendered as filled per-cohort gaussian-KDE
    curves computed with scipy — no seaborn dependency."""
    from scipy import stats

    from .utils.colors import get_color_list
    from .viz.plotting import _pyplot

    plt = _pyplot()
    print_title("PLOT HISTOGRAM")
    if not isinstance(datasets, (list, tuple)):
        datasets = [datasets]
    if not isinstance(datasetdirs, (list, tuple)):
        datasetdirs = datasetdirs.split(",")
    if not isinstance(scores, (list, tuple)):
        scores = [scores]
    if not len(datasets) == len(datasetdirs) == len(scores):
        raise ValueError("datasets, datasetdirs and scores must align")

    cohort_values = {}
    for name, path, score in zip(datasets, datasetdirs, scores):
        values = np.load(os.path.join(path, "clinical_data.npy"),
                         allow_pickle=True)
        names = np.load(os.path.join(path, "clinical_names.npy"),
                        allow_pickle=True).tolist()
        col = values[:, names.index(score)].astype(float)
        # repeated cohort names pool their values into one curve
        cohort_values.setdefault(name, []).append(col[np.isfinite(col)])
    cohort_values = {name: np.concatenate(cols)
                     for name, cols in cohort_values.items()}

    fig, ax = plt.subplots(figsize=(8, 5))
    palette = get_color_list(len(cohort_values))
    for color, (name, vals) in zip(palette, cohort_values.items()):
        if len(vals) == 0:
            print_text(f"cohort {name}: no finite values for its score; "
                       "skipped")
            continue
        if len(np.unique(vals)) > 1:
            kde = stats.gaussian_kde(vals)
            lo, hi = vals.min(), vals.max()
            pad = 0.1 * (hi - lo + 1e-9)
            grid = np.linspace(lo - pad, hi + pad, 256)
            density = kde(grid)
        else:  # degenerate cohort: single spike
            grid = np.array([vals[0] - 0.5, vals[0], vals[0] + 0.5])
            density = np.array([0.0, 1.0, 0.0])
        ax.fill_between(grid, density, color=(*color[:3], 0.45),
                        label=name)
        ax.plot(grid, density, color=color, lw=1.5)
    ax.set_xlabel("score")
    ax.set_ylabel("density")
    ax.legend(title="cohort", frameon=False)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    hist_file = os.path.join(outdir, "hist.png")
    fig.tight_layout()
    fig.savefig(hist_file)
    plt.close(fig)
    print_result(f"histogram: {hist_file}")
    return hist_file


def _collect_significant(pvalues, clinical_names, rois_names, n_models,
                         n_validation, trust_level, vote_prop):
    significativity_thr = 0.05 / len(clinical_names) / len(rois_names)
    local_trust_level = n_validation * trust_level
    if n_models == 1:
        pvalues = pvalues[np.newaxis]
    idx_sign = ((pvalues < significativity_thr).sum(axis=1)
                >= local_trust_level)
    idx_sign = idx_sign.sum(0) >= vote_prop * n_models
    data = {"metric": [], "roi": [], "score": []}
    for idx, score in enumerate(clinical_names):
        for name in np.asarray(rois_names)[np.where(idx_sign[idx])]:
            name, metric = split_roi_metric(name)
            data["score"].append(score)
            data["metric"].append(metric)
            data["roi"].append(name)
    return pd.DataFrame.from_dict(data), idx_sign


def daa_plot_most_connected(dataset, datasetdir, outdir, run,
                            trust_level=0.7, n_rois=5,
                            plot_associations=False, vote_prop=1.0,
                            rescaled=True, surface_atlas=None):
    """Radar plots of the most-connected ROI coefficients + area plot
    (``workflow.py:905-1121``; matplotlib radar instead of plotly).
    ``surface_atlas`` (or ``MULTIVAE_SURFACE_ATLAS``) points at a
    ``viz/surface.py`` atlas ``.npz`` for true 3-D area rendering."""
    import collections
    import glob as _glob

    from .data.cohorts import get_short_clinical_names
    from .viz.plotting import _pyplot, plot_areas, plot_radar
    from .viz.surface import resolve_atlas

    plt = _pyplot()
    # resolve once: plot_areas runs inside the per-simdir loop and should
    # not re-read the npz each iteration (instances pass straight through)
    surface_atlas = resolve_atlas(surface_atlas)

    print_title(f"PLOT DAA most associated rois: {dataset}")
    expdir = os.path.join(outdir, run)
    daadir = os.path.join(expdir, "daa")
    simdirs = [p for p in _glob.glob(os.path.join(daadir, "*"))
               if os.path.isdir(p)]
    print_text(f"Simulation directories: {','.join(simdirs)}")
    cfg = Config.load(os.path.join(expdir, "flags.json"))
    clinical_names = np.load(
        os.path.join(datasetdir, "clinical_names.npy"),
        allow_pickle=True).tolist()
    rois_names = np.load(
        os.path.join(datasetdir, "rois_names.npy"),
        allow_pickle=True).tolist()
    short_names = get_short_clinical_names(dataset, clinical_names)
    n_models = cfg.num_models

    for dirname in simdirs:
        if not os.path.exists(os.path.join(dirname, "coefs.npy")):
            continue
        coefs = np.load(os.path.join(dirname, "coefs.npy"))
        pvalues = np.load(os.path.join(dirname, "pvalues.npy"))
        n_validation = int(
            dirname.split("n_validation_")[1].split("_n_s")[0])
        df, idx_sign = _collect_significant(
            pvalues, clinical_names, rois_names, n_models, n_validation,
            trust_level, vote_prop)
        if not len(df):
            print_text(f"no significant associations in {dirname}")
            continue
        all_selected_rois = []
        for _metric, _df in df.groupby("metric"):
            counts = collections.Counter(_df["roi"].values)
            selected_rois = [item[0]
                             for item in counts.most_common(n_rois)]
            fig = plt.figure(figsize=(7, 7))
            ax = fig.add_subplot(111, polar=True)
            for _roi in selected_rois:
                roi_idx = rois_names.index(f"{_roi}_{_metric}")
                if n_models > 1:
                    sel = coefs[:, :, :, roi_idx].mean(axis=(0, 1))
                else:
                    sel = coefs[:, :, roi_idx].mean(axis=0)
                plot_radar(sel, [short_names.get(str(n), str(n))
                                 for n in clinical_names],
                           title=f"{_metric}", ax=ax)
            ax.legend(selected_rois, loc="upper right",
                      bbox_to_anchor=(1.3, 1.1), fontsize=7)
            filename = os.path.join(
                dirname, f"three_selected_rois_{_metric}_polarplots.png")
            fig.tight_layout()
            fig.savefig(filename)
            plt.close(fig)
            print_result(f"{_metric} regression coefficients for selected "
                         f"ROIs: {filename}")
            all_selected_rois += [r for r in selected_rois
                                  if r not in all_selected_rois]
        filename = os.path.join(dirname, "most_connected_rois.png")
        plot_areas(all_selected_rois, np.arange(len(all_selected_rois)),
                   save_path=filename, atlas=surface_atlas)

        if plot_associations:
            # score -> roi flow: a true parallel-categories (sankey-style)
            # equivalent of the reference's plotly Parcats diagram
            # (workflow.py:1091-1121) — Bezier bands, width ∝ |coef|,
            # color by sign — in pure matplotlib (viz.plotting.plot_parcats)
            from .viz.plotting import plot_parcats
            for _metric, _df in df.groupby("metric"):
                scores_u = sorted(_df["score"].unique().tolist())
                rois_u = sorted(_df["roi"].unique().tolist())
                flows = []
                for _, row in _df.iterrows():
                    score_idx = clinical_names.index(row["score"])
                    roi_idx = rois_names.index(f"{row['roi']}_{_metric}")
                    if n_models > 1:
                        coef = coefs[:, :, score_idx, roi_idx].mean()
                    else:
                        coef = coefs[:, score_idx, roi_idx].mean()
                    flows.append((scores_u.index(row["score"]),
                                  rois_u.index(row["roi"]), abs(coef),
                                  "#c0392b" if coef > 0 else "#2980b9"))
                short_u = [short_names.get(str(s), str(s))
                           for s in scores_u]
                flow_path = os.path.join(
                    dirname, f"score2roi_{_metric}_flow.png")
                plot_parcats(
                    flows, short_u, rois_u, save_path=flow_path,
                    title=f"score → ROI associations ({_metric})")
                print_result(f"flow for the {_metric} metric: {flow_path}")


def daa_plot_score_metric(dataset, datasetdir, outdir, run, score, metric,
                          trust_level=0.7, plot_rois=True,
                          plot_weights=True, vote_prop=1.0, rescaled=True,
                          surface_atlas=None, device="cuda"):
    """Surface + barh plots of significant ROIs for one (score, metric)
    (``workflow.py:1123-1238``). ``surface_atlas`` (or the
    ``MULTIVAE_SURFACE_ATLAS`` env var) enables true 3-D rendering; the
    run is loaded on ``device`` (``cuda`` by default) for its scalers."""
    import glob as _glob

    from .viz.plotting import plot_areas, plot_coefs
    from .viz.surface import resolve_atlas

    surface_atlas = resolve_atlas(surface_atlas)  # once, not per simdir

    print_title(f"PLOT DAA results: {dataset}")
    expdir = os.path.join(outdir, run)
    daadir = os.path.join(expdir, "daa")
    simdirs = [p for p in _glob.glob(os.path.join(daadir, "*"))
               if os.path.isdir(p)]
    experiment, cfg = load_trained(outdir, run, resolve_device(device))
    clinical_names = np.load(
        os.path.join(datasetdir, "clinical_names.npy"),
        allow_pickle=True).tolist()
    rois_names = np.load(
        os.path.join(datasetdir, "rois_names.npy"),
        allow_pickle=True).tolist()
    n_models = cfg.num_models
    scalers = experiment.scalers

    for dirname in simdirs:
        if not os.path.exists(os.path.join(dirname, "coefs.npy")):
            continue
        coefs = np.load(os.path.join(dirname, "coefs.npy"))
        pvalues = np.load(os.path.join(dirname, "pvalues.npy"))
        n_validation = int(
            dirname.split("n_validation_")[1].split("_n_s")[0])
        df, _ = _collect_significant(
            pvalues, clinical_names, rois_names, n_models, n_validation,
            trust_level, vote_prop)
        if len(df):
            print(df.groupby(["metric", "score"]).count())
        areas = df["roi"][(df["metric"] == metric)
                          & (df["score"] == score)].to_list()
        if not areas:
            print_text(f"no significant rois for {score}/{metric} in "
                       f"{dirname}")
            continue
        area_idx = [rois_names.index(f"{name}_{metric}") for name in areas]
        score_idx = clinical_names.index(score)
        if n_models > 1:
            values = coefs[:, :, score_idx, area_idx].mean(axis=(0, 1))
            if rescaled:
                scaling = np.asarray([
                    sum(scalers[i]["rois"].scale_[roi_idx]
                        / scalers[i]["clinical"].scale_[score_idx]
                        for i in range(n_models)) / n_models
                    for roi_idx in area_idx])
                values = values * scaling
        else:
            values = coefs[:, score_idx, area_idx].mean(0)
            if rescaled:
                scaling = np.asarray([
                    scalers["rois"].scale_[roi_idx]
                    / scalers["clinical"].scale_[score_idx]
                    for roi_idx in area_idx])
                values = values * scaling
        print_text(f"Number of significative rois in {metric} for {score}: "
                   f"{len(areas)}")
        filename_areas = os.path.join(
            dirname, f"associated_rois_for_{score}_in_{metric}.png")
        filename_bar = os.path.join(
            dirname, f"association_for_{score}_in_{metric}.png")
        if plot_rois:
            plot_areas(areas, np.arange(len(areas)) + 0.01,
                       save_path=filename_areas, atlas=surface_atlas)
        plot_coefs(areas, values, save_path=filename_bar)


def avatar_traverse(experiment, cfg, score_idx: int, n_frames=20,
                    n_subjects=4, seed=1037):
    """The numbers of :func:`avatar_plot_exp`: ``(traverse [n_frames],
    frames [n_frames, n_rois])``. ``n_subjects`` complete test subjects of
    the first member, drawn from ``numpy.random.default_rng(seed)``, see
    score ``score_idx`` traverse its 5-95 % quantile range in ``n_frames``
    steps while their other scores stay; a frame is the subjects' mean ROI
    avatar. One sweep of every (frame, score) cell at the latent means, on
    the avatar-sweep kernel where it takes the configuration (else the
    general sweep), on the experiment's device."""
    from .analysis.daa import avatar_sweep, complete_indices, full_batch

    testset = experiment.member_datasets(0)[1]
    rng = np.random.default_rng(seed)
    sel = rng.choice(complete_indices(testset), size=n_subjects,
                     replace=False)
    data, _ = full_batch(testset, sel, experiment.device)
    clinical = data["clinical"].cpu().numpy()
    lo, hi = np.quantile(clinical[:, score_idx], [0.05, 0.95])
    traverse = np.linspace(lo, hi, n_frames)
    # scores grid layout [n_samples, B, n_scores]: vary only score_idx
    grid = np.repeat(clinical[None], n_frames, axis=0)
    grid[:, :, score_idx] = traverse[:, None]
    generator = torch.Generator(device=experiment.device)
    generator.manual_seed(seed)
    with torch.no_grad():
        avatars = avatar_sweep(
            experiment.models[0], data,
            torch.as_tensor(grid, dtype=torch.float32,
                            device=experiment.device),
            False, generator, cfg)
        # [B, n_scores, n_frames, R] -> frames for the traversed score
        frames = avatars[:, score_idx].mean(dim=0).cpu().numpy()
    return traverse, frames


def avatar_plot_exp(dataset, datasetdir, outdir, run, score=None,
                    n_frames=20, n_subjects=4, seed=1037,
                    surface_atlas=None, metric=None, device="cuda"):
    """Avatar traverse animation (``workflow.py:1242-1373``; commented out of
    the reference CLI). Decodes a linear traverse of one score
    (:func:`avatar_traverse`, on ``device``, ``cuda`` by default) and writes
    an animated GIF + MJPEG-AVI video. With a surface atlas
    (``surface_atlas`` or ``MULTIVAE_SURFACE_ATLAS``, see ``viz/surface.py``)
    frames are true 3-D surface renders of one ROI ``metric`` (default: the
    cohort's first); otherwise frames show the ROI vector heatmap."""
    from PIL import Image

    from .viz.plotting import _pyplot
    from .viz.surface import plot_roi_values, resolve_atlas
    from .viz.video import figure_to_rgb, write_mjpeg_avi

    plt = _pyplot()
    dev = resolve_device(device)
    print_title(f"AVATAR PLOT: {dataset}")
    experiment, cfg = load_trained(outdir, run, dev)
    clinical_names = np.load(
        os.path.join(datasetdir, "clinical_names.npy"),
        allow_pickle=True).tolist()
    score_idx = clinical_names.index(score) if score else 0
    traverse, frames = avatar_traverse(experiment, cfg, score_idx, n_frames,
                                       n_subjects, seed)

    # render each frame ONCE and write both artifacts from the same rgb
    # arrays: the GIF (Pillow) and a real video file — the reference
    # renders mp4 via ffmpeg (workflow.py:1242-1373); without an ffmpeg
    # binary the closest true video container is a hand-muxed Motion-JPEG
    # AVI (viz/video.py)
    atl = resolve_atlas(surface_atlas)
    rgb_frames = []
    if atl is not None:
        # surface animation of one metric's per-ROI values, the
        # atlas-file equivalent of the reference's fsaverage traverse
        rois_names = np.load(os.path.join(datasetdir, "rois_names.npy"),
                             allow_pickle=True).tolist()
        split = [split_roi_metric(n) for n in rois_names]
        metric = metric or split[0][1]
        sel = [i for i, (_, m) in enumerate(split) if m == metric]
        if not sel:
            raise ValueError(
                f"metric {metric!r} not found in rois_names "
                f"(have {sorted({m for _, m in split})})")
        bases = [split[i][0] for i in sel]
        vmin = float(frames[:, sel].min())
        vmax = float(frames[:, sel].max())
        for i in range(n_frames):
            values = {b: float(frames[i, j]) for b, j in zip(bases, sel)}
            fig = plot_roi_values(
                atl, values, vmin=vmin, vmax=vmax,
                title=f"{metric}: {clinical_names[score_idx]} = "
                      f"{traverse[i]:.2f}")
            rgb_frames.append(figure_to_rgb(fig))
            plt.close(fig)
    else:
        fig, ax = plt.subplots(figsize=(10, 3))
        im = ax.imshow(frames[0][None, :], aspect="auto", cmap="jet",
                       vmin=frames.min(), vmax=frames.max())
        ax.set_yticks([])
        title = ax.set_title("")

        def update(i):
            im.set_data(frames[i][None, :])
            title.set_text(
                f"{clinical_names[score_idx]} = {traverse[i]:.2f}")
            return [im, title]

        for i in range(n_frames):
            update(i)
            rgb_frames.append(figure_to_rgb(fig))
        plt.close(fig)
    filename = os.path.join(outdir, run,
                            f"avatar_traverse_{clinical_names[score_idx]}.gif")
    pil = [Image.fromarray(f) for f in rgb_frames]
    pil[0].save(filename, save_all=True, append_images=pil[1:],
                duration=250, loop=0)  # 4 fps
    video = write_mjpeg_avi(filename[:-4] + ".avi", rgb_frames, fps=4)
    print_result(f"avatar animation: {filename} + {video}")
    return filename


def rsa_plot_exp(dataset, datasetdir, outdir, run):
    """Dissimilarity-matrix mosaics (``workflow.py:871-902``)."""
    from .viz.plotting import plot_mosaic

    print_title(f"PLOT RSA results: {dataset}")
    expdir = os.path.join(outdir, run)
    rsadir = os.path.join(expdir, "rsa")
    if not os.path.isfile(os.path.join(rsadir, "latent_dissimilarity.npy")):
        raise ValueError(
            f"no RSA results under {rsadir}; run the `rsa` command on this "
            "run first")
    latent_cmat = np.load(os.path.join(rsadir, "latent_dissimilarity.npy"))
    scores_cmat = np.load(os.path.join(rsadir, "scores_dissimilarity.npy"))
    print_text(f"latent dissimilarity: {latent_cmat.shape}")
    print_text(f"scores dissimilarity: {scores_cmat.shape}")
    cmat_file = os.path.join(rsadir, "dissimilarity.png")
    cmat1 = latent_cmat[0, :1] if latent_cmat.ndim > 3 else latent_cmat[:1]
    cmat1 = cmat1 / cmat1.max()
    cmat2 = scores_cmat[0][0] if scores_cmat.ndim > 3 else scores_cmat[0]
    cmat2 = cmat2 / cmat2.max()
    images = np.concatenate((cmat1.reshape(-1, *cmat1.shape[-2:]),
                             cmat2.reshape(-1, *cmat2.shape[-2:])), axis=0)
    plot_mosaic(images, cmat_file, n_cols=4, image_size=images.shape[-2:])
    return cmat_file
