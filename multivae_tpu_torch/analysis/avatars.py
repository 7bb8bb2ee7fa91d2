"""Post-hoc avatar analyses: sampled-score distributions, robustness sweeps,
and the mass-univariate baseline.

Counterpart of ``multivae_tpu/analysis/avatars.py`` (host numpy, scipy and
pandas; the figures through matplotlib, imported inside the functions that
draw). Reference: ``experiments/analyze_avatars.py`` (``analyze_avatars``
``:17-104``, ``assess_robustness`` ``:107-215``, ``univariate_tests``
``:217-315``). Figures are saved into the run/dataset directory (the
reference calls ``plt.show()``; headless here). The numbers of the last
two come apart from their figures: :func:`robustness_counts` and
:func:`univariate_pvalues`.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

from ..data.cohorts import get_short_clinical_names
from ..train.config import Config
from ..train.experiment import load_trained
from ..utils.colors import print_result, print_text
from .daa import (
    SAMPLED_AVATARS_FILE,
    SAMPLED_ROIS_FILE,
    params_namespace,
    require_resdir,
    resdir_name,
)


def _load_daa_dir(outdir, run, n_validation, n_subjects, M, n_samples,
                  reg_method, sampling_strategy, sample_latents, seed=None):
    params = params_namespace(n_validation, n_subjects, M, n_samples,
                              reg_method, sampling_strategy, sample_latents,
                              seed)
    if seed is None:
        # analyze_avatars' namespace omits the seed (analyze_avatars.py:38-42)
        del params.__dict__["seed"]
    return require_resdir(os.path.join(outdir, run, "daa",
                                       resdir_name(params)))


def _load_avatars(resdir, rois_names):
    """The avatar tensor for the scatter diagnostics: the full artifact
    when present, else the ``--artifact sampled`` ROI subsample (a random
    column subset — statistically equivalent input for plots that pick 3
    random ROIs anyway, ``analyze_avatars.py:125``). Returns the tensor
    and the ROI names matching its last axis."""
    full = os.path.join(resdir, "rois_digital_avatars.npy")
    if os.path.exists(full):
        return np.load(full, mmap_mode="r"), rois_names
    sub_file = os.path.join(resdir, SAMPLED_AVATARS_FILE)
    if os.path.exists(sub_file):
        sub_idx = np.load(os.path.join(resdir, SAMPLED_ROIS_FILE))
        print_text(f"full avatar artifact absent; using the "
                   f"{len(sub_idx)}-ROI subsample written by "
                   f"--artifact sampled")
        return (np.load(sub_file, mmap_mode="r"),
                np.asarray(rois_names)[sub_idx])
    raise FileNotFoundError(
        f"{resdir} holds neither 'rois_digital_avatars.npy' (daa "
        f"--artifact full) nor '{SAMPLED_AVATARS_FILE}' (--artifact "
        f"sampled); daa-analysis needs one of them (stats-only runs "
        f"serve only anova/daa-robustness)")


def analyze_avatars(dataset, datasetdir, outdir, run, n_validation=5,
                    n_samples=200, n_subjects=50, M=1000,
                    reg_method="hierarchical",
                    sampling_strategy="likelihood", sample_latents=True,
                    val_step=0, seed=1037, n_subjects_to_plot=5,
                    model_idx=0):
    """KDE of sampled scores vs true values + avatar-vs-score scatters
    (``analyze_avatars.py:17-104``).

    Fixed upstream intent: ensemble (``num_models>1``) DAA artifacts carry
    a leading models axis that the reference's ``da[val_step]`` slicing
    ignores (``analyze_avatars.py:64-66`` selects a *model* and crashes
    downstream); here ``model_idx`` picks the ensemble member to analyze
    (with its own scalers) and single-model artifacts behave as before.
    No model runs: the run's scalers come from its experiment loaded on
    the CPU.
    """
    from matplotlib import colors

    from ..viz.plotting import _pyplot

    plt = _pyplot()
    experiment, flags = load_trained(outdir, run, "cpu")
    resdir = _load_daa_dir(outdir, run, n_validation, n_subjects, M,
                           n_samples, reg_method, sampling_strategy,
                           sample_latents, seed)
    clinical_data = np.load(os.path.join(datasetdir, "clinical_data.npy"),
                            mmap_mode="r")
    clinical_subjects = np.load(
        os.path.join(datasetdir, "clinical_subjects.npy"), allow_pickle=True)
    clinical_names = np.load(os.path.join(datasetdir, "clinical_names.npy"),
                             allow_pickle=True)
    rois_names = np.load(os.path.join(datasetdir, "rois_names.npy"),
                         allow_pickle=True)

    da, rois_names = _load_avatars(resdir, rois_names)
    scores = np.load(os.path.join(resdir, "sampled_scores.npy"))
    metadata = np.load(os.path.join(resdir, "metadatas.npy"),
                       allow_pickle=True)
    if flags.num_models > 1:
        if not 0 <= model_idx < da.shape[0]:
            raise ValueError(
                f"model_idx {model_idx} out of range for the "
                f"{da.shape[0]}-member ensemble artifact")
        da, scores = da[model_idx], scores[model_idx]
        metadata = metadata[model_idx]
    elif model_idx != 0:
        raise ValueError(
            f"model_idx {model_idx} requested but this run trained a single "
            "model (num_models == 1); only model_idx 0 exists")
    da, scores, metadata = da[val_step], scores[val_step], metadata[val_step]

    rng = np.random.default_rng(seed)
    subj_indices = rng.integers(len(scores), size=n_subjects_to_plot)
    scalers = (experiment.scalers if flags.num_models == 1
               else experiment.scalers[model_idx])
    short_names = get_short_clinical_names(dataset, clinical_names)
    tab = list(colors.TABLEAU_COLORS)

    figdir = os.path.join(resdir, "figures")
    os.makedirs(figdir, exist_ok=True)
    for score_idx, score in enumerate(clinical_names):
        fig = plt.figure()
        for idx, subj_idx in enumerate(subj_indices):
            sampled = scores[subj_idx]
            true = scalers["clinical"].inverse_transform(
                sampled)[:, score_idx]
            try:
                import seaborn as sns
                sns.kdeplot(true, color=tab[idx % len(tab)])
            except Exception:
                plt.hist(true, bins=30, alpha=0.4, color=tab[idx % len(tab)])
            pid = metadata[subj_idx, 0]
            subj_pos = clinical_subjects.tolist().index(pid)
            plt.axvline(clinical_data[subj_pos, score_idx],
                        color=tab[idx % len(tab)])
        plt.title(short_names.get(str(score), str(score)))
        plt.tight_layout()
        fig.savefig(os.path.join(figdir, f"sampled_scores_{score}.png"))
        plt.close(fig)

    n_plot_scores = min(4, len(clinical_names))
    selected_scores = list(range(n_plot_scores))
    selected_rois = rng.integers(len(rois_names), size=3)
    fig, axes = plt.subplots(
        n_plot_scores, len(selected_rois), sharey=True, squeeze=False,
        figsize=(5 * len(selected_rois), 3 * n_plot_scores))
    for idx, score_idx in enumerate(selected_scores):
        for roi_num, roi_idx in enumerate(selected_rois):
            axes[idx, roi_num].scatter(
                scores[subj_indices, :, score_idx].flatten(),
                da[subj_indices, score_idx, :, roi_idx].flatten(),
                c=np.repeat(np.arange(n_subjects_to_plot)[:, None],
                            scores.shape[1], axis=1).flatten(), s=4)
            if idx == 0:
                axes[idx, roi_num].set_title(str(rois_names[roi_idx]))
            if roi_num == 0:
                axes[idx, roi_num].set_ylabel(
                    short_names.get(str(clinical_names[score_idx]),
                                    str(clinical_names[score_idx])))
    fig.tight_layout()
    fig.savefig(os.path.join(figdir, "avatars_vs_scores.png"))
    plt.close(fig)
    print_result(f"figures: {figdir}")
    return figdir


def _counts_df(idx_sign, clinical_names, rois_names):
    data = {"metric": [], "roi": [], "score": []}
    for idx, score in enumerate(clinical_names):
        for name in np.asarray(rois_names)[np.where(idx_sign[idx])]:
            name, metric = str(name).rsplit("_", 1)
            data["score"].append(score)
            data["metric"].append(metric)
            data["roi"].append(name)
    return pd.DataFrame.from_dict(data)


def _assoc_table(idx_sign_at, trust_levels, clinical_names, rois_names):
    """Association counts per (score, metric) at every trust level:
    ``idx_sign_at(trust_level)`` is the ``[n_scores, n_rois]`` vote."""
    assoc = {"score": [], "metric": [], "trust_level": [], "num_assoc": []}
    for trust_level in trust_levels:
        counts = _counts_df(idx_sign_at(trust_level), clinical_names,
                            rois_names).groupby(["score", "metric"]).count()
        for (score, metric), count in counts["roi"].items():
            assoc["score"].append(score)
            assoc["metric"].append(metric)
            assoc["trust_level"].append(trust_level)
            assoc["num_assoc"].append(count)
    return pd.DataFrame(assoc).sort_values("trust_level")


def robustness_counts(pvalues, clinical_names, rois_names, n_validation,
                      num_models, n_models_to_plot=5):
    """The numbers of :func:`assess_robustness`: ``{"per_model": {idx:
    frame}, "per_vote_prop": {vote_prop: frame}}``, each frame the
    association counts (``score, metric, trust_level, num_assoc``) at trust
    levels 0, 0.05, ..., 1 of one ensemble member or one vote proportion.
    ``pvalues``: ``[(num_models,) n_validation, n_scores, n_rois]`` as
    ``pvalues.npy`` stores it."""
    n_rois, n_scores = len(rois_names), len(clinical_names)
    significativity_thr = 0.05 / n_rois / n_scores
    if num_models == 1:
        pvalues = pvalues[np.newaxis]
    trust_levels = np.arange(0, 1.01, 0.05)
    results = {"per_model": {}, "per_vote_prop": {}}
    for model_idx in range(num_models)[:n_models_to_plot]:
        results["per_model"][model_idx] = _assoc_table(
            lambda t: ((pvalues[model_idx] < significativity_thr).sum(
                axis=0) >= n_validation * t),
            trust_levels, clinical_names, rois_names)
    for vote_prop in np.linspace(0.5, 1, min(n_models_to_plot, num_models)):
        results["per_vote_prop"][float(vote_prop)] = _assoc_table(
            lambda t: (((pvalues < significativity_thr).sum(axis=1)
                        >= n_validation * t).sum(0)
                       >= vote_prop * num_models),
            trust_levels, clinical_names, rois_names)
    return results


def assess_robustness(dataset, datasetdir, outdir, run, n_validation=5,
                      n_samples=200, n_subjects=50, M=1000,
                      reg_method="hierarchical",
                      sampling_strategy="likelihood", sample_latents=True,
                      seed=1037, n_models_to_plot=5):
    """Association counts vs trust level / vote proportion
    (``analyze_avatars.py:107-215``): :func:`robustness_counts` and one
    figure per member and per vote proportion."""
    resdir = _load_daa_dir(outdir, run, n_validation, n_subjects, M,
                           n_samples, reg_method, sampling_strategy,
                           sample_latents, seed)
    clinical_names = np.load(os.path.join(datasetdir, "clinical_names.npy"),
                             allow_pickle=True)
    rois_names = np.load(os.path.join(datasetdir, "rois_names.npy"),
                         allow_pickle=True)
    flags = Config.load(os.path.join(outdir, run, "flags.json"))
    pvalues = np.load(os.path.join(resdir, "pvalues.npy"))
    results = robustness_counts(pvalues, clinical_names, rois_names,
                                n_validation, flags.num_models,
                                n_models_to_plot)

    from ..viz.plotting import _pyplot

    plt = _pyplot()
    n_scores = len(clinical_names)
    trust_levels = np.arange(0, 1.01, 0.05)
    figdir = os.path.join(resdir, "figures")
    os.makedirs(figdir, exist_ok=True)
    ncols = 4
    nrows = int(np.ceil(n_scores / ncols))
    figures = ([(assoc, f"robustness_model_{model_idx}.png")
                for model_idx, assoc in results["per_model"].items()]
               + [(assoc, f"robustness_vote_{vote_prop:.2f}.png")
                  for vote_prop, assoc in results["per_vote_prop"].items()])
    for assoc, name in figures:
        fig, axes = plt.subplots(nrows, ncols, squeeze=False,
                                 figsize=(4 * ncols, 3 * nrows))
        for score_idx, score in enumerate(clinical_names):
            ax = axes[score_idx // ncols, score_idx % ncols]
            for metric, counts in assoc[assoc["score"] == score].groupby(
                    "metric"):
                ax.plot(trust_levels[:len(counts)], counts["num_assoc"],
                        label=metric)
            ax.set_title(str(score))
            if score_idx == n_scores - 1:
                ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(figdir, name))
        plt.close(fig)
    print_result(f"figures: {figdir}")
    return results


def univariate_pvalues(datasetdir, continuous_covs=(), categorical_covs=()):
    """The numbers of :func:`univariate_tests`: ``(pvalues, associations)``,
    each ``[n_scores, n_rois]``, of the OLS fits ``roi ~ score (+
    covariates)`` on the subjects with both blocks, each block standardized
    in its stored dtype and the categorical covariates ordinal-coded.

    The reference loops statsmodels fits per (score, roi); here each score's
    ``n_rois`` regressions share one design matrix and are solved in a single
    lstsq + t-test batch.
    """
    from scipy import stats as sstats

    from ..data.fetchers import extract_and_order_by
    from ..data.preprocess import OrdinalEncoder, StandardScaler

    continuous_covs = list(np.atleast_1d(continuous_covs))
    categorical_covs = list(np.atleast_1d(categorical_covs))

    rois_data = np.load(os.path.join(datasetdir, "rois_data.npy"),
                        mmap_mode="r")
    rois_subjects = np.load(os.path.join(datasetdir, "rois_subjects.npy"),
                            allow_pickle=True)
    rois_names = np.load(os.path.join(datasetdir, "rois_names.npy"),
                         allow_pickle=True)
    clinical_data = np.load(os.path.join(datasetdir, "clinical_data.npy"),
                            mmap_mode="r")
    clinical_subjects = np.load(
        os.path.join(datasetdir, "clinical_subjects.npy"), allow_pickle=True)
    clinical_names = np.load(os.path.join(datasetdir, "clinical_names.npy"),
                             allow_pickle=True)
    metadata = pd.read_table(os.path.join(datasetdir, "metadata.tsv"))

    subjects = sorted(set(clinical_subjects.tolist())
                      & set(rois_subjects.tolist()))
    rois_idx = [rois_subjects.tolist().index(s) for s in subjects]
    clin_idx = [clinical_subjects.tolist().index(s) for s in subjects]
    rois_mat = StandardScaler().fit_transform(np.asarray(rois_data)[rois_idx])
    clin_mat = StandardScaler().fit_transform(
        np.asarray(clinical_data)[clin_idx])
    metadata = extract_and_order_by(metadata, "participant_id", subjects)

    n_rois, n_scores = len(rois_names), len(clinical_names)
    associations = np.zeros((n_scores, n_rois))
    pvalues = np.zeros((n_scores, n_rois))

    # shared covariate columns
    cov_cols = [np.asarray(metadata[c], dtype=float)
                for c in continuous_covs]
    for c in categorical_covs:
        enc = OrdinalEncoder().fit_transform(
            np.asarray(metadata[c]).astype(str)[:, None])[:, 0]
        cov_cols.append(enc)

    n = len(subjects)
    for score_idx in range(n_scores):
        X = np.stack([np.ones(n), clin_mat[:, score_idx]] + cov_cols, axis=1)
        # one lstsq for all rois at once
        beta, _, rank, _ = np.linalg.lstsq(X, rois_mat, rcond=None)
        resid = rois_mat - X @ beta
        dof = n - X.shape[1]
        sigma2 = (resid ** 2).sum(axis=0) / dof
        xtx_inv = np.linalg.pinv(X.T @ X)
        se = np.sqrt(xtx_inv[1, 1] * sigma2)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(se > 0, beta[1] / se, np.inf)
        pvalues[score_idx] = 2.0 * sstats.t.sf(np.abs(t), dof)
        associations[score_idx] = beta[1]
    return pvalues, associations


def univariate_tests(dataset, datasetdir, continuous_covs=(),
                     categorical_covs=(), seed=1037, outdir=None,
                     surface_atlas=None):
    """Mass-univariate OLS baseline ``roi ~ score (+ covariates)`` with
    Bonferroni correction (``analyze_avatars.py:217-315``):
    :func:`univariate_pvalues`, saved under ``<outdir>/univariate``
    (``outdir`` defaults to ``datasetdir``) with the areas and coefficients
    plots of every score that has a significant ROI."""
    from ..data.cohorts import split_roi_metric
    from ..viz.plotting import plot_areas, plot_coefs
    from ..viz.surface import resolve_atlas

    pvalues, associations = univariate_pvalues(datasetdir, continuous_covs,
                                               categorical_covs)
    rois_names = np.load(os.path.join(datasetdir, "rois_names.npy"),
                         allow_pickle=True)
    clinical_names = np.load(os.path.join(datasetdir, "clinical_names.npy"),
                             allow_pickle=True)
    significativity_thr = 0.05 / len(rois_names) / len(clinical_names)
    idx_sign = pvalues < significativity_thr
    print_text(f"total significant: {idx_sign.sum()}")
    outdir = outdir or datasetdir
    figdir = os.path.join(outdir, "univariate")
    os.makedirs(figdir, exist_ok=True)
    np.save(os.path.join(figdir, "univariate_pvalues.npy"), pvalues)
    np.save(os.path.join(figdir, "univariate_associations.npy"),
            associations)

    surface_atlas = resolve_atlas(surface_atlas)  # once, not per score
    for score_idx, score in enumerate(clinical_names):
        if idx_sign[score_idx].sum() == 0:
            continue
        sig_rois = np.where(idx_sign[score_idx])[0]
        areas = [split_roi_metric(rois_names[i])[0] for i in sig_rois]
        values = associations[score_idx, sig_rois]
        print_text(f"{score}: {len(areas)} significant rois")
        plot_areas(areas, np.arange(len(areas)) + 0.01,
                   save_path=os.path.join(figdir, f"areas_{score}.png"),
                   atlas=surface_atlas)
        plot_coefs(areas, values,
                   save_path=os.path.join(figdir, f"coefs_{score}.png"))
    print_result(f"univariate outputs: {figdir}")
    return pvalues, associations
