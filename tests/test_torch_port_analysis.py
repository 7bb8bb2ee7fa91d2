"""The port's analysis suite on the CPU, held to the JAX package on the
same inputs.

- Statistics: every function of the RSA / scalar-fit half and the one-way
  ANOVA equals the JAX package's bit for bit (the same numpy and scipy
  code); ``_mixed_reml`` also meets ``test_stats_golden.py``'s pinned
  values, and ``fit_rsa`` is held on tied dissimilarities.
- Scaling (ROADMAP Queue 3 fault 1): :class:`StandardScaler` against
  scikit-learn's on constant columns whose float64 mean is inexact,
  ``scale_`` / ``transform`` / ``inverse_transform`` at rtol 1e-12;
  :class:`OrdinalEncoder` against scikit-learn's on metadata columns.
- ``anova``, ``daa-robustness`` and ``univariate-tests`` on DAA result
  directories written with numpy in the JAX layout and on cohorts stored in
  float32 and in float64 with a constant ROI column: equal to the JAX
  package's at rtol 1e-12.
- ``rsa``: a JAX-initialized run carried into the port
  (``train.checkpoint.save_tree``): latent dissimilarities at rtol 1e-5,
  Kendall taus and p-values at 1e-4 absolute, with ``sample_latents``
  fed the JAX draws, one model and an ensemble of two.
- The avatar traverse of ``avatar-plot``: the port's plain sweep against
  the JAX package's ``avatar_sweep`` frames at rtol 1e-5 / atol 1e-6; at
  the flagship width and B = 4 the sweep kernel's plain version equals the
  general sweep, and the kernel's plan for it.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
from sklearn.preprocessing import OrdinalEncoder as SkOrdinalEncoder
from sklearn.preprocessing import StandardScaler as SkStandardScaler

import test_stats_golden as golden
from multivae_tpu import workflows as jax_workflows
from multivae_tpu.analysis import anova as jax_anova
from multivae_tpu.analysis import avatars as jax_avatars
from multivae_tpu.analysis import daa as jax_daa
from multivae_tpu.analysis import rsa as jax_rsa
from multivae_tpu.analysis import stats as jax_stats
from multivae_tpu.data import make_synthetic_cohort
from multivae_tpu.train.checkpoint import save_checkpoint as jax_save
from multivae_tpu.train.config import Config as JaxConfig
from multivae_tpu.train.experiment import MultimodalExperiment as JaxExperiment
from multivae_tpu_torch import workflows
from multivae_tpu_torch.analysis import anova, avatars, daa, rsa, stats
from multivae_tpu_torch.data.preprocess import OrdinalEncoder, StandardScaler
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.ops import fused_daa
from multivae_tpu_torch.params import dims_from
from multivae_tpu_torch.train.checkpoint import save_tree
from multivae_tpu_torch.train.config import Config
from multivae_tpu_torch.train.experiment import load_trained

pytestmark = pytest.mark.driver  # cross-framework parity pins


def assert_same(got, want, rtol=0.0):
    """Equal structures: tuples and lists element by element, frames by
    ``assert_frame_equal``, arrays and numbers at ``rtol`` (0: equal)."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w, rtol)
    elif isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_exact=rtol == 0,
                                      rtol=rtol or 1e-5)
    elif want is None:
        assert got is None
    elif rtol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


# ------------------------------------------------------------ statistics
def grouped_frame(seed, n_groups=12, n_per=25, slope=0.5, subj_sd=0.3,
                  noise=0.2):
    """``test_stats.py``'s grouped data: per-group slopes around
    ``slope``, with a covariate column."""
    rng = np.random.default_rng(seed)
    rows = []
    for g in range(n_groups):
        x = rng.normal(size=n_per)
        b_g = slope + rng.normal() * subj_sd
        y = 1.0 + b_g * x + noise * rng.normal(size=n_per)
        for xi, yi in zip(x, y):
            rows.append({"participant_id": f"s{g:02d}", "x": xi, "y": yi,
                         "age": rng.uniform(8, 30)})
    return pd.DataFrame(rows)


def stats_cases():
    rng = np.random.default_rng(11)
    x3 = rng.normal(size=(12, 6, 2))
    ref6 = jax_stats.data2cmat(rng.normal(size=(6, 2)))
    ints = rng.integers(0, 3, size=(14, 2)).astype(float)  # tied distances
    labels = rng.choice(np.array(["a", "b", "c"]), size=14)
    df = grouped_frame(3)
    frame = df.iloc[:40]
    X, y = jax_stats._design(df, "x", ["age"]), df["y"].to_numpy()
    groups = df["participant_id"].to_numpy()
    vals = rng.normal(size=(90, 6))
    sites = np.repeat(["a", "b", "c"], 30)
    vals[sites == "b"] += 0.5
    return {
        "data2cmat 2-d": ("data2cmat", (rng.normal(size=(10, 3)),)),
        "data2cmat 3-d": ("data2cmat", (x3,)),
        "cmat2triu": ("cmat2triu", (rng.normal(size=(7, 7)),)),
        "vec2cmat": ("vec2cmat", (rng.normal(size=9),)),
        "vec2cmat categorical": ("vec2cmat", (labels,), {"categorical":
                                                         True}),
        "fit_rsa": ("fit_rsa", (jax_stats.data2cmat(rng.normal(
            size=(14, 3))), jax_stats.vec2cmat(rng.normal(size=14)))),
        "fit_rsa tied": ("fit_rsa", (jax_stats.data2cmat(ints),
                                     jax_stats.vec2cmat(labels,
                                                        categorical=True))),
        "fit_rsa 3-d": ("fit_rsa", (jax_stats.data2cmat(x3[:10]), ref6),
                        {"idxs": np.arange(6)}),
        "_design": ("_design", (frame, "x", ["age"])),
        "ols_fit": ("ols_fit", (X, y)),
        "_mixed_reml": ("_mixed_reml", (X, y, groups)),
        "make_regression fixed": ("make_regression", (df, "x", "y"),
                                  {"other_cov_names": ["age"]}),
        "make_regression mixed": ("make_regression", (df, "x", "y"),
                                  {"groups_name": "participant_id",
                                   "method": "mixed"}),
        "make_regression hierarchical": (
            "make_regression", (df, "x", "y"),
            {"groups_name": "participant_id", "method": "hierarchical"}),
        "one_way_anova_batch": ("one_way_anova_batch", (vals, sites)),
    }


STATS_CASES = stats_cases()


@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_stats_function_equals_jax(case):
    """The same code on the same inputs: equal outputs (the tolerance
    asked of these float64 functions, rtol 1e-12, is met with 0)."""
    name, args, *kw = STATS_CASES[case]
    kw = kw[0] if kw else {}
    want = getattr(jax_stats, name)(*args, **kw)
    got = getattr(stats, name)(*args, **kw)
    assert_same(got, want)


def test_fit_rsa_on_tied_dissimilarities():
    """Kendall's tau-b on matrices with ties (integer-valued latents and a
    categorical covariate): finite, equal to scipy's on the upper
    triangles, and the same as the JAX package's."""
    from scipy.stats import kendalltau

    _, (cmat, ref) = STATS_CASES["fit_rsa tied"]
    a, b = stats.cmat2triu(cmat), stats.cmat2triu(ref)
    assert len(np.unique(a)) < len(a) and len(np.unique(b)) == 2
    tau, pval = stats.fit_rsa(cmat, ref)
    assert np.isfinite(tau) and 0 <= pval <= 1
    assert (tau, pval) == tuple(kendalltau(a, b))
    assert (tau, pval) == jax_stats.fit_rsa(cmat, ref)


@pytest.mark.parametrize("name", sorted(golden.FIXTURES))
def test_mixed_reml_meets_pinned_goldens(name):
    """``test_stats_golden.py``'s pinned dense-REML values, at its own
    tolerances, for the port's ``_mixed_reml``; equal to the JAX one on
    the same fixture."""
    kw, beta_g, se_g, p_g = golden.FIXTURES[name]
    X, y, groups = golden.make_data(**kw)
    beta, pvals, se = stats._mixed_reml(X, y, groups)
    np.testing.assert_allclose(beta, beta_g, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(se, se_g, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(np.log10(np.maximum(pvals, 1e-300)),
                               np.log10(np.maximum(p_g, 1e-300)), atol=0.01)
    assert_same((beta, pvals, se), jax_stats._mixed_reml(X, y, groups))


def test_mixed_reml_balanced_between_group_closed_form():
    """``test_stats_golden.py``'s closed form for a balanced design with a
    group-constant regressor."""
    kw = golden.FIXTURES["between_x"][0]
    X, y, groups = golden.make_data(**kw)
    g, n = kw["g"], kw["n"]
    ybar = y.reshape(g, n).mean(axis=1)
    Xm = X.reshape(g, n, 2)[:, 0, :]
    bm, *_ = np.linalg.lstsq(Xm, ybar, rcond=None)
    r = ybar - Xm @ bm
    se_closed = np.sqrt((r @ r) / (g - 2) * np.linalg.inv(Xm.T @ Xm)[1, 1])
    beta, _, se = stats._mixed_reml(X, y, groups)
    np.testing.assert_allclose(beta[1], bm[1], rtol=1e-7)
    np.testing.assert_allclose(se[1], se_closed, rtol=1e-4)


# ------------------------------------------------ scaling and encoding
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("n", [7, 100, 1763])
@pytest.mark.parametrize("const", [0.1, 3.3, 1000.1, 123456.7])
def test_scaler_inexact_constant_matches_sklearn(const, n, dtype):
    """A constant column whose float64 mean is inexact is left unscaled,
    as scikit-learn's ``_is_constant_feature`` decides; beside it a
    varying column and an exact constant."""
    rng = np.random.default_rng(n)
    X = np.stack([np.full(n, const), 3.0 * rng.normal(size=n) + 1.0,
                  np.full(n, 2.0)], axis=1).astype(dtype)
    ours, ref = StandardScaler().fit(X), SkStandardScaler().fit(X)
    for attr in ("mean_", "var_", "scale_"):
        np.testing.assert_allclose(getattr(ours, attr), getattr(ref, attr),
                                   rtol=1e-12, atol=0, err_msg=attr)
    assert ours.scale_[0] == ref.scale_[0] == 1.0
    assert ours.n_samples_seen_ == ref.n_samples_seen_ == n
    Z = np.concatenate([X, rng.normal(size=(5, 3)).astype(dtype)])
    for fn in ("transform", "inverse_transform"):
        got, want = getattr(ours, fn)(Z), getattr(ref, fn)(Z)
        assert got.dtype == want.dtype == dtype
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   err_msg=fn)


def metadata_frame(n=60, seed=0):
    rng = np.random.default_rng(seed)
    site = rng.choice(np.array(["siteB", "siteA", "site10", "site2"]),
                      size=n)
    with_nan = rng.choice(np.array([1.5, np.nan, 0.25]), size=n)
    mixed = np.array([v if i % 3 else int(v[-1]) for i, v in
                      enumerate(rng.choice(np.array(["x1", "y2", "z3"]),
                                           size=n))], dtype=object)
    return pd.DataFrame({"sex": rng.integers(1, 3, size=n),
                         "site": site, "score": with_nan,
                         "mixed": mixed, "neg": rng.integers(-12, 12,
                                                             size=n)})


@pytest.mark.parametrize("column", ["sex", "site", "score", "mixed", "neg",
                                    "all"])
def test_ordinal_encoder_matches_sklearn(column):
    """The categories of each column cast to ``str`` (ints, strings, NaN
    as ``'nan'``, mixed objects), as ``univariate_tests`` encodes them."""
    frame = metadata_frame()
    cols = list(frame.columns) if column == "all" else [column]
    X = np.asarray(frame[cols]).astype(str)
    ours, ref = OrdinalEncoder(), SkOrdinalEncoder()
    got, want = ours.fit_transform(X), ref.fit_transform(X)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    for a, b in zip(ours.categories_, ref.categories_):
        np.testing.assert_array_equal(a, b)
    unknown = X[:2].copy()
    unknown[0, 0] = "never-seen"
    with pytest.raises(ValueError):
        ours.transform(unknown)
    with pytest.raises(ValueError):
        ref.transform(unknown)


# --------------------------------------- anova, robustness, univariate
N_SCORES, N_ROIS = 5, 36
DAA_KW = dict(n_validation=3, n_samples=20, n_subjects=14, M=8,
              seed=31)
PARAMS = dict(reg_method="hierarchical", sampling_strategy="likelihood",
              sample_latents=True)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("analysis_cohort"))
    make_synthetic_cohort(d, n_subjects=150, n_scores=N_SCORES,
                          n_rois=N_ROIS, missing_rate=0.15, seed=3,
                          signal_strength=2.0)
    return d


def write_daa_result(root, datasetdir, num_models, seed=0):
    """A DAA result directory in the JAX layout, written with numpy:
    ``flags.json``, ``pvalues.npy`` (a few hundred below the Bonferroni
    threshold) and the hierarchical ``all_coefs.npy`` records
    (participant_id, site, per-ROI betas). Returns ``(outdir, run,
    resdir)``."""
    rng = np.random.default_rng(seed)
    outdir, run = os.path.join(root, f"daa_{num_models}"), "synthetic_daa"
    cfg = JaxConfig(dataset="synthetic", datasetdir=datasetdir,
                    input_dim=[N_SCORES, N_ROIS], num_models=num_models)
    os.makedirs(os.path.join(outdir, run))
    cfg.save(os.path.join(outdir, run, "flags.json"))
    ns = jax_daa.params_namespace(DAA_KW["n_validation"],
                                  DAA_KW["n_subjects"], DAA_KW["M"],
                                  DAA_KW["n_samples"], PARAMS["reg_method"],
                                  PARAMS["sampling_strategy"],
                                  PARAMS["sample_latents"], DAA_KW["seed"])
    resdir = os.path.join(outdir, run, "daa", jax_daa.resdir_name(ns))
    os.makedirs(resdir)
    n_val, b = DAA_KW["n_validation"], DAA_KW["n_subjects"]
    shape = (num_models, n_val, N_SCORES, N_ROIS)
    pvalues = rng.uniform(size=shape)
    driven = rng.uniform(size=shape) < 0.4
    pvalues[driven] = 10.0 ** rng.uniform(-12, -3, size=driven.sum())
    records = np.empty((num_models, n_val, N_SCORES), dtype=object)
    for idx in np.ndindex(records.shape):
        pid = np.asarray([f"sub-{i:05d}" for i in rng.choice(150, b)],
                         dtype=object)
        site = rng.choice(np.array(["siteA", "siteB", "siteC"]), b)
        betas = rng.normal(size=(b, N_ROIS))
        betas[site == "siteB"] += 3.0 * (idx[2] == 1)
        records[idx] = np.concatenate([np.stack([pid, site.astype(object)],
                                                1), betas.astype(object)], 1)
    lead = (0,) if num_models == 1 else ()
    np.save(os.path.join(resdir, "pvalues.npy"),
            pvalues[lead] if lead else pvalues)
    np.save(os.path.join(resdir, "all_coefs.npy"),
            records[lead] if lead else records, allow_pickle=True)
    return outdir, run, resdir


@pytest.mark.parametrize("num_models", [1, 2], ids=["one", "two"])
@pytest.mark.parametrize("trust_level, vote_prop", [(0.75, 1.0),
                                                    (0.34, 0.5)])
def test_anova_equals_jax(cohort, tmp_path, num_models, trust_level,
                          vote_prop):
    outdir, run, resdir = write_daa_result(str(tmp_path), cohort,
                                           num_models)
    kw = dict(DAA_KW, **PARAMS, trust_level=trust_level,
              vote_prop=vote_prop)
    want = jax_workflows.anova_exp("synthetic", cohort, outdir, run, **kw)
    got = workflows.anova_exp("synthetic", cohort, outdir, run, **kw)
    assert got.shape == (num_models, DAA_KW["n_validation"], N_SCORES,
                         N_ROIS)
    assert_same(got, want, rtol=1e-12)
    np.testing.assert_array_equal(
        np.load(os.path.join(resdir, "anova_pvalues.npy")), got)
    # site shifts score 1's betas: its ROIs carry the site effect
    assert np.median(got[:, :, 1]) < 1e-2 < np.median(got[:, :, 0])
    with pytest.raises(ValueError, match="hierachical"):
        workflows.anova_exp("synthetic", cohort, outdir, run,
                            **dict(kw, reg_method="fixed"))


def test_anova_run_equals_jax_with_a_missing_resdir(cohort, tmp_path):
    outdir, run, resdir = write_daa_result(str(tmp_path), cohort, 1)
    clinical = np.load(os.path.join(cohort, "clinical_names.npy"),
                       allow_pickle=True)
    rois = np.load(os.path.join(cohort, "rois_names.npy"), allow_pickle=True)
    assert_same(anova.run_anova(resdir, clinical, rois, 1, 3),
                jax_anova.run_anova(resdir, clinical, rois, 1, 3))
    with pytest.raises(ValueError, match="Available under"):
        workflows.anova_exp("synthetic", cohort, outdir, run,
                            **dict(DAA_KW, **PARAMS, seed=32))


@pytest.mark.parametrize("num_models", [1, 2], ids=["one", "two"])
def test_robustness_counts_equal_jax(cohort, tmp_path, num_models):
    outdir, run, resdir = write_daa_result(str(tmp_path), cohort,
                                           num_models)
    kw = dict(DAA_KW, **PARAMS)
    want = jax_avatars.assess_robustness("synthetic", cohort, outdir, run,
                                         **kw)
    figs = sorted(os.listdir(os.path.join(resdir, "figures")))
    for f in figs:
        os.remove(os.path.join(resdir, "figures", f))
    got = avatars.assess_robustness("synthetic", cohort, outdir, run, **kw)
    assert sorted(os.listdir(os.path.join(resdir, "figures"))) == figs
    assert len(figs) == num_models + num_models
    for key in ("per_model", "per_vote_prop"):
        assert list(got[key]) == list(want[key])
        for k in want[key]:
            assert len(want[key][k])
            pd.testing.assert_frame_equal(got[key][k], want[key][k])


def float64_cohort(src, dst):
    """``src``'s cohort stored in float64, with ROI column 4 the constant
    3.3 (its float64 mean is inexact) and ROI column 7 the exact 2.0."""
    import shutil

    shutil.copytree(src, dst)
    rois = np.load(os.path.join(dst, "rois_data.npy")).astype(np.float64)
    rois[:, 4] = 3.3
    rois[:, 7] = 2.0
    np.save(os.path.join(dst, "rois_data.npy"), rois)
    clinical = np.load(os.path.join(dst, "clinical_data.npy"))
    np.save(os.path.join(dst, "clinical_data.npy"),
            clinical.astype(np.float64))
    return dst


@pytest.mark.parametrize("stored", ["float32", "float64-constant"])
def test_univariate_tests_equal_jax(cohort, tmp_path, stored):
    datasetdir = cohort
    if stored != "float32":
        datasetdir = float64_cohort(cohort, str(tmp_path / "cohort64"))
    kw = dict(continuous_covs=["age"], categorical_covs=["sex", "site"])
    want = jax_avatars.univariate_tests("synthetic", datasetdir,
                                        outdir=str(tmp_path / "jax"), **kw)
    got = avatars.univariate_tests("synthetic", datasetdir,
                                   outdir=str(tmp_path / "port"), **kw)
    assert got[0].shape == (N_SCORES, N_ROIS)
    assert_same(got, want, rtol=1e-12)
    for name in ("univariate_pvalues.npy", "univariate_associations.npy"):
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / "univariate" / name),
            np.load(tmp_path / "jax" / "univariate" / name))
    assert sorted(os.listdir(tmp_path / "port" / "univariate")) == sorted(
        os.listdir(tmp_path / "jax" / "univariate"))
    # the first score drives the first ROI block
    thr = 0.05 / N_SCORES / N_ROIS
    assert (got[0][0, :3] < thr).all()
    numbers = avatars.univariate_pvalues(datasetdir, **kw)
    assert_same(numbers, got)


# ------------------------------------------------------------------- rsa
@pytest.fixture(scope="module")
def shared_runs(cohort, tmp_path_factory):
    """JAX-initialized runs, one model and an ensemble of two, each in both
    packages' checkpoint formats: ``{num_models: (JAX experiment, cfg,
    outdir, run)}``."""
    root = tmp_path_factory.mktemp("analysis_runs")
    runs = {}
    for num_models in (1, 2):
        cfg = JaxConfig(dataset="synthetic", datasetdir=cohort,
                        input_dim=[N_SCORES, N_ROIS], class_dim=6,
                        style_dim=[2, 3], hidden_dim=24,
                        num_models=num_models, seed=9).derive()
        experiment = JaxExperiment(cfg)
        outdir, run = str(root / f"out{num_models}"), "synthetic_shared"
        rundir = os.path.join(outdir, run)
        os.makedirs(rundir)
        cfg.save(os.path.join(rundir, "flags.json"))
        for idx, params in enumerate(experiment.params):
            ckpt = os.path.join(rundir, "checkpoints")
            if num_models > 1:
                ckpt = os.path.join(ckpt, f"model_{idx}")
            params = jax.device_get(params)
            jax_save(os.path.join(ckpt, "0000"), params)
            save_tree(os.path.join(ckpt, "0000"), params)
        runs[num_models] = (experiment, cfg, outdir, run)
    return runs


def jax_noise(seed, calls):
    """The JAX package's draws (``rsa.py:62-81``: ``fold_in(fold_in(
    PRNGKey(seed), 7000 * model + round), latent)``) in the port's noise
    interface."""
    base = jax.random.PRNGKey(seed)

    def draw(model_idx, val_idx, latent_idx, shape):
        calls.append((model_idx, val_idx, latent_idx))
        key = jax.random.fold_in(jax.random.fold_in(
            base, 7000 * model_idx + val_idx), latent_idx)
        return torch.from_numpy(np.array(jax.random.normal(
            key, shape=tuple(shape), dtype=jnp.float32)))

    return draw


RSA_KW = dict(n_validation=2, n_subjects=25, seed=17)


@pytest.mark.parametrize("num_models, sample", [(1, False), (1, True),
                                                (2, False), (2, True)],
                         ids=["one-means", "one-sampled", "two-means",
                              "two-sampled"])
def test_run_rsa_matches_jax(cohort, shared_runs, tmp_path, num_models,
                             sample):
    experiment, cfg, outdir, run = shared_runs[num_models]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jax_rsa.run_rsa(experiment, cfg, cohort, str(tmp_path / "jax"),
                           sample_latents=sample, **RSA_KW)
    port_exp, port_cfg = load_trained(outdir, run, "cpu")
    calls = []
    got = rsa.run_rsa(port_exp, port_cfg, cohort, str(tmp_path / "port"),
                      sample_latents=sample,
                      noise=jax_noise(RSA_KW["seed"], calls), **RSA_KW)
    n_lat = len(rsa.LATENT_NAMES)
    assert calls == ([(m, v, k) for m in range(num_models)
                      for v in range(RSA_KW["n_validation"])
                      for k in range(n_lat)] if sample else [])
    assert got.shape == want.shape == (num_models, n_lat,
                                       RSA_KW["n_validation"],
                                       N_SCORES + 3, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    def load(side, name):
        return np.load(tmp_path / side / name)

    np.testing.assert_allclose(load("port", "latent_dissimilarity.npy"),
                               load("jax", "latent_dissimilarity.npy"),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(load("port", "scores_dissimilarity.npy"),
                                  load("jax", "scores_dissimilarity.npy"))
    for latent in rsa.LATENT_NAMES:
        name = f"kendalltau_{latent}.tsv"
        a = pd.read_table(tmp_path / "port" / name)
        b = pd.read_table(tmp_path / "jax" / name)
        assert list(a.score) == list(b.score)
        np.testing.assert_allclose(a.drop(columns="score"),
                                   b.drop(columns="score"), atol=1e-4)


def test_rsa_noise_streams():
    """One stream per (model, round, latent), the same on every call."""
    draw = rsa.rsa_noise(5)
    a = draw(0, 1, 2, (4, 3))
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    torch.testing.assert_close(draw(0, 1, 2, (4, 3)), a, rtol=0, atol=0)
    for other in (draw(1, 1, 2, (4, 3)), draw(0, 0, 2, (4, 3)),
                  draw(0, 1, 3, (4, 3)), rsa.rsa_noise(6)(0, 1, 2, (4, 3))):
        assert not torch.equal(other, a)


def test_rsa_exp_default_noise_and_plot(cohort, shared_runs):
    """``rsa_exp`` on the CPU with sampled latents draws from
    :func:`rsa_noise` (two calls equal), then ``rsa_plot_exp``."""
    _, _, outdir, run = shared_runs[1]
    first = workflows.rsa_exp("synthetic", cohort, outdir, run,
                              sample_latents=True, device="cpu", **RSA_KW)
    again = workflows.rsa_exp("synthetic", cohort, outdir, run,
                              sample_latents=True, device="cpu", **RSA_KW)
    np.testing.assert_array_equal(first, again)
    assert np.all(np.abs(first[..., 0]) <= 1)
    png = workflows.rsa_plot_exp("synthetic", cohort, outdir, run)
    assert os.path.getsize(png) > 0


# ------------------------------------------------------- avatar traverse
def test_avatar_traverse_matches_jax(cohort, shared_runs, monkeypatch):
    """The JAX ``avatar_plot_exp`` (its ``avatar_sweep`` recorded) and the
    port's :func:`avatar_traverse` on the same run, selection and grid."""
    _, _, outdir, run = shared_runs[1]
    recorded = []
    real = jax_daa.avatar_sweep

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        recorded.append((args, kwargs, np.asarray(out)))
        return out

    monkeypatch.setattr(jax_daa, "avatar_sweep", record)
    score_idx, kw = 2, dict(n_frames=6, n_subjects=4, seed=5)
    gif = jax_workflows.avatar_plot_exp("synthetic", cohort, outdir, run,
                                        score=f"score_{score_idx}", **kw)
    assert os.path.isfile(gif)
    (args, kwargs, avatars_jax), = recorded
    assert kwargs["sample_latents"] is False  # no noise to feed
    grid = np.asarray(args[3])
    want = avatars_jax[:, score_idx].mean(axis=0)
    port_exp, port_cfg = load_trained(outdir, run, "cpu")
    traverse, frames = workflows.avatar_traverse(port_exp, port_cfg,
                                                 score_idx, **kw)
    np.testing.assert_array_equal(traverse.astype(np.float32),
                                  grid[:, 0, score_idx])
    assert frames.shape == (kw["n_frames"], N_ROIS)
    np.testing.assert_allclose(frames, want, rtol=1e-5, atol=1e-6)


def flagship_b4():
    """A seeded flagship-width model and a B = 4 traverse grid: 20 frames
    x 7 scores = 140 cells."""
    cfg = Config(method="joint_elbo", input_dim=[7, 444], class_dim=20,
                 style_dim=[3, 20], hidden_dim=256).derive()
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    data = {"clinical": torch.randn((4, 7), generator=gen),
            "rois": torch.randn((4, 444), generator=gen)}
    grid = data["clinical"][None].repeat(20, 1, 1)
    grid[:, :, 2] = torch.linspace(-1.5, 1.5, 20)[:, None]
    return cfg, model, data, grid


def test_flagship_traverse_plan_and_plain_sweep():
    """The sweep kernel's plan for the flagship traverse (560 rows: 18
    tiles of 32 over 132 SMs, resident weights, tiles straddling cells of 4
    rows), and its plain version equal to the general sweep there."""
    cfg, model, data, grid = flagship_b4()
    dims = dims_from(cfg, 4)
    plan = fused_daa.sweep_plan(dims, 132, 140 * 4)
    assert plan == fused_daa.SweepPlan(rows=32, split=6, resident=True,
                                       h_chunk=0, k_chunk=0, n_chunk=0,
                                       grid=18, smem=197648)
    assert fused_daa.supports_fused_sweep(cfg, model, data)
    kernel_route = daa.avatar_sweep(model, data, grid, False,
                                    torch.Generator(), cfg)
    cdata, eps = daa.general_sweep_inputs(model, data, grid,
                                          torch.Generator())
    general = fused_daa.avatar_layout(daa.general_sweep_cells(
        model, cdata, data["rois"], eps, False), 20, 7)
    assert kernel_route.shape == (4, 7, 20, 444)
    torch.testing.assert_close(kernel_route, general, rtol=1e-5, atol=1e-5)


def test_avatar_plot_exp_writes_gif_and_avi(cohort, shared_runs):
    """``avatar_plot_exp`` on the CPU: the GIF and an MJPEG AVI of
    ``n_frames`` frames (its ``avih`` header and ``idx1`` index)."""
    import struct

    _, _, outdir, run = shared_runs[1]
    gif = workflows.avatar_plot_exp("synthetic", cohort, outdir, run,
                                    score="score_1", n_frames=5,
                                    n_subjects=3, device="cpu")
    avi = gif[:-4] + ".avi"
    assert os.path.getsize(gif) > 0
    raw = open(avi, "rb").read()
    total_frames = struct.unpack("<I", raw[raw.index(b"avih") + 24:
                                           raw.index(b"avih") + 28])[0]
    assert total_frames == 5
    assert raw.count(b"00dc") == 2 * 5  # a chunk and an index entry each
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            workflows.avatar_plot_exp("synthetic", cohort, outdir, run)
