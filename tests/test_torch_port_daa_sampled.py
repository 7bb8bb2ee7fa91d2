"""The port's ``sampled`` DAA artifact on the CPU.

A JAX-initialized flagship-layout model on a small synthetic cohort runs
``daa`` with ``artifact`` full, stats-only and sampled from one seed, each
in a run directory of its own. The sampled run's ROI indices are
``np.sort(default_rng(seed + 17).choice(n_rois, k, replace=False))``, its
avatars equal those columns of the full run's artifact bit for bit (both
cross the wire as float16), and its regression outputs equal the
stats-only run's bit for bit. Against the JAX package's ``sampled`` run
(deterministic linear strategy, exact float32 fetch): the indices equal,
the avatars atol 1e-5 (float32 on both sides).
"""

import os
import shutil

import numpy as np
import pytest

import jax

from multivae_tpu.analysis import daa as jax_daa
from multivae_tpu.data import make_synthetic_cohort
from multivae_tpu.train.config import Config as JaxConfig
from multivae_tpu.train.experiment import MultimodalExperiment as JaxExperiment
from multivae_tpu_torch import cli, workflows
from multivae_tpu_torch.analysis import daa
from multivae_tpu_torch.train.checkpoint import save_tree

pytestmark = pytest.mark.driver  # cross-framework parity pins

N_SCORES, N_ROIS = 4, 26
SEED, K = 23, 6
DAA_KW = dict(sampling_strategy="likelihood", n_validation=2, n_samples=10,
              n_subjects=12, M=8, trust_level=0.5, seed=SEED)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(datasetdir, JAX experiment, cfg, {name: (outdir, run)})``: one
    JAX-initialized run copied under one outdir per artifact mode."""
    root = tmp_path_factory.mktemp("daa_sampled")
    datasetdir = str(root / "data")
    make_synthetic_cohort(datasetdir, n_subjects=130, n_scores=N_SCORES,
                          n_rois=N_ROIS, missing_rate=0.15, seed=4,
                          signal_strength=2.0)
    out = {}
    for name, num_models in (("one", 1), ("two", 2)):
        cfg = JaxConfig(dataset="synthetic", datasetdir=datasetdir,
                        input_dim=[N_SCORES, N_ROIS], class_dim=5,
                        style_dim=[2, 3], hidden_dim=16,
                        num_models=num_models, seed=6).derive()
        experiment = JaxExperiment(cfg)
        base = os.path.join(str(root), f"{name}_full", "synthetic_port")
        os.makedirs(base)
        cfg.save(os.path.join(base, "flags.json"))
        for idx, params in enumerate(experiment.params):
            ckpt = os.path.join(base, "checkpoints")
            if num_models > 1:
                ckpt = os.path.join(ckpt, f"model_{idx}")
            save_tree(os.path.join(ckpt, "0000"), jax.device_get(params))
        dirs = {"full": os.path.dirname(base)}
        for mode in ("stats-only", "sampled", "cli"):
            dirs[mode] = os.path.join(str(root), f"{name}_{mode}")
            shutil.copytree(dirs["full"], dirs[mode])
        out[name] = (experiment, cfg, dirs)
    return datasetdir, out


def load(resdir, name):
    return np.load(os.path.join(resdir, name), allow_pickle=True)


def run_modes(datasetdir, dirs, **kw):
    return {mode: workflows.daa_exp(
        "synthetic", datasetdir, dirs[mode], "synthetic_port",
        artifact=mode, sampled_rois=K, device="cpu", **DAA_KW, **kw)
        for mode in ("full", "stats-only", "sampled")}


@pytest.mark.parametrize("name", ["one", "two"],
                         ids=["one-model", "two-models"])
def test_sampled_equals_full_columns_and_stats_only_stats(runs, name):
    datasetdir, by_name = runs
    _, cfg, dirs = by_name[name]
    res = run_modes(datasetdir, dirs)
    want_idx = np.sort(np.random.default_rng(SEED + 17).choice(
        N_ROIS, K, replace=False))
    idx = load(res["sampled"], daa.SAMPLED_ROIS_FILE)
    np.testing.assert_array_equal(idx, want_idx)
    assert idx.dtype == np.int32
    sub = load(res["sampled"], daa.SAMPLED_AVATARS_FILE)
    full = load(res["full"], "rois_digital_avatars.npy")
    lead = () if cfg.num_models == 1 else (cfg.num_models,)
    assert sub.shape == lead + (DAA_KW["n_validation"], DAA_KW["n_subjects"],
                                N_SCORES, DAA_KW["n_samples"], K)
    assert sub.dtype == np.float32
    np.testing.assert_array_equal(sub, full[..., idx])
    assert not os.path.exists(os.path.join(res["sampled"],
                                           "rois_digital_avatars.npy"))
    for f in ("pvalues.npy", "coefs.npy", "sampled_scores.npy",
              "rois_reconstructions.npy"):
        np.testing.assert_array_equal(load(res["sampled"], f),
                                      load(res["stats-only"], f), err_msg=f)
    with np.load(os.path.join(res["sampled"], daa.SUFFSTATS_FILE)) as a, \
            np.load(os.path.join(res["stats-only"], daa.SUFFSTATS_FILE)) as b:
        for key in ("ysum", "xysum", "yysum"):
            np.testing.assert_array_equal(a[key], b[key])
    for f in ("sampled_scores.npy", "metadatas.npy"):
        np.testing.assert_array_equal(load(res["sampled"], f),
                                      load(res["full"], f), err_msg=f)


def test_sampled_matches_jax(runs, tmp_path):
    datasetdir, by_name = runs
    experiment, cfg, dirs = by_name["one"]
    kw = dict(DAA_KW, sampling_strategy="linear", sample_latents=False,
              fetch_dtype="float32")
    want = jax_daa.run_daa(experiment, cfg, datasetdir, str(tmp_path),
                           use_sharding=False, artifact="sampled",
                           sampled_rois=K, **kw)
    got = workflows.daa_exp("synthetic", datasetdir, dirs["cli"],
                            "synthetic_port", artifact="sampled",
                            sampled_rois=K, device="cpu", **kw)
    np.testing.assert_array_equal(load(got, daa.SAMPLED_ROIS_FILE),
                                  load(want, jax_daa.SAMPLED_ROIS_FILE))
    np.testing.assert_allclose(load(got, daa.SAMPLED_AVATARS_FILE),
                               load(want, jax_daa.SAMPLED_AVATARS_FILE),
                               rtol=0, atol=1e-5)


def test_cli_daa_sampled(runs):
    datasetdir, by_name = runs
    _, _, dirs = by_name["one"]
    argv = ["daa", "--dataset", "synthetic", "--datasetdir", datasetdir,
            "--outdir", dirs["cli"], "--run", "synthetic_port", "--device",
            "cpu", "--artifact", "sampled", "--sampled-rois", "4"]
    for key, val in DAA_KW.items():
        argv += ["--" + key.replace("_", "-"), str(val)]
    assert cli.main(argv) == 0
    resdir = os.path.join(dirs["cli"], "synthetic_port", "daa",
                          daa.resdir_name(daa.params_namespace(
                              DAA_KW["n_validation"], DAA_KW["n_subjects"],
                              DAA_KW["M"], DAA_KW["n_samples"],
                              "hierarchical", DAA_KW["sampling_strategy"],
                              True, SEED)))
    assert load(resdir, daa.SAMPLED_AVATARS_FILE).shape[-1] == 4
    assert len(load(resdir, daa.SAMPLED_ROIS_FILE)) == 4
    assert os.path.isfile(os.path.join(resdir, "significant_rois.tsv"))
