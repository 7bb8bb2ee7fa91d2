"""The port's eval slice as a whole on the CPU: ``train`` with every eval
flag, the cadence of an ensemble, and the ``eval`` command against the JAX
package's at a shared checkpoint.

For the ``eval`` comparison the JAX draws are fed to the port: the IWAE
importance draws rebuilt from ``PRNGKey(seed + 99)`` with the JAX
package's split / ``fold_in`` chain, the generations' normals recorded from
eager ``model.apply`` calls with the JAX package's keys (``seed + 7`` with
``fold_in(., 1)``, ``seed + 13``). Tolerances: the likelihood rows rtol
2e-5 / atol 1e-4 (float32 sums in other orders); the PRD rows atol 1e-6
(k-means of float32 generations that agree to ~1e-6, float64 host code);
the accuracy and coherence rows equal.
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from multivae_tpu import workflows as jax_workflows
from multivae_tpu.data import make_synthetic_cohort
from multivae_tpu.train.checkpoint import save_checkpoint as jax_save
from multivae_tpu.train.config import Config as JaxConfig
from multivae_tpu.train.experiment import MultimodalExperiment as JaxExperiment
from multivae_tpu_torch import cli, workflows
from multivae_tpu_torch.eval import coherence, likelihood, sample_quality
from multivae_tpu_torch.models import mmvae as port_mmvae
from multivae_tpu_torch.train.checkpoint import save_tree

pytestmark = pytest.mark.driver  # cross-framework parity pins

DIMS, CD, STYLE, BATCH = (3, 10), 4, (2, 3), 16
FAMILIES = ("Likelihoods", "PRD", "Latent Representation", "Generation")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("eval_cohort"))
    make_synthetic_cohort(d, n_subjects=140, n_scores=DIMS[0],
                          n_rois=DIMS[1], missing_rate=0.15, seed=2)
    return d


def train(cohort, outdir, epochs, **kw):
    return workflows.train_exp(
        "synthetic", cohort, str(outdir), list(DIMS), latent_dim=CD,
        style_dim=list(STYLE), batch_size=BATCH, num_epochs=epochs,
        use_tensorboard=False, device="cpu", **kw)


def evals(csv):
    return csv[csv.phase.isin(FAMILIES)]


def test_train_with_every_eval_flag(cohort, tmp_path, monkeypatch):
    """4 epochs at ``eval_freq = eval_freq_fid = 2``: the four families at
    steps of epochs 2 and 4, one conditional-generation pass per hit, the
    modality classifiers fit once, and the sample dumps."""
    gen_calls, fit_calls = [], []
    real_gen = sample_quality.generate_conditional_samples
    real_fit = coherence.train_modality_classifiers
    monkeypatch.setattr(sample_quality, "generate_conditional_samples",
                        lambda *a, **k: gen_calls.append(1)
                        or real_gen(*a, **k))
    monkeypatch.setattr(coherence, "train_modality_classifiers",
                        lambda *a, **k: fit_calls.append(1)
                        or real_fit(*a, **k))
    run = train(cohort, tmp_path, 4, calc_nll=True, calc_prd=True,
                calc_clf=True, calc_coherence=True, eval_freq=2,
                eval_freq_fid=2, save_samples=True)
    rundir = tmp_path / run
    csv = pd.read_csv(rundir / "logs" / "metrics.csv")
    ev = evals(csv)
    steps = sorted(set(ev.step))
    assert len(steps) == 2
    for step in steps:
        assert set(ev[ev.step == step].phase) == set(FAMILIES)
    assert np.isfinite(ev.value).all()
    lik = ev[ev.phase == "Likelihoods"]
    assert set(lik.metric) == {f"{s}/{m}" for s in ("clinical", "rois",
                                                   "clinical_rois")
                               for m in ("clinical", "rois", "joint")}
    acc = ev[ev.phase.isin(["Latent Representation", "Generation"])]
    assert acc.value.between(0, 1).all()
    assert "Random" in set(ev[ev.phase == "Generation"].metric)
    # two cadence hits and the dump after training
    assert len(gen_calls) == 3 and len(fit_calls) == 1
    fid = rundir / "fid"
    assert sorted(os.listdir(fid)) == ["clinical", "clinical_rois", "random",
                                       "real", "rois"]
    n_real = len(os.listdir(fid / "real" / "rois"))
    assert n_real > 0
    assert len(os.listdir(fid / "random" / "clinical")) == n_real
    row = np.load(fid / "clinical" / "rois" / "000000.npy")
    assert row.shape == (DIMS[1],)


@pytest.mark.parametrize("parallel", [True, False],
                         ids=["ensemble-runner", "in-turn"])
def test_ensemble_logs_the_likelihoods_of_each_member(cohort, tmp_path,
                                                      parallel):
    run = train(cohort, tmp_path, 2, num_models=2, calc_nll=True,
                eval_freq=1, ensemble_parallel=parallel)
    lik = []
    for m in range(2):
        csv = pd.read_csv(tmp_path / run / "logs" / f"model_{m}"
                          / "metrics.csv")
        ev = evals(csv)
        assert set(ev.phase) == {"Likelihoods"}
        assert len(set(ev.step)) == 2 and np.isfinite(ev.value).all()
        lik.append(ev.value.to_numpy())
    assert not np.array_equal(lik[0], lik[1])  # members of their own


# ------------------------------------------------- eval against the JAX one
@pytest.fixture(scope="module")
def shared_run(cohort, tmp_path_factory):
    """A JAX-initialized run written in both packages' checkpoint formats
    (the port's ``model.npz`` beside the JAX package's ``model``)."""
    root = tmp_path_factory.mktemp("eval_shared")
    cfg = JaxConfig(dataset="synthetic", datasetdir=cohort,
                    input_dim=list(DIMS), class_dim=CD, style_dim=list(STYLE),
                    hidden_dim=24, seed=7).derive()
    experiment = JaxExperiment(cfg)
    outdir, run = str(root / "out"), "synthetic_shared"
    rundir = os.path.join(outdir, run)
    os.makedirs(rundir)
    cfg.save(os.path.join(rundir, "flags.json"))
    params = jax.device_get(experiment.params[0])
    for epoch in ("0000", "0003"):
        ckpt = os.path.join(rundir, "checkpoints", epoch)
        jax_save(ckpt, params)
        save_tree(ckpt, params)
    return experiment, cfg, outdir, run


def feed_jax_noise(monkeypatch, experiment, cfg):
    """Make the port draw the JAX package's noise (module docstring)."""
    model, params = experiment.model, experiment.params[0]
    variables = {"params": params}
    state = {"rng": jax.random.PRNGKey(cfg.seed + 99)}

    def jax_importance(tmodel, batch, k, generator=None):
        state["rng"], sub = jax.random.split(state["rng"])
        rng_c, rng_s = jax.random.split(sub)
        b = next(iter(batch.values())).shape[0]
        out = {}
        for s_idx, (s_key, mods) in enumerate(model.subsets.items()):
            if not all(m in batch for m in mods):
                continue
            style = {}
            for i, mod in enumerate(model.modalities):
                key = jax.random.fold_in(jax.random.fold_in(rng_s, s_idx), i)
                style[mod.name] = torch.from_numpy(np.array(
                    jax.random.normal(key, (k, b, mod.style_dim))))
            out[s_key] = {"content": torch.from_numpy(np.array(
                jax.random.normal(jax.random.fold_in(rng_c, s_idx),
                                  (k, b, cfg.class_dim)))),
                "style": style}
        return out

    monkeypatch.setattr(likelihood, "importance_noise", jax_importance)

    # the generations' normals: eager applies with the JAX package's keys
    testset = experiment.dataset_test
    data, _, _ = testset.gather(testset.idx_per_modality_subset[-1])
    r = jax.random.PRNGKey(cfg.seed + 7)
    latents = model.apply(variables, data, method="inference",
                          rngs={"sample": r})
    draws = []
    real = jax.random.normal

    def normal(*args, **kwargs):
        out = real(*args, **kwargs)
        draws.append(torch.from_numpy(np.array(out)))
        return out

    monkeypatch.setattr(jax.random, "normal", normal)
    model.apply(variables, latents["subsets"], method="cond_generation",
                rngs={"sample": jax.random.fold_in(r, 1)})
    model.apply(variables, 256, method="generate",
                rngs={"sample": jax.random.PRNGKey(cfg.seed + 13)})
    monkeypatch.setattr(jax.random, "normal", real)
    queue = list(draws)

    def port_normal(shape, generator, device):
        out = queue.pop(0)
        assert tuple(out.shape) == tuple(shape)
        return out.to(device)

    monkeypatch.setattr(port_mmvae, "_normal", port_normal)
    return queue


def test_eval_exp_matches_jax(shared_run, cohort, monkeypatch):
    experiment, cfg, outdir, run = shared_run
    want = pd.read_table(jax_workflows.eval_exp(
        "synthetic", cohort, outdir, run))
    shutil.move(os.path.join(outdir, run, "eval", "eval_latest.tsv"),
                os.path.join(outdir, run, "eval", "jax_latest.tsv"))
    queue = feed_jax_noise(monkeypatch, experiment, cfg)
    got_path = workflows.eval_exp("synthetic", cohort, outdir, run,
                                  device="cpu")
    assert got_path.endswith(os.path.join("eval", "eval_latest.tsv"))
    assert not queue  # every JAX draw was taken
    got = pd.read_table(got_path)
    assert list(got.columns) == ["model", "family", "metric", "value"]
    assert list(zip(got.family, got.metric)) == list(zip(want.family,
                                                         want.metric))
    assert set(got.family) == set(FAMILIES)
    for family, rtol, atol in (("Likelihoods", 2e-5, 1e-4),
                               ("PRD", 0, 1e-6),
                               ("Latent Representation", 0, 0),
                               ("Generation", 0, 0)):
        sel = got.family == family
        np.testing.assert_allclose(got.value[sel], want.value[sel],
                                   rtol=rtol, atol=atol, err_msg=family)


def test_eval_exp_load_epoch_and_cli(shared_run, cohort):
    """``load_epoch`` picks the newest checkpoint at or before it and tags
    the file; the CLI's ``eval`` equals the workflow; two runs on one
    checkpoint give the same file (the noise is seeded)."""
    _, _, outdir, run = shared_run
    out1 = workflows.eval_exp("synthetic", cohort, outdir, run, prd=False,
                              coherence=False, load_epoch=2, device="cpu")
    assert out1.endswith("eval_0002.tsv")
    first = pd.read_table(out1)
    assert set(first.family) == {"Likelihoods", "Latent Representation"}
    assert cli.main(["eval", "--dataset", "synthetic", "--datasetdir",
                     cohort, "--outdir", outdir, "--run", run, "--prd",
                     "false", "--coherence", "false", "--load-epoch", "2",
                     "--device", "cpu"]) == 0
    pd.testing.assert_frame_equal(pd.read_table(out1), first)
