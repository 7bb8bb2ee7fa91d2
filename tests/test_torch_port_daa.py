"""The port's DAA slice against the JAX package, end to end on the CPU.

A small synthetic cohort; JAX-initialized params are bridged into a port run
dir; JAX ``run_daa`` (unsharded; its Pallas sweep in interpret mode) runs
beside the port's ``daa`` workflow, both deterministic (linear strategy, no
latent sampling) with an exact float32 fetch. Tolerances: avatars and coefs
atol 1e-5 (float32 on both sides, float64 regressions), ``-log10 p`` atol
1e-3, ``significant_rois.tsv`` identical.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.analysis import daa as jax_daa
from multivae_tpu.analysis import stats as jax_stats
from multivae_tpu.data import make_synthetic_cohort
from multivae_tpu.train.config import Config as JaxConfig
from multivae_tpu.train.experiment import MultimodalExperiment as JaxExperiment
from multivae_tpu_torch import cli, workflows
from multivae_tpu_torch.analysis import daa, stats
from multivae_tpu_torch.train.checkpoint import save_tree
from multivae_tpu_torch.train.config import Config

pytestmark = pytest.mark.driver  # cross-framework parity pins

N_SCORES, N_ROIS = 5, 30
DAA_KW = dict(sampling_strategy="linear", n_validation=3, n_samples=12,
              n_subjects=20, M=8, trust_level=0.6, seed=17,
              sample_latents=False, fetch_dtype="float32")


@pytest.fixture(scope="module")
def cohort_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_daa")
    datasetdir = str(root / "data")
    make_synthetic_cohort(datasetdir, n_subjects=160, n_scores=N_SCORES,
                          n_rois=N_ROIS, missing_rate=0.15, seed=3,
                          signal_strength=2.0)
    return root, datasetdir


def jax_run(root, datasetdir, num_models):
    """A JAX experiment (initialized, not trained) and the same weights
    written as a port run dir ``<root>/out<num_models>/<run>``."""
    cfg = JaxConfig(dataset="synthetic", datasetdir=datasetdir,
                    input_dim=[N_SCORES, N_ROIS], class_dim=6,
                    style_dim=[2, 4], hidden_dim=16, num_models=num_models,
                    seed=5).derive()
    experiment = JaxExperiment(cfg)
    outdir = str(root / f"out{num_models}")
    run = "synthetic_port"
    rundir = os.path.join(outdir, run)
    os.makedirs(rundir, exist_ok=True)
    cfg.save(os.path.join(rundir, "flags.json"))
    for idx, params in enumerate(experiment.params):
        ckpt = os.path.join(rundir, "checkpoints")
        if num_models > 1:
            ckpt = os.path.join(ckpt, f"model_{idx}")
        save_tree(os.path.join(ckpt, "0000"), jax.device_get(params))
    return experiment, cfg, outdir, run


def load(resdir, name):
    return np.load(os.path.join(resdir, name), allow_pickle=True)


def tsv(resdir):
    with open(os.path.join(resdir, "significant_rois.tsv")) as fh:
        return fh.read()


@pytest.mark.parametrize("artifact,num_models",
                         [("full", 1), ("stats-only", 1), ("full", 2)])
def test_daa_matches_jax(cohort_dir, artifact, num_models):
    root, datasetdir = cohort_dir
    experiment, cfg, outdir, run = jax_run(root, datasetdir, num_models)
    want = jax_daa.run_daa(experiment, cfg, datasetdir,
                           str(root / f"jax_{artifact}_{num_models}"),
                           use_sharding=False, artifact=artifact, **DAA_KW)
    got = workflows.daa_exp("synthetic", datasetdir, outdir, run,
                            artifact=artifact, device="cpu", **DAA_KW)
    assert os.path.basename(got) == os.path.basename(want)
    if artifact == "full":
        np.testing.assert_allclose(load(got, "rois_digital_avatars.npy"),
                                   load(want, "rois_digital_avatars.npy"),
                                   rtol=0, atol=1e-5)
    else:
        for key in ("ysum", "xysum", "yysum"):
            np.testing.assert_allclose(
                load(got, daa.SUFFSTATS_FILE)[key],
                load(want, jax_daa.SUFFSTATS_FILE)[key], rtol=1e-5,
                atol=1e-4)
    for name in ("sampled_scores.npy", "rois_reconstructions.npy",
                 "coefs.npy"):
        np.testing.assert_allclose(load(got, name), load(want, name),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(load(got, "metadatas.npy"),
                                  load(want, "metadatas.npy"))
    lp_got = -np.log10(np.maximum(load(got, "pvalues.npy"), 1e-300))
    lp_want = -np.log10(np.maximum(load(want, "pvalues.npy"), 1e-300))
    np.testing.assert_allclose(lp_got, lp_want, rtol=0, atol=1e-3)
    betas_got = load(got, "all_coefs.npy")
    betas_want = load(want, "all_coefs.npy")
    assert betas_got.shape == betas_want.shape
    np.testing.assert_array_equal(betas_got[..., :2], betas_want[..., :2])
    np.testing.assert_allclose(betas_got[..., 2:].astype(float),
                               betas_want[..., 2:].astype(float),
                               rtol=0, atol=1e-5)
    assert tsv(got) == tsv(want)
    assert tsv(got).count("\n") > 1  # some links are significant


def test_cli_daa_matches_workflow(cohort_dir):
    root, datasetdir = cohort_dir
    _, _, outdir, run = jax_run(root, datasetdir, 1)
    direct = workflows.daa_exp("synthetic", datasetdir, outdir, run,
                               device="cpu", **DAA_KW)
    argv = ["daa", "--dataset", "synthetic", "--datasetdir", datasetdir,
            "--outdir", outdir, "--run", run, "--device", "cpu"]
    for key, val in DAA_KW.items():
        argv += ["--" + key.replace("_", "-"), str(val)]
    os.rename(direct, direct + "_direct")
    assert cli.main(argv) == 0
    np.testing.assert_array_equal(load(direct, "pvalues.npy"),
                                  load(direct + "_direct", "pvalues.npy"))
    assert tsv(direct) == tsv(direct + "_direct")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        workflows.resolve_device("cuda")
    assert workflows.resolve_device("cpu").type == "cpu"


def test_unported_options_raise(cohort_dir):
    root, datasetdir = cohort_dir
    _, _, outdir, run = jax_run(root, datasetdir, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        workflows.daa_exp("synthetic", datasetdir, outdir, run,
                          device="cpu", artifact="sampled", **DAA_KW)
    with pytest.raises(ValueError, match="artifact"):
        workflows.daa_exp("synthetic", datasetdir, outdir, run,
                          device="cpu", artifact="bogus", **DAA_KW)


def test_config_is_the_jax_schema(tmp_path):
    import dataclasses

    assert ([f.name for f in dataclasses.fields(Config)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
    jcfg = JaxConfig(method="jsd", input_dim=[4, 9], style_dim=[1]).derive()
    jcfg.save(str(tmp_path / "flags.json"))
    assert (dataclasses.asdict(Config.load(str(tmp_path / "flags.json")))
            == dataclasses.asdict(jcfg))


# ------------------------------------------------------- stages on their own
def test_device_suffstats_match():
    rng = np.random.default_rng(0)
    avatars = rng.normal(size=(6, 3, 9, 11)).astype(np.float32)
    scores = rng.normal(size=(9, 6, 3)).astype(np.float32)
    for rt in (None, "float16"):
        want = jax_daa._device_suffstats(jnp.asarray(avatars),
                                         jnp.asarray(scores),
                                         roundtrip_dtype=rt)
        got = daa._device_suffstats(
            torch.from_numpy(avatars), torch.from_numpy(scores),
            roundtrip_dtype=None if rt is None else torch.float16)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("strategy", ["linear", "uniform", "gaussian"])
def test_sample_artificial_scores_match(strategy):
    values = np.random.default_rng(1).normal(size=(40, 4))
    want = jax_daa.sample_artificial_scores(strategy, values, 7, 5,
                                            np.random.default_rng(2))
    got = daa.sample_artificial_scores(strategy, values, 7, 5,
                                       np.random.default_rng(2))
    np.testing.assert_array_equal(got, want)


def test_reconstruction_stats_match(cohort_dir):
    root, datasetdir = cohort_dir
    experiment, cfg, outdir, run = jax_run(root, datasetdir, 1)
    from multivae_tpu_torch.train.experiment import load_run

    port, _ = load_run(outdir, run, "cpu")
    rng = np.random.default_rng(4)
    data = {"clinical": rng.normal(size=(10, N_SCORES)).astype(np.float32),
            "rois": rng.normal(size=(10, N_ROIS)).astype(np.float32)}
    want = jax_daa.reconstruction_stats(
        experiment.model, experiment.params[0],
        {k: jnp.asarray(v) for k, v in data.items()}, 8,
        jax.random.PRNGKey(0), cfg=cfg)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    got = daa.reconstruction_stats(port.models[0], tdata, 8,
                                   torch.Generator(), cfg=cfg)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=1e-5)
    # the Monte-Carlo estimator converges to the closed form
    mc = daa.reconstruction_stats(port.models[0], tdata, 2000,
                                  torch.Generator().manual_seed(1), cfg=cfg,
                                  exact=False)
    for a, b in zip(got, mc):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=0.05)


REGRESSIONS = {
    "hierarchical_regression_batch": lambda x, y, s: (x, y),
    "hierarchical_regression_from_stats": lambda x, y, s: (x, s[0], s[1]),
    "fixed_regression_batch": lambda x, y, s: (x.reshape(-1),
                                               y.reshape(-1, y.shape[-1])),
    "fixed_regression_from_stats": lambda x, y, s: (x, *s),
    "mixed_regression_batch": lambda x, y, s: (x, y),
    "mixed_regression_from_stats": lambda x, y, s: (x, *s),
}


@pytest.mark.parametrize("name", sorted(REGRESSIONS))
def test_regressions_match_jax_stats(name):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 15))
    y = 0.3 * x[:, :, None] + rng.normal(size=(8, 15, 6))
    s = (y.sum(1), np.einsum("gn,gnr->gr", x, y),
         np.einsum("gnr,gnr->gr", y, y))
    args = REGRESSIONS[name](x, y, s)
    want = getattr(jax_stats, name)(*args)
    got = getattr(stats, name)(*args)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(stats.one_sample_ttest(x[0]),
                               jax_stats.one_sample_ttest(x[0]))
    np.testing.assert_allclose(stats.per_group_slopes(x, y),
                               jax_stats.per_group_slopes(x, y))


# ------------------------------------------------------ the general sweep
# configurations the sweep kernel does not take (their sweep is the JAX
# package's general branch, one model.apply per cell): sizes of
# tests/test_torch_port_generic.py
GEN_DIMS, GEN_B, GEN_SAMPLES = (5, 16), 7, 3
GENERAL_CONFIGS = {
    "deep-A-like": dict(num_hidden_layer_decoder=1,
                        learn_output_sample_scale=True),
    "deep-B-like": dict(num_hidden_layer_encoder=2,
                        num_hidden_layer_decoder=1, method="poe"),
    "laplace": dict(likelihood="laplace", method="moe"),
    "unfactorized": dict(factorized_representation=False, method="jsd"),
}


def general_models(name):
    """The JAX and the port's model of one configuration, the same seeded
    weights in both: ``(jcfg, jmodel, jax params, cfg, port model)``."""
    from test_torch_port_generic import both_models, seeded_tree

    from multivae_tpu_torch.params import tree_to_state_dict

    kw = dict(method="joint_elbo", input_dim=list(GEN_DIMS), class_dim=4,
              style_dim=[2, 3], hidden_dim=16)
    kw.update(GENERAL_CONFIGS[name])
    jcfg, jmodel, cfg, model = both_models(kw)
    tree = seeded_tree(model, 8)
    model.load_state_dict(tree_to_state_dict(tree))
    assert not daa.supports_fused_sweep(cfg, model, model.mod_names)
    return (jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, tree), cfg,
            model)


def general_data(seed):
    rng = np.random.default_rng(seed)
    data = {n: rng.normal(size=(GEN_B, d)).astype(np.float32)
            for n, d in zip(("clinical", "rois"), GEN_DIMS)}
    scores = rng.normal(size=(GEN_SAMPLES, GEN_B, GEN_DIMS[0])).astype(
        np.float32)
    return data, scores


@pytest.mark.parametrize("name", list(GENERAL_CONFIGS))
def test_general_sweep_matches_jax_general_branch(name):
    """Without latent sampling the sweep is deterministic: the port's
    general sweep against the JAX ``avatar_sweep``'s general branch."""
    jcfg, jmodel, params, cfg, model = general_models(name)
    data, scores = general_data(9)
    want = jax_daa.avatar_sweep(
        jmodel, params, {k: jnp.asarray(v) for k, v in data.items()},
        jnp.asarray(scores), False, jax.random.PRNGKey(0), chunk=4, cfg=jcfg)
    got = daa.avatar_sweep(model, {k: torch.from_numpy(v)
                                   for k, v in data.items()},
                           torch.from_numpy(scores), False,
                           torch.Generator().manual_seed(1), cfg, chunk=4)
    assert tuple(got.shape) == (GEN_B, GEN_DIMS[0], GEN_SAMPLES, GEN_DIMS[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name", list(GENERAL_CONFIGS))
def test_general_sweep_with_latent_samples_matches_jax_per_cell(name):
    """With latent sampling: every cell against JAX ``model.apply`` on the
    cell's batch fed the port's noise for that cell; the chunk does not
    change the result."""
    jcfg, jmodel, params, cfg, model = general_models(name)
    data, scores = general_data(10)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    tscores = torch.from_numpy(scores)
    got = daa.avatar_sweep(model, tdata, tscores, True,
                           torch.Generator().manual_seed(2), cfg, chunk=5)
    cdata, eps = daa.general_sweep_inputs(model, tdata, tscores,
                                          torch.Generator().manual_seed(2))
    assert eps.shape[-1] == model.noise_width(model.mod_names)
    cells = []
    for i in range(cdata.shape[0]):
        out = jmodel.apply({"params": params},
                           {"clinical": jnp.asarray(cdata[i].numpy()),
                            "rois": jnp.asarray(data["rois"])},
                           sample_latents=True,
                           noise=jnp.asarray(eps[i].numpy()))
        cells.append(np.asarray(out["rec"]["rois"][0]))
    want = np.stack(cells).reshape(GEN_SAMPLES, GEN_DIMS[0], GEN_B, -1)
    np.testing.assert_allclose(got.numpy(), want.transpose(2, 1, 0, 3),
                               rtol=0, atol=1e-5)
    other = daa.avatar_sweep(model, tdata, tscores, True,
                             torch.Generator().manual_seed(2), cfg, chunk=64)
    assert torch.equal(other, got)


@pytest.mark.parametrize("name", ["deep-B-like", "unfactorized"])
def test_general_sweep_sharded_equals_unsharded(name):
    """Over a 4-entry CPU mesh, 15 cells and one pad cell."""
    from multivae_tpu_torch.parallel import data_mesh

    _, _, _, cfg, model = general_models(name)
    data, scores = general_data(11)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    mesh = data_mesh(4, [torch.device("cpu")] * 4)
    for sample in (True, False):
        want = daa.avatar_sweep(model, tdata, torch.from_numpy(scores),
                                sample, torch.Generator().manual_seed(3),
                                cfg, chunk=4)
        got = daa.avatar_sweep_sharded(
            model, tdata, torch.from_numpy(scores), sample,
            torch.Generator().manual_seed(3), mesh, cfg, chunk=4)
        assert torch.equal(got, want)


def test_daa_exp_runs_on_a_deep_run(tmp_path):
    """``train_exp`` of a deep laplace run, then ``daa_exp`` on it through
    the general sweep, on the CPU; ``chunk`` is a flag of the CLI."""
    from multivae_tpu_torch.data import make_synthetic_cohort as port_cohort

    datasetdir = str(tmp_path / "data")
    port_cohort(datasetdir, n_subjects=160, n_scores=N_SCORES, n_rois=N_ROIS,
                seed=4, signal_strength=2.0)
    outdir = str(tmp_path / "out")
    run = workflows.train_exp(
        "synthetic", datasetdir, outdir, [N_SCORES, N_ROIS], latent_dim=4,
        style_dim=[2, 3], num_hidden_layer_decoder=1, likelihood="laplace",
        batch_size=32, num_epochs=2, use_tensorboard=False, device="cpu")
    resdir = workflows.daa_exp(
        "synthetic", datasetdir, outdir, run, device="cpu", chunk=5,
        **dict(DAA_KW, n_validation=2, sample_latents=True,
               sampling_strategy="likelihood"))
    avatars = load(resdir, "rois_digital_avatars.npy")
    assert avatars.shape == (2, DAA_KW["n_subjects"], N_SCORES,
                             DAA_KW["n_samples"], N_ROIS)
    assert np.isfinite(avatars).all()
    p = load(resdir, "pvalues.npy")
    assert p.shape == (2, N_SCORES, N_ROIS)
    assert np.isfinite(p).all() and ((p >= 0) & (p <= 1)).all()
    assert os.path.isfile(os.path.join(resdir, "significant_rois.tsv"))
