"""The port's eval building blocks against the JAX package, on shared numpy
inputs, weights and noise (the JAX draws recorded or rebuilt here and fed
to the port).

Tolerances: float32 on both sides with sums in other orders; the model
and IWAE paths rtol 2e-5 / atol 1e-5 (the IWAE scalars, ~1e2 in size, atol
1e-4); the elementwise helpers 1e-6. The scikit-learn stand-ins: k-means
labels equal and inertia rtol 1e-10 (float64, sums in numpy's order);
logistic regression coefficients rtol 1e-6 against scikit-learn run to
``tol=1e-12`` and 2e-3 of the largest coefficient against its default
``tol=1e-4`` (its own error), predictions equal wherever scikit-learn's
decision is farther than 1e-3 from the boundary. PRD, FID and the
embeddings rtol 1e-9 (float64 host code).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu import ops as jax_ops
from multivae_tpu.eval import likelihood as jax_likelihood
from multivae_tpu.eval import prd as jax_prd
from multivae_tpu.eval import sample_quality as jax_sq
from multivae_tpu.models import build_model as jax_build_model
from multivae_tpu.models import make_modalities as jax_make_modalities
from multivae_tpu.train import Config
from multivae_tpu.train import trainer as jax_trainer
from multivae_tpu.train.train_step import init_params as jax_init_params
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.eval import estimators, likelihood, prd, \
    sample_quality
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.models import mmvae as port_mmvae
from multivae_tpu_torch.ops import gaussian, likelihoods
from multivae_tpu_torch.train import trainer

pytestmark = pytest.mark.driver  # cross-framework parity pins

B, K = 12, 5
DIMS = (4, 9)
CD = 5
STYLE = (2, 3)
HIDDEN = 16
METHODS = ("joint_elbo", "moe", "jsd", "poe")
RTOL, ATOL = 2e-5, 1e-5


def make_batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    return {"clinical": rng.normal(size=(b, DIMS[0])).astype(np.float32),
            "rois": rng.normal(size=(b, DIMS[1])).astype(np.float32)}


def jax_pair(method, factorized=True, seed=3):
    """A JAX model and params, and the port's model with the same
    weights."""
    cfg = Config(method=method, input_dim=list(DIMS), class_dim=CD,
                 style_dim=list(STYLE), hidden_dim=HIDDEN,
                 factorized_representation=factorized).derive()
    jmodel = jax_build_model(cfg, jax_make_modalities(
        cfg.input_dim, cfg.style_dim, cfg.likelihood))
    params = jax_init_params(cfg, jmodel, {k: jnp.asarray(v) for k, v in
                                           make_batch(seed).items()},
                             seed=seed)
    tmodel = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                              cfg.likelihood), "cpu")
    tmodel.load_state_dict(bridge.tree_to_state_dict(jax.device_get(params)))
    return jmodel, params, tmodel


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_tree_close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_tree_close(got[k], want[k], rtol, atol)
    elif isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            assert_tree_close(g, w, rtol, atol)
    elif want is None:
        assert got is None
    else:
        np.testing.assert_allclose(np_(got), np_(want), rtol=rtol, atol=atol)


# ------------------------------------------------------------------ ops
def test_gaussian_helpers_match():
    rng = np.random.default_rng(0)
    x, mu, lv = (rng.normal(size=(K, B, 6)).astype(np.float32)
                 for _ in range(3))
    t = {k: torch.from_numpy(v) for k, v in dict(x=x, mu=mu, lv=lv).items()}
    assert_tree_close(gaussian.gaussian_log_pdf(t["x"], t["mu"], t["lv"]),
                      jax_ops.gaussian_log_pdf(x, mu, lv), 1e-6, 1e-5)
    assert_tree_close(gaussian.unit_gaussian_log_pdf(t["x"]),
                      jax_ops.unit_gaussian_log_pdf(x), 1e-6, 1e-5)
    w = 30.0 * x[..., 0]
    for axis in (0, 1):
        assert_tree_close(gaussian.log_mean_exp(torch.from_numpy(w), axis),
                          jax_ops.log_mean_exp(w, axis), 1e-6, 1e-5)


def jax_draw(name, key, shape):
    """The base draw that ``multivae_tpu/ops/likelihoods.py:sample`` makes
    from ``key``."""
    if name == "normal":
        return jax.random.normal(key, shape)
    if name == "laplace":
        return jax.random.uniform(key, shape, jnp.float32, 1e-7, 1 - 1e-7)
    if name == "bernoulli":
        return jax.random.uniform(key, shape)
    return jax.random.uniform(key, shape, jnp.float32,
                              jnp.finfo(jnp.float32).tiny, 1.0)


@pytest.mark.parametrize("name", likelihoods.LIKELIHOODS)
def test_likelihood_sample_matches(name):
    rng = np.random.default_rng(1)
    loc = rng.normal(size=(64, 7)).astype(np.float32)
    scale = np.exp(rng.normal(size=(64, 7))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jax_ops.sample(name, key, loc, scale)
    noise = torch.from_numpy(np.array(jax_draw(name, key, loc.shape)))
    got = likelihoods.sample(name, torch.from_numpy(loc),
                             torch.from_numpy(scale), noise=noise)
    assert_tree_close(got, want, 1e-6, 1e-5)
    # a generator's draw is the law of the fed-in noise
    gen = torch.Generator().manual_seed(2)
    drawn = likelihoods.sample(name, torch.from_numpy(loc),
                               torch.from_numpy(scale), generator=gen)
    fed = likelihoods.sample(
        name, torch.from_numpy(loc), torch.from_numpy(scale),
        noise=likelihoods.sample_noise(name, loc.shape,
                                       torch.Generator().manual_seed(2)))
    assert torch.equal(drawn, fed)


# ----------------------------------------------------------- generation
def record_normals(monkeypatch):
    """Record every ``jax.random.normal`` draw (eager calls only)."""
    draws = []
    real = jax.random.normal

    def normal(*args, **kwargs):
        out = real(*args, **kwargs)
        draws.append(torch.from_numpy(np.array(out)))
        return out

    monkeypatch.setattr(jax.random, "normal", normal)
    return draws


def feed_normals(monkeypatch, draws):
    """Make the port's model take ``draws`` in order for its normals."""
    queue = list(draws)

    def normal(shape, generator, device):
        out = queue.pop(0)
        assert tuple(out.shape) == tuple(shape)
        return out.to(device)

    monkeypatch.setattr(port_mmvae, "_normal", normal)
    return queue


@pytest.mark.parametrize("factorized", [True, False],
                         ids=["factorized", "unfactorized"])
@pytest.mark.parametrize("method", ["joint_elbo", "moe"])
def test_generation_matches(monkeypatch, method, factorized):
    jmodel, params, tmodel = jax_pair(method, factorized)
    variables = {"params": params}
    batch = make_batch(5)
    latents = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, method="inference")
    tlat = tmodel.inference({k: torch.from_numpy(v)
                             for k, v in batch.items()})
    assert_tree_close(tlat["subsets"], latents["subsets"])

    draws = record_normals(monkeypatch)
    want_cond = jmodel.apply(variables, latents["subsets"],
                             method="cond_generation",
                             rngs={"sample": jax.random.PRNGKey(7)})
    cond_draws = list(draws)
    draws.clear()
    want_gen = jmodel.apply(variables, 9, method="generate",
                            rngs={"sample": jax.random.PRNGKey(8)})
    gen_draws = list(draws)
    draws.clear()
    n_styles = 2 if factorized else 0
    assert len(cond_draws) == n_styles + len(latents["subsets"])
    assert len(gen_draws) == 1 + n_styles

    with torch.no_grad():
        queue = feed_normals(monkeypatch, cond_draws)
        got_cond = tmodel.cond_generation(tlat["subsets"])
        assert not queue
        queue = feed_normals(monkeypatch, gen_draws)
        got_gen = tmodel.generate(9)
        assert not queue
    assert_tree_close(got_cond, want_cond)
    assert_tree_close(got_gen, want_gen)

    # the building blocks, on one set of latents
    z = np.random.default_rng(6).normal(size=(B, CD)).astype(np.float32)
    styles = jmodel.apply(variables, B, method="get_random_styles",
                          rngs={"sample": jax.random.PRNGKey(9)})
    lat_j = {"content": jnp.asarray(z), "style": styles}
    lat_t = {"content": torch.from_numpy(z),
             "style": {k: None if v is None else torch.from_numpy(
                 np.array(v)) for k, v in styles.items()}}
    with torch.no_grad():
        assert_tree_close(
            tmodel.generate_sufficient_statistics_from_latents(lat_t),
            jmodel.apply(variables, lat_j, method=(
                "generate_sufficient_statistics_from_latents")))
        assert_tree_close(
            tmodel.generate_from_latents(lat_t),
            jmodel.apply(variables, lat_j, method="generate_from_latents"))
        assert_tree_close(
            tmodel.get_random_styles(B, noise=lat_t["style"]), styles, 0, 0)
    assert_tree_close(tmodel.get_random_style_dists(B),
                      jmodel.apply(variables, B,
                                   method="get_random_style_dists"), 0, 0)


def test_generation_draw_order():
    """With a generator: ``generate`` draws the content, then the styles
    in modality order; ``cond_generation`` the styles, then one content
    per subset in the dict's order."""
    _, _, tmodel = jax_pair("joint_elbo")
    lat = tmodel.inference({k: torch.from_numpy(v) for k, v in
                            make_batch(2).items()})["subsets"]
    g = torch.Generator().manual_seed(11)
    rows = {"clinical": STYLE[0], "rois": STYLE[1]}
    with torch.no_grad():
        got = tmodel.generate(B, generator=torch.Generator().manual_seed(11))
        want = tmodel.generate(B, noise={
            "content": torch.randn((B, CD), generator=g),
            "style": {m: torch.randn((B, d), generator=g)
                      for m, d in rows.items()}})
        assert_tree_close(got, want, 0, 0)
        g = torch.Generator().manual_seed(12)
        got = tmodel.cond_generation(
            lat, generator=torch.Generator().manual_seed(12))
        style = {m: torch.randn((B, d), generator=g) for m, d in rows.items()}
        content = {k: torch.randn((B, CD), generator=g) for k in lat}
        want = tmodel.cond_generation(lat, noise={"style": style,
                                                  "content": content})
        assert_tree_close(got, want, 0, 0)


# ----------------------------------------------------------------- IWAE
def jax_importance_noise(jmodel, batch, rng, k):
    """The draws ``_batch_likelihoods_impl`` makes from ``rng``
    (``multivae_tpu/eval/likelihood.py:80-108``), in the port's layout."""
    rng_c, rng_s = jax.random.split(rng)
    b = next(iter(batch.values())).shape[0]
    out = {}
    for s_idx, (s_key, mods) in enumerate(jmodel.subsets.items()):
        if not all(m in batch for m in mods):
            continue
        content = jax.random.normal(jax.random.fold_in(rng_c, s_idx),
                                    (k, b, CD))
        style = {}
        for i, mod in enumerate(jmodel.modalities):
            if jmodel.factorized_representation and mod.style_dim > 0:
                style[mod.name] = torch.from_numpy(np.array(
                    jax.random.normal(jax.random.fold_in(
                        jax.random.fold_in(rng_s, s_idx), i),
                        (k, b, mod.style_dim))))
            else:
                style[mod.name] = None
        out[s_key] = {"content": torch.from_numpy(np.array(content)),
                      "style": style}
    return out


@pytest.mark.parametrize("factorized", [True, False],
                         ids=["factorized", "unfactorized"])
@pytest.mark.parametrize("present", [("clinical", "rois"), ("clinical",)],
                         ids=["complete", "rois-missing"])
@pytest.mark.parametrize("method", METHODS)
def test_batch_likelihoods_matches(method, present, factorized):
    jmodel, params, tmodel = jax_pair(method, factorized)
    data = make_batch(8)
    jbatch = {m: jnp.asarray(data[m]) for m in present}
    tbatch = {m: torch.from_numpy(data[m]) for m in present}
    rng = jax.random.PRNGKey(21)
    want = jax_likelihood._batch_likelihoods_impl(jmodel, params, jbatch,
                                                  rng, K)
    got = likelihood.batch_likelihoods(
        tmodel, tbatch, num_imp_samples=K,
        noise=jax_importance_noise(jmodel, jbatch, rng, K))
    assert set(got) == set(want)
    assert_tree_close(got, want, RTOL, 1e-4)


def test_importance_noise_order():
    """``importance_noise`` draws, per subset the batch forms, the content
    then each styled modality's style, from the generator in that order;
    ``batch_likelihoods`` with the generator equals it with those draws."""
    _, _, tmodel = jax_pair("joint_elbo")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(3).items()}
    noise = likelihood.importance_noise(
        tmodel, batch, K, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    for s_key in ("clinical", "rois", "clinical_rois"):
        assert torch.equal(noise[s_key]["content"],
                           torch.randn((K, B, CD), generator=g))
        for m, d in (("clinical", STYLE[0]), ("rois", STYLE[1])):
            assert torch.equal(noise[s_key]["style"][m],
                               torch.randn((K, B, d), generator=g))
    assert list(noise) == ["clinical", "rois", "clinical_rois"]
    got = likelihood.batch_likelihoods(tmodel, batch,
                                       torch.Generator().manual_seed(5), K)
    want = likelihood.batch_likelihoods(tmodel, batch, num_imp_samples=K,
                                        noise=noise)
    assert_tree_close(got, want, 0, 0)


# ------------------------------------------------- scikit-learn stand-ins
@pytest.mark.parametrize("seed", range(6))
def test_kmeans_matches_sklearn(seed):
    from sklearn.cluster import KMeans

    rng = np.random.default_rng(seed)
    n, d, k = 40 + 37 * seed, 2 + 7 * seed, 2 + 3 * seed
    x = rng.normal(size=(n, d)) + 3.0 * rng.normal(size=(1, d))
    x[: n // 3] += 2.0
    want = KMeans(n_clusters=k, n_init=10, random_state=seed).fit(x)
    got = estimators.KMeans(n_clusters=k, n_init=10, random_state=seed).fit(x)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-10)
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_,
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(
        estimators.KMeans(k, 10, seed).fit_predict(x), want.labels_)


@pytest.mark.parametrize("n_classes", [2, 3])
@pytest.mark.parametrize("seed", range(3))
def test_logistic_regression_matches_sklearn(seed, n_classes):
    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(150, 6)) * np.array([1, 2, 0.5, 1, 3, 1])
    y = np.where(x[:, 0] + rng.normal(size=150) > 0.3,
                 rng.integers(0, n_classes, 150), 0) + 5
    got = estimators.LogisticRegression(max_iter=1000).fit(x, y)
    tight = LogisticRegression(max_iter=10000, tol=1e-12).fit(x, y)
    default = LogisticRegression(max_iter=1000).fit(x, y)
    np.testing.assert_array_equal(got.classes_, tight.classes_)
    np.testing.assert_allclose(got.coef_, tight.coef_, rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(got.intercept_, tight.intercept_, rtol=1e-6,
                               atol=1e-8)
    scale = np.abs(default.coef_).max()
    np.testing.assert_allclose(got.coef_, default.coef_, rtol=0,
                               atol=2e-3 * scale)
    x_test = rng.normal(size=(400, 6)) * 2.0
    dec = default.decision_function(x_test)
    margin = (np.abs(dec) if dec.ndim == 1
              else np.diff(np.sort(dec, axis=1)[:, -2:], axis=1)[:, 0])
    far = margin > 1e-3
    np.testing.assert_array_equal(got.predict(x_test)[far],
                                  default.predict(x_test)[far])
    np.testing.assert_array_equal(got.predict(x_test), tight.predict(x_test))
    assert got.score(x, y) == tight.score(x, y)


# ------------------------------------------------------------ PRD / FID
@pytest.mark.parametrize("balanced", [True, False],
                         ids=["balanced", "unbalanced"])
def test_prd_from_embedding_matches_jax(balanced):
    rng = np.random.default_rng(4)
    ref = rng.normal(size=(120, 7))
    gen = 0.8 * rng.normal(size=(120 if balanced else 97, 7)) + 0.3
    want = jax_prd.compute_prd_from_embedding(gen, ref, num_clusters=8,
                                              num_runs=3, seed=9)
    got = prd.compute_prd_from_embedding(gen, ref, num_clusters=8,
                                         num_runs=3, seed=9)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(prd.prd_to_max_f_beta_pair(*got),
                               jax_prd.prd_to_max_f_beta_pair(*want),
                               rtol=1e-9)


def test_frechet_and_fid_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(80, 6))
    b = 1.3 * rng.normal(size=(70, 6)) + 0.2
    np.testing.assert_allclose(
        sample_quality.calculate_fid_from_embeddings(a, b),
        jax_sq.calculate_fid_from_embeddings(a, b), rtol=1e-9)
    mu, cov = sample_quality.embedding_stats(a)
    np.testing.assert_allclose(
        sample_quality.calculate_frechet_distance(mu, cov, mu + 1.0, 2 * cov),
        jax_sq.calculate_frechet_distance(mu, cov, mu + 1.0, 2 * cov),
        rtol=1e-9)
    # a dump directory against a stacked array, as the JAX package reads it
    d = tmp_path / "dump"
    d.mkdir()
    for i, row in enumerate(a):
        np.save(d / f"{i:06d}.npy", row)
    np.save(tmp_path / "b.npy", b)
    np.testing.assert_allclose(
        sample_quality.calculate_fid_given_paths(str(d),
                                                 str(tmp_path / "b.npy")),
        jax_sq.calculate_fid_given_paths(str(d), str(tmp_path / "b.npy")),
        rtol=1e-9)


@pytest.mark.parametrize("form", ["identity", "npz", "module-attr"])
def test_load_embedding_matches_jax(tmp_path, form):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(30, 5))
    spec = {"identity": None, "npz": str(tmp_path / "w.npz"),
            "module-attr": "numpy:tanh"}[form]
    np.savez(tmp_path / "w.npz", W=rng.normal(size=(5, 3)),
             b=rng.normal(size=3))
    got, want = (sample_quality.load_embedding(spec),
                 jax_sq.load_embedding(spec))
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_allclose(got(x), want(x), rtol=1e-12)
    y = 1.1 * x + 0.5
    np.testing.assert_allclose(
        sample_quality.calculate_fid_from_embeddings(x, y, embedding=spec),
        jax_sq.calculate_fid_from_embeddings(x, y, embedding=spec),
        rtol=1e-9)
    with pytest.raises(ValueError, match="embedding spec"):
        sample_quality.load_embedding(3)


# ------------------------------------------------------------- cadence
CADENCES = [
    # eval_freq, eval_freq_fid, end_epoch, flags
    (2, 2, 4, ("calc_nll", "calc_prd", "calc_clf", "calc_coherence")),
    (2, 3, 6, ("calc_nll", "calc_prd")),
    (3, 2, 7, ("calc_prd",)),
    (4, 100, 9, ("calc_clf", "calc_coherence")),
    (5, 5, 5, ()),
    (1, 3, 5, ("calc_coherence", "calc_prd")),
]


@pytest.mark.parametrize("freq,freq_fid,end,flags", CADENCES,
                         ids=[f"cadence{i}" for i in range(len(CADENCES))])
def test_eval_cadence_matches_jax(monkeypatch, freq, freq_fid, end, flags):
    """The predicates and, per epoch, the families ``run_eval_cadence``
    fires (each eval replaced by a recorder), against the JAX package's."""
    from multivae_tpu.eval import coherence as j_coh
    from multivae_tpu.eval import likelihood as j_lh
    from multivae_tpu.eval import representation as j_rep
    from multivae_tpu.eval import sample_quality as j_sq
    from multivae_tpu_torch.eval import coherence as t_coh
    from multivae_tpu_torch.eval import likelihood as t_lh
    from multivae_tpu_torch.eval import representation as t_rep
    from multivae_tpu_torch.eval import sample_quality as t_sq

    cfg = types.SimpleNamespace(
        end_epoch=end, eval_freq=freq, eval_freq_fid=freq_fid,
        **{f: f in flags for f in ("calc_nll", "calc_prd", "calc_clf",
                                   "calc_coherence")})
    fired = {}

    def patch(lh, sq, rep, coh, side):
        rec = fired.setdefault(side, [])
        monkeypatch.setattr(lh, "estimate_likelihoods",
                            lambda e, m: rec.append((e.now, "nll")) or {})
        monkeypatch.setattr(sq, "generate_conditional_samples",
                            lambda e, m: rec.append((e.now, "gen")))
        monkeypatch.setattr(sq, "calc_prd_score",
                            lambda e, m, samples=None:
                            rec.append((e.now, "prd")) or {})
        monkeypatch.setattr(rep, "train_clf_lr_all_subsets",
                            lambda e, m: rec.append((e.now, "clf")) or {})
        monkeypatch.setattr(rep, "test_clf_lr_all_subsets",
                            lambda e, c, m: {})
        monkeypatch.setattr(coh, "train_modality_classifiers",
                            lambda e, m: rec.append((e.now, "fit")) or {})
        monkeypatch.setattr(coh, "evaluate_coherence",
                            lambda e, m, clfs=None, samples=None:
                            rec.append((e.now, "coh")) or {})

    patch(j_lh, j_sq, j_rep, j_coh, "jax")
    patch(t_lh, t_sq, t_rep, t_coh, "port")
    exps = {side: types.SimpleNamespace(cfg=cfg, now=0)
            for side in ("jax", "port")}
    for epoch_done in range(1, end + 1):
        assert (trainer.eval_breaks_after(cfg, epoch_done)
                == jax_trainer.eval_breaks_after(cfg, epoch_done))
        if (trainer.eval_breaks_after(cfg, epoch_done)
                or epoch_done == end):
            for side, fn in (("jax", jax_trainer.run_eval_cadence),
                             ("port", trainer.run_eval_cadence)):
                exps[side].now = epoch_done
                fn(exps[side], 0, None, epoch_done)
    assert (trainer.eval_cadence_active(cfg)
            == jax_trainer.eval_cadence_active(cfg) == bool(flags))
    assert fired["port"] == fired["jax"]
    # one generation pass per hit that needs one; classifiers fit once
    gens = [e for e, what in fired["port"] if what == "gen"]
    assert len(gens) == len(set(gens))
    assert [w for _, w in fired["port"]].count("fit") == (
        1 if "calc_coherence" in flags else 0)
