"""The layer-stack step's other likelihoods and the unfactorized latent
against the JAX package.

The JAX package trains a model with ``likelihood`` laplace, bernoulli or
categorical, or with ``factorized_representation=False``, on its generic
Pallas kernel (``make_generic_fused_epoch``), whatever its depth. The port
takes such a model to its layer-stack step. Here the same weights (numpy,
seeded), batches and noise go through both:

* the laplace tie: where ``x == loc`` exactly, ``jax.grad(jnp.abs)`` takes
  the derivative +1; the port's autograd general step and its plain version
  must give JAX's gradient there (a linear decoder with a zero column puts
  ``loc`` on the data);
* one step: ``generic_step_flat`` (the plain version on the CPU) against
  ``jax.value_and_grad`` of ``model.apply`` + ``total_loss``, for the three
  likelihoods x four methods x {a linear decoder, deep-A-like} and the
  unfactorized latent x four methods, the metric names against the keys
  ``total_loss`` emits;
* a 3-step epoch against ``make_generic_fused_epoch(interpret=True)`` for
  laplace and the unfactorized latent (bernoulli and categorical under
  ``slow``, as ``tests/test_fused_generic.py`` marks them);
* the general autograd step and ``train_exp(device="cpu")``.

Sizes: input dims 5 and 16, hidden 16, latent 4, styles 2 and 3 or none,
B=32. Tolerances as ``tests/test_torch_port_generic.py``: the loss at rtol
1e-5, metrics and grads at rtol 5e-4 / atol 1e-5; after a 3-step epoch
params, mu and nu at rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from multivae_tpu.ops import fused_generic as jax_fg
from multivae_tpu.train.losses import total_loss as jax_total_loss
from multivae_tpu.train.train_step import FlatAdamState
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.ops import adam as adam_ops
from multivae_tpu_torch.ops import fused_generic, fused_step
from multivae_tpu_torch.ops.likelihoods import tie_sign
from multivae_tpu_torch.train import train_step
from test_torch_port_generic import (
    ATOL,
    LOSS_RTOL,
    METHODS,
    NAMES,
    both_models,
    close,
    flat_of,
    moments_np,
    seeded_tree,
    tree_of,
)

pytestmark = pytest.mark.driver  # cross-framework parity pins

DIMS, HIDDEN, CD, STYLE, B = (5, 16), 16, 4, (2, 3), 32
LIKELIHOODS = ("laplace", "bernoulli", "categorical")
# (encoder hidden layers, decoder hidden layers, per-sample output scale)
ARCHS = {"linear": (1, 0, False), "deep-A-like": (1, 1, True)}


def cfg_kw(method, likelihood="normal", arch="linear", factorized=True,
           learn_scale=True):
    n_enc, n_dec, sample = ARCHS[arch]
    return dict(method=method, input_dim=list(DIMS), class_dim=CD,
                style_dim=list(STYLE), hidden_dim=HIDDEN, batch_size=B,
                num_hidden_layer_encoder=n_enc,
                num_hidden_layer_decoder=n_dec, likelihood=likelihood,
                factorized_representation=factorized,
                learn_output_scale=learn_scale,
                learn_output_sample_scale=sample, beta=1.3, beta_style=0.7,
                beta_content=1.2, initial_learning_rate=2e-3)


def styles(kw):
    return STYLE if kw["factorized_representation"] else (0, 0)


def noise_width(kw):
    s = styles(kw)
    w = CD + sum(s)
    return w + (2 * CD + sum(s) if kw["method"] == "poe" else 0)


def split_uni(noise, kw):
    s = styles(kw)
    w = CD + sum(s)
    if kw["method"] != "poe":
        return jnp.asarray(noise), None
    w1 = CD + s[0]
    return jnp.asarray(noise[:, :w]), {
        "clinical": jnp.asarray(noise[:, w:w + w1]),
        "rois": jnp.asarray(noise[:, w + w1:])}


def data_np(likelihood, rng, lead=()):
    """Inputs a model of this likelihood takes: the normal cohort, for
    bernoulli the cohort thresholded at 0, for categorical one-hot rows."""
    out = []
    for d in DIMS:
        x = rng.normal(size=lead + (B, d)).astype(np.float32)
        if likelihood == "bernoulli":
            x = (x > 0).astype(np.float32)
        elif likelihood == "categorical":
            x = np.eye(d, dtype=np.float32)[rng.integers(0, d, lead + (B,))]
        out.append(x)
    return out


def batch_np(kw, seed, steps=None):
    rng = np.random.default_rng(seed)
    lead = () if steps is None else (steps,)
    x1, x2 = data_np(kw["likelihood"], rng, lead)
    noise = rng.normal(size=lead + (B, noise_width(kw))).astype(np.float32)
    return x1, x2, noise


def jax_step(jcfg, jmodel, tree, x1, x2, noise, kw):
    batch = {"clinical": jnp.asarray(x1), "rois": jnp.asarray(x2)}
    main, uni = split_uni(noise, kw)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, batch, train=True, noise=main)
        return jax_total_loss(jcfg, jmodel, {"params": p}, batch, out, None,
                              train=True, noise_uni=uni)

    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    return loss, metrics, bridge.flatten_tree(jax.device_get(grads))


def hold_step(kw, seed):
    jcfg, jmodel, cfg, model = both_models(kw)
    tree = seeded_tree(model, seed)
    x1, x2, noise = batch_np(kw, seed + 1)
    loss, metrics, want = jax_step(jcfg, jmodel, tree, x1, x2, noise, kw)
    dims = bridge.dims_from(cfg, B)
    assert isinstance(dims, bridge.GenericDims)
    assert (dims.likelihood, dims.s1, dims.s2) == (kw["likelihood"],
                                                   *styles(kw))
    batch = {n: None for n in NAMES}
    assert fused_generic.supports_generic_fused(cfg, model, batch)
    assert jax_fg.supports_generic_fused(jcfg, jmodel, batch)
    method = kw["method"]
    launches = dict(fused_generic.KERNEL_LAUNCHES)
    tmet, tg = fused_generic.generic_step_flat(
        method, flat_of(model, tree, dims), torch.from_numpy(x1),
        torch.from_numpy(x2), torch.from_numpy(noise), dims,
        fused_step.consts_from(cfg), cfg.learn_output_scale)
    assert fused_generic.KERNEL_LAUNCHES == launches  # plain on the CPU
    # the epoch's rows are exactly the keys total_loss emits
    names = fused_generic.generic_metric_names(model, method)
    assert list(names) == ["loss"] + sorted(k for k in metrics if k != "loss")
    order = fused_generic.metric_permutation(model, method)
    close(tmet[0], loss, rtol=LOSS_RTOL, atol=0)
    for n, v in zip(names, tmet[order]):
        close(v, metrics[n], msg=n)
    got = tree_of(tg, dims)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], msg=k)
    return got


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("likelihood", LIKELIHOODS)
def test_reference_matches_jax_autodiff(likelihood, method, arch):
    got = hold_step(cfg_kw(method, likelihood, arch), 3)
    if likelihood != "laplace":
        # no scale: the output log-variance takes an exact zero gradient
        out = "out_heads" if ARCHS[arch][2] else None
        for name in NAMES:
            if out is None:
                assert not got[f"dec_{name}/out_logvar"].any()
            else:
                d = DIMS[NAMES.index(name)]
                assert not got[f"dec_{name}/{out}/kernel"][:, d:].any()
                assert not got[f"dec_{name}/{out}/bias"][d:].any()


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("method", METHODS)
def test_unfactorized_reference_matches_jax_autodiff(method, arch):
    """No style heads, noise or KL; the decoders read the content latent."""
    got = hold_step(cfg_kw(method, arch=arch, factorized=False), 4)
    assert got["enc_clinical/heads/kernel"].shape == (HIDDEN, 2 * CD)


@pytest.mark.parametrize("method", ["joint_elbo", "poe"])
def test_frozen_scale_laplace(method):
    got = hold_step(cfg_kw(method, "laplace", learn_scale=False), 5)
    assert not got["dec_rois/out_logvar"].any()


# ------------------------------------------------------------ laplace ties
def tie_setup(method):
    """A laplace model with a linear decoder whose rois output column 0 is
    0 (zero weights, zero bias) and data whose rois column 0 is 0: there
    ``x - loc`` is exactly 0 in every row."""
    kw = cfg_kw(method, "laplace")
    jcfg, jmodel, cfg, model = both_models(kw)
    tree = seeded_tree(model, 6)
    tree["dec_rois"]["out_mu"]["kernel"][:, 0] = 0.0
    tree["dec_rois"]["out_mu"]["bias"][0] = 0.0
    x1, x2, noise = batch_np(kw, 7)
    x2[:, 0] = 0.0
    return kw, jcfg, jmodel, cfg, model, tree, x1, x2, noise


@pytest.mark.parametrize("method", METHODS)
def test_laplace_tie_takes_the_jax_gradient(method):
    """The port's general step (torch autograd of the model and
    ``total_loss``) and the plain version give ``jax.value_and_grad``'s
    gradient where ``x == loc`` exactly: ``d|r|/dr = +1`` at ``r = 0``
    (``torch.abs`` would give 0 there)."""
    kw, jcfg, jmodel, cfg, model, tree, x1, x2, noise = tie_setup(method)
    _, _, want = jax_step(jcfg, jmodel, tree, x1, x2, noise, kw)
    dims = bridge.dims_from(cfg, B)
    # autograd of the port's model: the gradient the general step applies
    bridge.load_flat_params(model, flat_of(model, tree, dims), dims)
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, _ = train_step.loss_and_metrics(
            cfg, model, {"clinical": torch.from_numpy(x1),
                         "rois": torch.from_numpy(x2)},
            torch.from_numpy(noise))
        loss.backward()
    auto = tree_of(bridge.grads_to_flat(model, dims), dims)
    _, plain = fused_generic.generic_step_flat(
        method, flat_of(model, tree, dims), torch.from_numpy(x1),
        torch.from_numpy(x2), torch.from_numpy(noise), dims,
        fused_step.consts_from(cfg))
    plain = tree_of(plain, dims)
    # every row ties in column 0: its bias gradient is -1 / scale per
    # decode (poe's unimodal decode adds a second)
    scale = np.exp(0.5 * tree["dec_rois"]["out_logvar"][0, 0])
    decodes = 2 if method == "poe" else 1
    close(want["dec_rois/out_mu/bias"][0], -decodes / scale, rtol=1e-5)
    for got in (auto, plain):
        for k in want:
            close(got[k], want[k], msg=k)


def test_tie_sign():
    r = torch.tensor([-2.0, -0.0, 0.0, 3.0])
    assert tie_sign(r).tolist() == [-1.0, 1.0, 1.0, 1.0]
    r.requires_grad_(True)
    from multivae_tpu_torch.ops.likelihoods import abs_jax_grad
    abs_jax_grad(r).sum().backward()
    assert r.grad.tolist() == [-1.0, 1.0, 1.0, 1.0]
    want = jax.vmap(jax.grad(jnp.abs))(jnp.asarray([-2.0, -0.0, 0.0, 3.0]))
    assert np.asarray(want).tolist() == r.grad.tolist()


# --------------------------------------------------------------- the epoch
def hold_epoch(kw, seed, steps=3, count=4):
    jcfg, jmodel, cfg, model = both_models(kw)
    tree = seeded_tree(model, seed)
    mu, nu = moments_np(tree, seed + 1)
    x1s, x2s, _ = batch_np(kw, seed + 2, steps=steps)
    rngs = jax.random.split(jax.random.PRNGKey(seed), steps)
    # the kernel's own draws: normal(key, (B, total_w)) per step key
    noise = np.stack([np.asarray(jax.random.normal(
        k, (B, noise_width(kw)), jnp.float32)) for k in rngs])
    as_jnp = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    state = FlatAdamState(count=jnp.asarray(count, jnp.int32),
                          mu=ravel_pytree(as_jnp(mu))[0],
                          nu=ravel_pytree(as_jnp(nu))[0])
    epoch = jax_fg.make_generic_fused_epoch(jcfg, jmodel, interpret=True)
    jp, jstate, jlosses, jmetrics = epoch(
        as_jnp(tree), state,
        {"clinical": jnp.asarray(x1s), "rois": jnp.asarray(x2s)}, rngs)
    dims = bridge.dims_from(cfg, B)
    p, m, v = (flat_of(model, t, dims) for t in (tree, mu, nu))
    method = kw["method"]
    names = fused_generic.generic_metric_names(model, method)
    got = fused_generic.generic_epoch_flat(
        method, p, m, v, count, torch.from_numpy(x1s), torch.from_numpy(x2s),
        torch.from_numpy(noise), dims, fused_step.consts_from(cfg),
        adam_ops.adam_hyper(cfg), cfg.learn_output_scale, None,
        fused_generic.metric_permutation(model, method))
    assert list(names) == ["loss"] + sorted(k for k in jmetrics
                                            if k != "loss")
    close(got[:, 0], jlosses, rtol=LOSS_RTOL, atol=0)
    for j, n in enumerate(names):
        close(got[:, j], jmetrics[n], msg=n)
    want_p = bridge.flatten_tree(jax.device_get(jp))
    for k, leaf in tree_of(p, dims).items():
        close(leaf, want_p[k], rtol=1e-4, atol=1e-5, msg=k)
    for buf, want in ((m, jstate.mu), (v, jstate.nu)):
        close(bridge.split_flat_to_ravel(buf, dims, NAMES), want, rtol=1e-4,
              atol=1e-5)


@pytest.mark.parametrize("case", [
    dict(likelihood="laplace"),
    dict(likelihood="laplace", arch="deep-A-like"),
    dict(factorized=False),
    dict(factorized=False, arch="deep-A-like"),
    pytest.param(dict(likelihood="bernoulli"), marks=pytest.mark.slow),
    pytest.param(dict(likelihood="categorical", arch="deep-A-like"),
                 marks=pytest.mark.slow),
], ids=["laplace", "laplace-deep-A", "unfactorized", "unfactorized-deep-A",
        "bernoulli", "categorical-deep-A"])
def test_epoch_matches_jax_pallas_epoch(case):
    hold_epoch(cfg_kw("joint_elbo", **case), 11)


# ------------------------------------------------ layout and general step
@pytest.mark.parametrize("arch", list(ARCHS))
def test_layout_round_trip_without_style_heads(arch):
    _, jmodel, cfg, model = both_models(cfg_kw("poe", arch=arch,
                                               factorized=False))
    tree = seeded_tree(model, 20)
    dims = bridge.dims_from(cfg, B)
    assert (dims.s1, dims.s2) == (0, 0)
    flat = flat_of(model, tree, dims)
    assert flat.numel() == bridge.flat_size(dims) == sum(
        p.numel() for p in model.parameters())
    # the JAX model's own tree has the same leaves and shapes
    jtree = jmodel.init({"params": jax.random.PRNGKey(0),
                         "sample": jax.random.PRNGKey(1)},
                        {n: jnp.zeros((2, d)) for n, d in zip(NAMES, DIMS)})
    jflat = bridge.flatten_tree(jax.device_get(jtree["params"]))
    assert {k: v.shape for k, v in jflat.items()} == {
        k: v.shape for k, v in tree_of(flat, dims).items()}
    other = both_models(cfg_kw("poe", arch=arch, factorized=False))[3]
    bridge.load_flat_params(other, flat, dims)
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    vec = bridge.split_flat_to_ravel(flat, dims, NAMES)
    np.testing.assert_array_equal(vec, np.asarray(ravel_pytree(
        jax.tree_util.tree_map(jnp.asarray, tree))[0]))
    assert torch.equal(bridge.ravel_to_split_flat(vec, dims, NAMES), flat)


GENERAL_CASES = [dict(likelihood="laplace"),
                 dict(likelihood="laplace", arch="deep-A-like"),
                 dict(likelihood="bernoulli"),
                 dict(likelihood="categorical", arch="deep-A-like"),
                 dict(factorized=False),
                 dict(factorized=False, arch="deep-A-like")]
GENERAL_IDS = ["laplace", "laplace-deep-A", "bernoulli",
               "categorical-deep-A", "unfactorized", "unfactorized-deep-A"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", GENERAL_CASES, ids=GENERAL_IDS)
def test_general_step_matches_jax_general_step(case, method):
    """The port's general autograd step against the JAX package's general
    step (``_member_step``: ``jax.value_and_grad`` of ``model.apply`` +
    ``total_loss``, then its flat Adam), the noise injected into both: loss,
    metrics and the first moment after the update. The laplace cases' data
    tie with ``loc`` in one column (the tie rule)."""
    from multivae_tpu.train.train_step import make_optimizer

    kw = cfg_kw(method, **case)
    jcfg, jmodel, cfg, model = both_models(kw)
    tree = seeded_tree(model, 40)
    x1, x2, noise = batch_np(kw, 41)
    if kw["likelihood"] == "laplace" and case.get("arch") is None:
        tree["dec_rois"]["out_mu"]["kernel"][:, 0] = 0.0
        tree["dec_rois"]["out_mu"]["bias"][0] = 0.0
        x2[:, 0] = 0.0
    batch = {"clinical": jnp.asarray(x1), "rois": jnp.asarray(x2)}
    main, uni = split_uni(noise, kw)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, batch, train=True, noise=main)
        return jax_total_loss(jcfg, jmodel, {"params": p}, batch, out, None,
                              train=True, noise_uni=uni)

    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    (jloss, jmetrics), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jparams)
    opt = make_optimizer(jcfg)
    _, jstate = opt.update(jgrads, opt.init(jparams), jparams)
    dims = bridge.dims_from(cfg, B)
    p = flat_of(model, tree, dims)
    state, loss, metrics = train_step.general_step(
        cfg, model, p, adam_ops.init_adam_state(p),
        {"clinical": torch.from_numpy(x1), "rois": torch.from_numpy(x2)},
        torch.from_numpy(noise), dims, adam_ops.adam_hyper(cfg))
    assert train_step.batch_noise_width(cfg, model, NAMES) == noise_width(kw)
    close(loss, jloss, rtol=LOSS_RTOL, atol=0)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        close(metrics[k], jmetrics[k], msg=k)
    # the first moment after one update is (1 - b1) g: the gradients at the
    # step bound (the params after one update are not compared: Adam's
    # first step moves an element by ~lr whatever its gradient's size)
    b1 = 1.0 - cfg.beta_1
    close(bridge.split_flat_to_ravel(state.mu, dims, NAMES), jstate.mu,
          atol=ATOL * b1)
    assert state.count == 1 and int(jstate.count) == 1


@pytest.mark.parametrize("case", [dict(likelihood="laplace"),
                                  dict(factorized=False)],
                         ids=["laplace", "unfactorized"])
def test_train_exp_on_the_cpu(tmp_path, case):
    """``train_exp(device="cpu")``: the full complete batches take the
    layer-stack step's plain version, the other batches the general step;
    the losses fall and the logged families are the JAX keys."""
    import pandas as pd

    from multivae_tpu_torch.data import make_synthetic_cohort
    from multivae_tpu_torch.workflows import train_exp

    make_synthetic_cohort(str(tmp_path / "data"), n_subjects=300,
                          n_scores=5, n_rois=16, seed=0)
    run = train_exp("synthetic", str(tmp_path / "data"), str(tmp_path / "out"),
                    [5, 16], latent_dim=CD, style_dim=STYLE, batch_size=64,
                    num_epochs=4, use_tensorboard=False, device="cpu",
                    likelihood=case.get("likelihood", "normal"),
                    factorized_representation=case.get("factorized", True))
    csv = pd.read_csv(tmp_path / "out" / run / "logs" / "metrics.csv")
    tr = csv[csv.phase == "train"]
    loss = tr[tr.metric == "loss"].sort_values("step").value.to_numpy()
    assert np.isfinite(csv.value).all()
    assert loss[-4:].mean() < loss[:4].mean()
    if case.get("factorized", True) is False:
        assert not tr.metric.str.contains("_style").any()
