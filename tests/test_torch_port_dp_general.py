"""The port's data-parallel general step against the JAX package's
full-batch function.

Under a data mesh the JAX package runs its XLA step on row-sharded
batches: GSPMD computes ``jax.value_and_grad`` of ``model.apply`` +
``total_loss`` over the WHOLE batch, its mixture partitions and means
included. The port's ``train_step.dp_general_step`` runs every shard on
its rows as a slice of the whole batch (``ops.fusion.Rows``) and sums the
shards. Here the same seeded weights, batch and noise go through the port
at 2 and 4 shards and through ``jax.value_and_grad`` of the full batch,
then one Adam update of the JAX gradients (the port's plain ``flat_adam``):
deep-A (a decoder hidden layer, a per-sample scale), bernoulli, the
unfactorized latent with moe and a four-block moe. A per-shard
``mixture_partition`` (each shard partitioning its own rows) is planted
and must fail. Tolerances as ``tests/test_torch_port_multimodal.py``: the
loss at rtol 1e-5, metrics at rtol 5e-4 / atol 1e-5, params and moments
after the update at rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.train.losses import total_loss as jax_total_loss
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.ops import adam as adam_ops
from multivae_tpu_torch.ops import fusion
from multivae_tpu_torch.parallel import data_mesh
from multivae_tpu_torch.train import train_step
from test_torch_port_multimodal import (
    LOSS_RTOL,
    as_jnp,
    both_models,
    cfg_kw,
    close,
    jax_noise,
    seeded_tree,
)

pytestmark = pytest.mark.driver  # cross-framework parity pins

B = 24
CONFIGS = {
    "deep-A": dict(cfg_kw("joint_elbo", 2, n_dec=1, scale="per-sample",
                          b=B)),
    "bernoulli": dict(cfg_kw("joint_elbo", 2, b=B), likelihood="bernoulli"),
    "unfactorized-moe": dict(cfg_kw("moe", 2, n_dec=1, b=B),
                             factorized_representation=False),
    "four-block-moe": dict(cfg_kw("moe", 4, b=B)),
}


def setup(name, seed=5):
    kw = CONFIGS[name]
    jcfg, jmodel, cfg, model = both_models(kw)
    tree = seeded_tree(model, seed)
    rng = np.random.default_rng(seed + 1)
    data = {m.name: rng.normal(size=(B, m.dim)).astype(np.float32)
            for m in model.modalities}
    if cfg.likelihood == "bernoulli":
        data = {k: (v > 0).astype(np.float32) for k, v in data.items()}
    width = train_step.batch_noise_width(cfg, model, data)
    noise = rng.normal(size=(B, width)).astype(np.float32)
    return jcfg, jmodel, cfg, model, tree, data, noise


def jax_full_batch(jcfg, jmodel, tree, data, noise):
    """``(loss, metrics, grads)`` of the whole batch by
    ``jax.value_and_grad``."""
    batch = {k: jnp.asarray(v) for k, v in data.items()}
    main, uni = jax_noise(jcfg, jmodel, batch, noise)

    def loss_fn(p):
        variables = {"params": p}
        out = jmodel.apply(variables, batch, train=True, noise=main)
        return jax_total_loss(jcfg, jmodel, variables, batch, out, None,
                              train=True, noise_uni=uni)

    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        as_jnp(tree))
    return loss, metrics, bridge.flatten_tree(jax.device_get(grads))


def port_dp_step(cfg, model, tree, data, noise, n_dev):
    dims = bridge.dims_from(cfg, B)
    model.load_state_dict(bridge.tree_to_state_dict(tree))
    p = bridge.model_flat_params(model, dims)
    opt = adam_ops.init_adam_state(p)
    mesh = data_mesh(n_dev, ["cpu"] * n_dev)
    opt, loss, metrics = train_step.dp_general_step(
        cfg, train_step.model_replicas(model), p, opt,
        {k: torch.from_numpy(v) for k, v in data.items()},
        torch.from_numpy(noise), dims, adam_ops.adam_hyper(cfg), mesh)
    return p, opt, loss, metrics, dims


def hold(name, n_dev):
    jcfg, jmodel, cfg, model, tree, data, noise = setup(name)
    jloss, jmetrics, jgrads = jax_full_batch(jcfg, jmodel, tree, data,
                                             noise)
    p, opt, loss, metrics, dims = port_dp_step(cfg, model, tree, data, noise,
                                               n_dev)
    close(loss, jloss, rtol=LOSS_RTOL, atol=0)
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        close(metrics[k], jmetrics[k], msg=k)
    # the JAX gradients through one update of the port's plain Adam
    names = [m.name for m in model.modalities]
    model.load_state_dict(bridge.tree_to_state_dict(tree))
    p0 = bridge.model_flat_params(model, dims)
    g = bridge._tree_flat({k: torch.from_numpy(np.array(v))
                           for k, v in jgrads.items()}, dims, names)
    mu, nu = torch.zeros_like(p0), torch.zeros_like(p0)
    adam_ops.adam_update_reference(p0, mu, nu, g, 1,
                                   adam_ops.adam_hyper(cfg))
    close(p, p0, rtol=1e-4, atol=1e-5)
    close(opt.mu, mu, rtol=1e-4, atol=1e-5)
    close(opt.nu, nu, rtol=1e-4, atol=1e-9)
    assert opt.count == 1


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_dp_general_step_is_the_full_batch_function(name, n_dev):
    hold(name, n_dev)


def test_per_shard_partition_fails(monkeypatch):
    """A shard that partitions its own rows (``mixture_partition(k,
    local_b)``) computes another function: the comparison must fail."""
    real = fusion.mixture_component_selection

    def per_shard(mus, logvars, weights=None, rows=None):
        return real(mus, logvars, weights)
    monkeypatch.setattr(fusion, "mixture_component_selection", per_shard)
    with pytest.raises(AssertionError):
        hold("four-block-moe", 4)


def test_mesh_for_rows():
    mesh = data_mesh(4, ["cpu"] * 4)
    assert train_step.mesh_for_rows(mesh, 24) is mesh
    assert train_step.mesh_for_rows(mesh, 22) is None
    assert train_step.mesh_for_rows(None, 24) is None


def test_dp_general_step_on_one_shard_is_the_general_step():
    """One shard is the unsharded step, bit for bit."""
    jcfg, jmodel, cfg, model, tree, data, noise = setup("deep-A")
    p, opt, loss, metrics, dims = port_dp_step(cfg, model, tree, data,
                                               noise, 1)
    model.load_state_dict(bridge.tree_to_state_dict(tree))
    p1 = bridge.model_flat_params(model, dims)
    opt1, loss1, metrics1 = train_step.general_step(
        cfg, model, p1, adam_ops.init_adam_state(p1),
        {k: torch.from_numpy(v) for k, v in data.items()},
        torch.from_numpy(noise), dims, adam_ops.adam_hyper(cfg))
    torch.testing.assert_close(p, p1, rtol=0, atol=0)
    torch.testing.assert_close(loss, loss1, rtol=0, atol=0)


@pytest.mark.parametrize("kw", [
    dict(num_hidden_layer_decoder=1), dict(likelihood="bernoulli"),
    dict(fused_training=False)],
    ids=["deep-A-like", "bernoulli", "fused_training=False"])
def test_train_exp_data_parallel_general_matches_one_shard(tmp_path, kw):
    """``train_exp(data_parallel=4)`` on the general routes against
    ``data_parallel=1`` from one seed on the same routes (every batch the
    general step: ``fused_training=False`` on both sides, the layer-stack
    step's batches through autograd on the one-shard side): the runs agree
    to the order of the sums (losses rtol 2e-5, the checkpoint's params
    atol 1e-4: Adam divides a near-zero gradient element by its own size,
    so a sum's order moves such an element by up to 5e-5 here, well below
    the learning rate, 2e-3). Not laplace: its gradients are sums of
    +-1/scale that cancel to 0 in one order and not in another, and
    Adam's first update turns that into a step of the learning rate."""
    import pandas as pd

    from multivae_tpu_torch import workflows
    from multivae_tpu_torch.data import make_synthetic_cohort

    datasetdir = str(tmp_path / "data")
    make_synthetic_cohort(datasetdir, n_subjects=90, n_scores=3, n_rois=12,
                          missing_rate=0.2, seed=0)
    losses, params = [], []
    for n in (4, 1):
        out = tmp_path / f"out{n}"
        run = workflows.train_exp(
            "synthetic", datasetdir, str(out), input_dims=[3, 12],
            latent_dim=4, style_dim=[2, 3], batch_size=16, num_epochs=2,
            use_tensorboard=False, device="cpu", data_parallel=n,
            **{**kw, "fused_training": False} if n == 1 else kw)
        csv = pd.read_csv(out / run / "logs" / "metrics.csv")
        losses.append(csv[(csv.phase == "train") & (csv.metric == "loss")]
                      .value.to_numpy())
        with np.load(out / run / "checkpoints" / "0001" / "model.npz") as f:
            params.append({k: f[k] for k in f.files})
    np.testing.assert_allclose(losses[0], losses[1], rtol=2e-5)
    for k in params[1]:
        np.testing.assert_allclose(params[0][k], params[1][k], rtol=0,
                                   atol=1e-4, err_msg=k)
