"""The port's tensor-parallel step against the JAX package's.

``multivae_tpu_torch.parallel.tensor.tp_step`` (Megatron layers written
with plain torch ops over a ``("data", "tensor")`` mesh of CPU entries)
against ``make_tp_train_step`` (GSPMD over the 8 virtual CPU devices of
``tests/conftest.py``) and against the port's single-device
``general_step``, from the same seeded weights, Adam state, batch, noise
and dropout masks. The JAX step draws its noise inside ``model.apply``;
here a thin wrapper hands it the port's noise instead (``Injected``), and
its dropout masks are recovered from its own key by the probe of
``tests/test_torch_port_generic.py``. Tolerances are the JAX package's own
TP test's (``tests/test_train.py:260-278``): params at rtol 2e-5 / atol
2e-6, the loss at rtol 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from multivae_tpu.parallel import tp_mesh as jax_tp_mesh
from multivae_tpu.parallel import tp_param_spec as jax_tp_param_spec
from multivae_tpu.train.train_step import FlatAdamState, make_tp_train_step
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.ops import adam as adam_ops
from multivae_tpu_torch.parallel import tp_mesh, tp_param_spec
from multivae_tpu_torch.parallel import tensor
from multivae_tpu_torch.train import train_step
from test_torch_port_generic import (
    B,
    NAMES,
    both_models,
    cfg_kw,
    flat_of,
    port_masks,
    seeded_tree,
    split_uni,
    tree_of,
)

pytestmark = pytest.mark.driver  # cross-framework parity pins

P_RTOL, P_ATOL, LOSS_RTOL = 2e-5, 2e-6, 1e-5
COUNT = 3
# (name, method, cfg overrides): the split layout's joint_elbo; poe with
# its unimodal re-runs; deep-B (two encoder layers, so a [hidden, hidden]
# row-split layer after a column-split one, and a decoder hidden layer)
# with dropout
CASES = {
    "joint_elbo": ("joint_elbo", dict(num_hidden_layer_decoder=0)),
    "poe": ("poe", dict(num_hidden_layer_decoder=0)),
    "deep-B-dropout": ("jsd", dict(num_hidden_layer_encoder=2,
                                   dropout_rate=0.4)),
}
MESHES = {"4x2": (4, 2), "2x4": (2, 4)}   # (tensor, data)


class Injected:
    """The JAX model with the port's noise handed to every ``apply``: the
    main pass's, and for a one-modality batch (poe's unimodal re-runs) that
    modality's."""

    def __init__(self, model, main, uni):
        self._model, self._main, self._uni = model, main, uni

    def __getattr__(self, name):
        return getattr(self._model, name)

    def apply(self, variables, batch, **kw):
        if self._uni is not None and len(batch) == 1:
            (name,) = batch
            return self._model.apply(variables, batch, noise=self._uni[name],
                                     **kw)
        return self._model.apply(variables, batch, noise=self._main, **kw)


def moments(tree, seed):
    rng = np.random.default_rng(seed)
    flat = bridge.flatten_tree(tree)
    mu = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in flat.items()}
    nu = {k: (1e-4 * rng.random(size=v.shape)).astype(np.float32)
          for k, v in flat.items()}
    return bridge.unflatten_tree(mu), bridge.unflatten_tree(nu)


def batch_and_noise(jmodel, method, seed, b=B):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=(b, 5)).astype(np.float32)
    x2 = rng.normal(size=(b, 16)).astype(np.float32)
    width = jmodel.noise_width({"clinical": 0, "rois": 0})
    if method == "poe":
        width += sum(jmodel.noise_width({n: 0}) for n in NAMES)
    noise = rng.normal(size=(b, width)).astype(np.float32)
    return {"clinical": x1, "rois": x2}, noise


def setup(case, seed=3):
    method, over = CASES[case]
    kw = cfg_kw(method, "deep-A-like")
    kw.update(over)
    jcfg, jmodel, cfg, model = both_models(kw)
    tree = seeded_tree(model, seed)
    mu, nu = moments(tree, seed + 1)
    batch, noise = batch_and_noise(jmodel, method, seed + 2)
    return jcfg, jmodel, cfg, model, tree, mu, nu, batch, noise


def port_state(model, cfg, tree, mu, nu):
    dims = bridge.dims_from(cfg, B)
    p = flat_of(model, tree, dims)
    opt = adam_ops.AdamState(
        COUNT, bridge.ravel_to_split_flat(ravel_pytree(mu)[0], dims, NAMES),
        bridge.ravel_to_split_flat(ravel_pytree(nu)[0], dims, NAMES))
    return p, opt, dims


def jax_tp_steps(jcfg, jmodel, tree, mu, nu, batches, noises, n_tensor,
                 n_data, rng):
    """``make_tp_train_step`` over ``tp_mesh(n_tensor, n_data)``, one step
    per batch; returns the final params tree, state and the losses, and
    each step's dropout key."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = FlatAdamState(count=jnp.asarray(COUNT, jnp.int32),
                          mu=ravel_pytree(mu)[0], nu=ravel_pytree(nu)[0])
    mesh = jax_tp_mesh(n_tensor, n_data=n_data)
    losses, dkeys = [], []
    for batch, noise in zip(batches, noises):
        main, uni = split_uni(noise, jcfg.method)
        # a batch the data axis does not divide runs replicated
        # (trainer.py:849-858)
        step = make_tp_train_step(jcfg, Injected(jmodel, main, uni), mesh,
                                  donate=False,
                                  shard_batch=len(noise) % n_data == 0)
        rng, sub = jax.random.split(rng)
        dkeys.append(jax.random.split(sub, 3)[2])
        params, state, loss, _ = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()},
            sub)
        losses.append(float(loss))
    return bridge.flatten_tree(jax.device_get(params)), state, losses, dkeys


def port_masks_of(jcfg, jmodel, tree, batch, dkey):
    if not jcfg.dropout_rate:
        return None
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return torch.from_numpy(port_masks(jmodel, tree, jbatch, dkey,
                                       jcfg.method))


def close(got, want, rtol=P_RTOL, atol=P_ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_tp_step_matches_jax_and_the_single_device_step(case, mesh_id):
    n_tensor, n_data = MESHES[mesh_id]
    jcfg, jmodel, cfg, model, tree, mu, nu, batch, noise = setup(case)
    want, jstate, jloss, dkeys = jax_tp_steps(
        jcfg, jmodel, tree, mu, nu, [batch], [noise], n_tensor, n_data,
        jax.random.PRNGKey(0))
    masks = port_masks_of(jcfg, jmodel, tree, batch, dkeys[0])
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    hyper = adam_ops.adam_hyper(cfg)

    p, opt, dims = port_state(model, cfg, tree, mu, nu)
    mesh = tp_mesh(n_tensor, n_data, ["cpu"] * (n_tensor * n_data))
    opt, loss, metrics = tensor.tp_step(cfg, model, p, opt, tbatch,
                                        torch.from_numpy(noise), dims, hyper,
                                        mesh, masks)
    assert opt.count == COUNT + 1
    close(loss, jloss[0], rtol=LOSS_RTOL, atol=0)
    got = tree_of(p, dims)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], msg=k)
    close(bridge.split_flat_to_ravel(opt.mu, dims, NAMES), jstate.mu)
    close(bridge.split_flat_to_ravel(opt.nu, dims, NAMES), jstate.nu)

    p1, opt1, _ = port_state(model, cfg, tree, mu, nu)
    opt1, loss1, metrics1 = train_step.general_step(
        cfg, model, p1, opt1, tbatch, torch.from_numpy(noise), dims, hyper,
        masks)
    close(loss, loss1, rtol=LOSS_RTOL, atol=0)
    assert sorted(metrics) == sorted(metrics1)
    for k in metrics:
        close(metrics[k], metrics1[k], rtol=5e-4, atol=1e-5, msg=k)
    close(p, p1)


@pytest.mark.parametrize("case", ["joint_elbo", "deep-B-dropout"])
def test_tp_steps_in_turn_match_jax(case):
    """Three steps (a remainder batch of 30 rows, which the data axis of 4
    does not divide, runs whole on the first data row) equal the JAX
    steps applied one at a time."""
    jcfg, jmodel, cfg, model, tree, mu, nu, _, _ = setup(case, seed=7)
    batches, noises = [], []
    for k, b in enumerate((B, 30, B)):
        batch, noise = batch_and_noise(jmodel, jcfg.method, 20 + k, b)
        batches.append(batch)
        noises.append(noise)
    want, jstate, jlosses, dkeys = jax_tp_steps(
        jcfg, jmodel, tree, mu, nu, batches, noises, 2, 4,
        jax.random.PRNGKey(1))
    p, opt, dims = port_state(model, cfg, tree, mu, nu)
    mesh = tp_mesh(2, 4, ["cpu"] * 8)
    hyper = adam_ops.adam_hyper(cfg)
    params_before = tree
    losses = []
    for batch, noise, dkey in zip(batches, noises, dkeys):
        masks = port_masks_of(jcfg, jmodel, params_before, batch, dkey)
        opt, loss, _ = tensor.tp_step(
            cfg, model, p, opt, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
            torch.from_numpy(noise), bridge.dims_from(cfg, len(noise)),
            hyper, mesh, masks)
        losses.append(float(loss))
        params_before = bridge.unflatten_tree(tree_of(p, dims))
    close(losses, jlosses, rtol=LOSS_RTOL, atol=0)
    got = tree_of(p, dims)
    for k in want:
        close(got[k], want[k], rtol=1e-4, atol=1e-5, msg=k)
    assert opt.count == COUNT + 3


TREES = {"flagship": ("joint_elbo", dict(num_hidden_layer_decoder=0)),
         "deep-A": ("joint_elbo", dict(learn_output_sample_scale=True)),
         "four-block": ("moe", dict(input_dim=[5, 16, 16, 16],
                                    style_dim=[2, 3, 3, 3],
                                    num_hidden_layer_decoder=0))}


@pytest.mark.parametrize("tree_id", list(TREES))
def test_tp_param_spec_is_the_jax_rule(tree_id):
    """Every leaf of the flagship, deep-A and four-block trees (and, with
    hidden 16, the out_logvar of a 16-wide block: a column-split
    [1, hidden] leaf) gets JAX's spec."""
    method, over = TREES[tree_id]
    kw = cfg_kw(method, "deep-A-like")
    kw.update(over)
    _, _, cfg, model = both_models(kw)
    tree = bridge.flatten_tree(bridge.state_dict_to_tree(model.state_dict()))
    n_sharded = 0
    for path, leaf in tree.items():
        want = tuple(jax_tp_param_spec(leaf.shape, cfg.hidden_dim))
        assert tp_param_spec(leaf.shape, cfg.hidden_dim) == want, path
        n_sharded += "tensor" in want
    assert n_sharded >= 6


def test_tp_pieces_round_trip():
    """Cutting a flat buffer over 4 entries and joining the pieces gives
    it back bit for bit, in both layouts."""
    for case in ("joint_elbo", "deep-B-dropout"):
        _, _, cfg, model, tree, _, _, _, _ = setup(case)
        dims = bridge.dims_from(cfg, B)
        p = flat_of(model, tree, dims)
        pieces, specs = bridge.tp_pieces(
            p, dims, NAMES, lambda s: tp_param_spec(s, cfg.hidden_dim),
            ["cpu"] * 4)
        assert any(len(v) == 4 for v in pieces.values())
        torch.testing.assert_close(
            bridge.tp_gather_flat(pieces, specs, dims, NAMES), p, rtol=0,
            atol=0)


def test_hidden_width_must_divide():
    jcfg, jmodel, cfg, model, tree, mu, nu, batch, noise = setup(
        "joint_elbo")
    p, opt, dims = port_state(model, cfg, tree, mu, nu)
    with pytest.raises(ValueError, match="must divide"):
        tensor.tp_step(cfg, model, p, opt,
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       torch.from_numpy(noise), dims,
                       adam_ops.adam_hyper(cfg),
                       tp_mesh(3, 1, ["cpu"] * 3))


def test_train_exp_tensor_and_data_parallel(tmp_path):
    """``train_exp(tensor_parallel=4, data_parallel=2)`` on the CPU (the
    JAX package's ``test_tp_train_exp_end_to_end``): the loss falls, the
    final checkpoint is written, and no step kernel is called."""
    import pandas as pd

    from multivae_tpu_torch import workflows
    from multivae_tpu_torch.data import make_synthetic_cohort
    from multivae_tpu_torch.ops import (fused_generic, fused_methods,
                                        fused_presence, fused_sharded,
                                        fused_step)

    calls = []
    saved = {}
    for module, name in ((fused_step, "epoch_flat"),
                         (fused_methods, "method_epoch_flat"),
                         (fused_presence, "presence_epoch_flat"),
                         (fused_generic, "generic_epoch_flat"),
                         (fused_sharded, "dp_step_flat")):
        saved[(module, name)] = getattr(module, name)
        setattr(module, name, lambda *a, name=name, **k: calls.append(name))
    try:
        datasetdir = str(tmp_path / "data")
        make_synthetic_cohort(datasetdir, n_subjects=64, n_scores=4,
                              n_rois=16, missing_rate=0.2, seed=5)
        outdir = tmp_path / "out"
        run = workflows.train_exp(
            "synthetic", datasetdir, str(outdir), input_dims=[4, 16],
            latent_dim=4, style_dim=[2, 3], num_epochs=4, batch_size=16,
            learning_rate=0.01, use_tensorboard=False, tensor_parallel=4,
            data_parallel=2, device="cpu")
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)
    assert calls == []
    d = pd.read_csv(outdir / run / "logs" / "metrics.csv")
    loss = d[(d.phase == "train") & (d.metric == "loss")]["value"]
    assert loss.iloc[-1] < loss.iloc[0]
    assert (outdir / run / "checkpoints" / "0003" / "model.npz").exists()
    flags = json.loads((outdir / run / "flags.json").read_text())
    assert (flags["tensor_parallel"], flags["data_parallel"]) == (4, 2)
