"""The port's GPipe pipeline (``multivae_tpu_torch.parallel.pipeline``)
against the JAX package's (``multivae_tpu/parallel/pipeline.py``).

Each case of ``tests/test_pipeline.py``, mirrored: the same stage weights
(numpy, seeded) and inputs go through the JAX schedule (``shard_map`` over
the 8 virtual CPU devices of ``tests/conftest.py``) and the port's (one
stage per mesh entry, all entries the CPU). Tolerances are the JAX tests':
forward rtol = atol = 1e-6, gradients rtol 1e-5 / atol 1e-6, a 5-step
training trajectory's losses rtol 1e-5 and params rtol 1e-4 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.parallel import pipeline as jpipe
from multivae_tpu_torch.parallel import pipeline as pipe

pytestmark = pytest.mark.driver  # cross-framework parity pins


def stages_np(seed, n_stages, d):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32),
             "b": (0.1 * rng.normal(size=d)).astype(np.float32)}
            for _ in range(n_stages)]


def as_torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def cpu_mesh(n):
    return pipe.pipe_mesh(n, ["cpu"] * n)


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("n_stages,n_micro", [
    (2, 1), (2, 4), (4, 2), (4, 8), (8, 4), (1, 3),
])
def test_matches_jax_and_sequential_forward(n_stages, n_micro):
    d, batch = 16, n_micro * 3
    stages = stages_np(n_stages * 10 + n_micro, n_stages, d)
    x = np.random.default_rng(1).normal(size=(batch, d)).astype(np.float32)
    got = pipe.pipeline_apply(pipe.mlp_stage,
                              pipe.stack_stages(as_torch(stages)),
                              torch.from_numpy(x), n_micro=n_micro,
                              mesh=cpu_mesh(n_stages))
    want = jpipe.pipeline_apply(jpipe.mlp_stage,
                                jpipe.stack_stages(as_jax(stages)),
                                jnp.asarray(x), n_micro=n_micro,
                                mesh=jpipe.pipe_mesh(n_stages))
    close(got, want, 1e-6, 1e-6)
    h = torch.from_numpy(x)
    for p in as_torch(stages):
        h = pipe.mlp_stage(p, h)
    close(got, h, 1e-6, 1e-6)


def test_batch_not_divisible_raises():
    stages = pipe.stack_stages(as_torch(stages_np(0, 2, 8)))
    with pytest.raises(ValueError, match="not divisible"):
        pipe.pipeline_apply(pipe.mlp_stage, stages, torch.ones(7, 8),
                            n_micro=2, mesh=cpu_mesh(2))


def test_too_few_devices_raises():
    with pytest.raises(ValueError, match="needs"):
        pipe.pipe_mesh(99)
    with pytest.raises(ValueError, match="needs"):
        pipe.pipe_mesh(3, ["cpu"] * 2)


def test_gradients_match_jax():
    """The reverse pipeline (autograd through the schedule) gives JAX's
    gradient of its pipeline."""
    n_stages, d, batch = 4, 12, 20
    stages = stages_np(3, n_stages, d)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(batch, d)).astype(np.float32)
    tgt = rng.normal(size=(batch, d)).astype(np.float32)

    def jax_loss(p):
        y = jpipe.pipeline_apply(jpipe.mlp_stage, p, jnp.asarray(x),
                                 n_micro=5, mesh=jpipe.pipe_mesh(n_stages))
        return jnp.mean((y - tgt) ** 2)

    want = jax.grad(jax_loss)(jpipe.stack_stages(as_jax(stages)))
    stacked = {k: v.requires_grad_()
               for k, v in pipe.stack_stages(as_torch(stages)).items()}
    y = pipe.pipeline_apply(pipe.mlp_stage, stacked, torch.from_numpy(x),
                            n_micro=5, mesh=cpu_mesh(n_stages))
    torch.mean((y - torch.from_numpy(tgt)) ** 2).backward()
    for k in ("w", "b"):
        close(stacked[k].grad, want[k], 1e-5, 1e-6)


def test_training_trajectory_matches_jax():
    """Pipelined SGD from the JAX package's ``init_pipelined_mlp`` params,
    carried over as numpy, equals the JAX pipelined SGD and the port's
    sequential SGD, step for step."""
    key = jax.random.PRNGKey(11)
    in_dim, hidden, out_dim, n_layers = 5, 16, 3, 4
    jparams = jpipe.init_pipelined_mlp(key, in_dim, hidden, out_dim,
                                       n_layers)
    x = np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                     (24, in_dim)))
    w_true = np.asarray(jax.random.normal(jax.random.fold_in(key, 2),
                                          (in_dim, out_dim)))
    y = x @ w_true
    params = pipe.init_pipelined_mlp(in_dim, hidden, out_dim, n_layers,
                                     tree=jax.device_get(jparams))
    seq = params
    step = pipe.make_pipelined_train_step(cpu_mesh(n_layers), n_micro=4,
                                          lr=1e-2)
    jstep = jpipe.make_pipelined_train_step(jpipe.pipe_mesh(n_layers),
                                            n_micro=4, lr=1e-2)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    losses, jlosses, seq_losses = [], [], []
    for _ in range(5):
        params, loss = step(params, tx, ty)
        jparams, jloss = jstep(jparams, jnp.asarray(x), jnp.asarray(y))
        leaves = jax.tree_util.tree_map(
            lambda t: t.detach().requires_grad_(), seq)
        seq_loss = pipe.sequential_mlp_loss(leaves, tx, ty)
        grads = torch.autograd.grad(seq_loss, [
            leaves["stack"]["w"], leaves["stack"]["b"],
            leaves["head"]["w"], leaves["head"]["b"]])
        seq = {"stack": {"w": (leaves["stack"]["w"] - 1e-2 * grads[0])
                         .detach(),
                         "b": (leaves["stack"]["b"] - 1e-2 * grads[1])
                         .detach()},
               "head": {"w": (leaves["head"]["w"] - 1e-2 * grads[2])
                        .detach(),
                        "b": (leaves["head"]["b"] - 1e-2 * grads[3])
                        .detach()}}
        losses.append(float(loss))
        jlosses.append(float(jloss))
        seq_losses.append(float(seq_loss.detach()))
    close(losses, jlosses, 1e-5, 0)
    close(losses, seq_losses, 1e-5, 0)
    assert losses[-1] < losses[0]
    for part in ("stack", "head"):
        for k in ("w", "b"):
            close(params[part][k], jparams[part][k], 1e-4, 1e-6)
            close(params[part][k], seq[part][k], 1e-4, 1e-6)


def test_carry_over_refuses_other_shapes():
    jparams = jax.device_get(jpipe.init_pipelined_mlp(
        jax.random.PRNGKey(0), 4, 12, 2, 3))
    with pytest.raises(ValueError, match="shapes"):
        pipe.init_pipelined_mlp(4, 12, 2, 4, tree=jparams)


def test_padded_first_layer_rows_stay_zero():
    """Input zero-padding is exact: the padded kernel rows get zero
    gradient (the port's own draw, the JAX law)."""
    in_dim, hidden = 4, 12
    params = pipe.init_pipelined_mlp(
        in_dim, hidden, 2, 2, generator=torch.Generator().manual_seed(5))
    assert not params["stack"]["w"][0][in_dim:].any()
    x = torch.randn(8, in_dim, generator=torch.Generator().manual_seed(1))
    step = pipe.make_pipelined_train_step(cpu_mesh(2), n_micro=2)
    params, _ = step(params, x, torch.ones(8, 2))
    assert not params["stack"]["w"][0][in_dim:].any()


def test_stochastic_stage_with_coords_matches_jax():
    """``with_coords``: each stage sees its (stage, micro) indices. JAX's
    dropout masks, drawn from those folds, fed to the port's stage by
    index: the port's pipeline equals JAX's and the sequential reference
    bit for bit."""
    n_stages, d, mb, n_micro = 4, 10, 6, 3
    stages = stages_np(9, n_stages, d)
    x = np.random.default_rng(2).normal(size=(mb * n_micro, d)).astype(
        np.float32)
    base, rate = jax.random.PRNGKey(123), 0.5

    def keep_mask(stage, micro):
        k = jax.random.fold_in(jax.random.fold_in(base, stage), micro)
        return jax.random.bernoulli(k, 1.0 - rate, (mb, d))

    def jax_stage(p, h, stage, micro):
        h = jpipe.mlp_stage(p, h)
        return jnp.where(keep_mask(stage, micro), h / (1.0 - rate), 0.0)

    want = jpipe.pipeline_apply(jax_stage, jpipe.stack_stages(as_jax(stages)),
                                jnp.asarray(x), n_micro=n_micro,
                                mesh=jpipe.pipe_mesh(n_stages),
                                with_coords=True)
    masks = {(s, m): torch.from_numpy(np.asarray(keep_mask(s, m)))
             for s in range(n_stages) for m in range(n_micro)}
    calls = []

    def stage(p, h, s, m):
        calls.append((s, m))
        h = pipe.mlp_stage(p, h)
        return torch.where(masks[(s, m)], h / (1.0 - rate),
                           torch.zeros_like(h))

    got = pipe.pipeline_apply(stage, pipe.stack_stages(as_torch(stages)),
                              torch.from_numpy(x), n_micro=n_micro,
                              mesh=cpu_mesh(n_stages), with_coords=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    chunks = []
    for m in range(n_micro):
        h = torch.from_numpy(x[m * mb:(m + 1) * mb])
        for s, p in enumerate(as_torch(stages)):
            h = stage(p, h, s, m)
        chunks.append(h)
    torch.testing.assert_close(got, torch.cat(chunks), rtol=0, atol=0)
    # the schedule: every (stage, micro) once, stage s at tick m + s
    sched = calls[:n_stages * n_micro]
    assert sorted(sched) == sorted(masks)
    ticks = [m + s for s, m in sched]
    assert ticks == sorted(ticks)
