"""The port's flat Adam and the optimizer-state bridge against the JAX
package.

``adam_update_reference`` (the plain version of ``csrc/flat_adam.cu``) is
held to the JAX package's ``flat_adam`` (the general path's optimizer) and
to the Adam body of its Pallas epoch kernel, given the same gradient.
float32: the moments at rtol 1e-6; the params at rtol 1e-6 plus 2e-5 of
the update against ``flat_adam``, whose bias correction is written
``1 - b ** t`` (the kernels' ``1 - exp(t log b)`` differs by ~1e-5
relative at t = 1000), and at rtol 1e-6 against the Pallas body, which
writes it as the port does. The state converter maps the port's
split-layout buffers to the JAX package's raveled ``FlatAdamState``
vectors and back; it is tested with values that name their position.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from multivae_tpu.ops import fused_step as jax_fs
from multivae_tpu.train.train_step import FlatAdamState, flat_adam
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.ops import adam as adam_ops

pytestmark = pytest.mark.driver  # cross-framework parity pins

DIMS = bridge.FusedDims(b=12, d1=3, d2=12, h=16, cd=4, s1=2, s2=3)
MODS = ("clinical", "rois")
HYPER = adam_ops.AdamHyper(2e-3, 0.9, 0.999)


def state(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32),
            (0.01 * rng.normal(size=n)).astype(np.float32),
            (1e-4 * rng.random(size=n)).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


@pytest.mark.parametrize("count", [0, 1000])
def test_matches_jax_flat_adam(count):
    n = 257
    p, mu, nu, g = state(count, n)
    opt = flat_adam(HYPER.lr, b1=HYPER.b1, b2=HYPER.b2)
    upd, new = opt.update(jnp.asarray(g), FlatAdamState(
        jnp.asarray(count, jnp.int32), jnp.asarray(mu), jnp.asarray(nu)))
    tp, tmu, tnu = (torch.from_numpy(a.copy()) for a in (p, mu, nu))
    adam_ops.adam_update_reference(tp, tmu, tnu, torch.from_numpy(g),
                                   count + 1, HYPER)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(new.mu), rtol=1e-6)
    np.testing.assert_allclose(tnu.numpy(), np.asarray(new.nu), rtol=1e-6)
    # flat_adam raises the float32 b to the power t, the kernels take
    # exp(t log b) with log b rounded once from double; at t = 1000 the two
    # bias corrections differ by ~1e-5 relative, so the params are held to
    # rtol 1e-6 plus 2e-5 of the update
    upd = np.asarray(upd)
    want = p + upd
    np.testing.assert_array_less(np.abs(tp.numpy() - want),
                                 1e-6 * np.abs(want) + 2e-5 * np.abs(upd)
                                 + 1e-9)
    assert int(new.count) == count + 1


def test_matches_the_pallas_adam_body():
    """One step of the TPU epoch kernel (interpret mode) minus its step
    gradient is one port Adam update with that gradient."""
    rng = np.random.default_rng(5)
    shapes = bridge.split_shapes(DIMS)
    sp = {k: (0.3 * rng.normal(size=s)).astype(np.float32)
          for k, s in shapes.items()}
    mu = {k: (0.01 * rng.normal(size=s)).astype(np.float32)
          for k, s in shapes.items()}
    nu = {k: (1e-4 * rng.random(size=s)).astype(np.float32)
          for k, s in shapes.items()}
    b = DIMS.b
    xs = [rng.normal(size=(1, b, w)).astype(np.float32)
          for w in (DIMS.d1, DIMS.d2, DIMS.cd, DIMS.s1, DIMS.s2)]
    jd = jax_fs.FusedDims(*DIMS)
    consts = jax_fs.FusedConsts(1.0, 1.0, 1.0)
    jsp = {k: jnp.asarray(v) for k, v in sp.items()}
    jp, jmu, jnu, _ = jax_fs.fused_epoch(
        jsp, {k: jnp.asarray(v) for k, v in mu.items()},
        {k: jnp.asarray(v) for k, v in nu.items()}, 7,
        *map(jnp.asarray, xs), jd, consts, tuple(HYPER), learn_scale=True,
        interpret=True, matmul_bf16=False)
    _, grads, _ = jax_fs.fused_loss_and_grads(
        jax_fs.join_params(jsp, jd), *(jnp.asarray(x[0]) for x in xs), jd,
        consts, learn_scale=True, interpret=True)
    g = jax_fs.split_params(grads, jd)
    flat = lambda d: bridge.flatten_split(
        {k: torch.from_numpy(np.array(v)) for k, v in d.items()})
    tp, tmu, tnu = flat(sp), flat(mu), flat(nu)
    adam_ops.adam_update(tp, tmu, tnu, flat(g), 8, HYPER)
    for got, want in ((tp, jp), (tmu, jmu), (tnu, jnu)):
        np.testing.assert_allclose(got.numpy(), flat(want).numpy(),
                                   rtol=1e-6, atol=1e-9)


def test_state_round_trip_split_to_ravel():
    n = bridge.flat_size(DIMS)
    flat = torch.arange(n, dtype=torch.float32)
    vec = bridge.split_flat_to_ravel(flat, DIMS, MODS)
    # the JAX package's own ravel of the same tree
    views = {k: jnp.asarray(v.numpy())
             for k, v in bridge.flat_views(flat, DIMS).items()}
    packed = jax_fs.join_params(views, jax_fs.FusedDims(*DIMS))
    model = type("M", (), {"modalities": tuple(
        type("S", (), {"name": m})() for m in MODS)})()
    tree = jax_fs.unflatten_grads(packed, None, model)
    want, _ = ravel_pytree(tree)
    np.testing.assert_array_equal(vec, np.asarray(want))
    assert sorted(vec.tolist()) == list(range(n))
    back = bridge.ravel_to_split_flat(vec, DIMS, MODS)
    assert torch.equal(back, flat)


def test_state_round_trip_ravel_to_split():
    n = bridge.flat_size(DIMS)
    vec = np.arange(n, dtype=np.float32) * 2.0 + 1.0
    flat = bridge.ravel_to_split_flat(vec, DIMS, MODS)
    np.testing.assert_array_equal(
        bridge.split_flat_to_ravel(flat, DIMS, MODS), vec)
    with pytest.raises(ValueError, match="raveled vector"):
        bridge.ravel_to_split_flat(vec[:-1], DIMS, MODS)


def test_ravel_order_sorts_keys_like_jax():
    tree = {"enc_rois": {"hidden_0": {"kernel": 0, "bias": 1},
                         "heads": {"kernel": 2, "bias": 3}},
            "dec_clinical": {"out_mu": {"kernel": 4, "bias": 5},
                             "out_logvar": 6}}
    leaves = jax.tree_util.tree_flatten(tree)[0]
    flat = bridge.flatten_tree(tree)
    assert [flat[p] for p in bridge.ravel_order(tree)] == leaves


def test_init_and_dispatch():
    p = torch.ones(10)
    st = adam_ops.init_adam_state(p)
    assert st.count == 0 and not st.mu.any() and not st.nu.any()
    assert st.mu.data_ptr() != st.nu.data_ptr()
    launches = dict(adam_ops.KERNEL_LAUNCHES)
    adam_ops.adam_update(p, st.mu, st.nu, torch.ones(10), 1, HYPER)
    assert adam_ops.KERNEL_LAUNCHES == launches  # plain on the CPU
    np.testing.assert_allclose(p.numpy(), 1.0 - HYPER.lr, rtol=1e-5)
    meta = torch.empty(10, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        adam_ops.adam_update(meta, meta, meta, meta, 1, HYPER)
