"""The port's row-slice steps, data-parallel epoch and ensemble epoch against
the JAX package (``multivae_tpu/ops/fused_sharded.py``).

Size of ``tests/test_fused_sharded.py``: B=48, hidden 32, widths 7/36, latent
6, styles 3/5, ``beta_style != 1``. Inputs come from numpy seeds; noise and
masks are injected into both sides (the data-parallel epoch of the JAX
package draws its own from its keys: the test draws the same arrays from the
same keys and feeds them to the port). With 4 shards the local rows are 12
and the partition bounds 16, 32 (3-way) and 24 (2-way) fall inside shards 1
and 2 and on their border; shard 0 holds rows of one subset only.

Tolerances: a plain row-slice step against ``_fwd_bwd`` /
``jax.value_and_grad(method_loss_split)`` and against the Pallas bodies in
interpret mode, same ``row_offset`` and ``b_total``: loss rtol 1e-5, metrics
and grads rtol 1e-5 / atol 1e-6 (float32, weights of the size of an
initialized model's: 0.1). The sum over shards against the unsharded plain
step: the same bounds (another order of the row sums). A 3-step data-parallel
epoch against ``make_fused_dp_scan_train_step(interpret=True)``: losses rtol
2e-5, params and moments rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from multivae_tpu.models import build_model as jax_build_model
from multivae_tpu.models import make_modalities as jax_make_modalities
from multivae_tpu.ops import fused_methods as jax_fm
from multivae_tpu.ops import fused_sharded as jax_fsh
from multivae_tpu.ops import fused_step as jax_fs
from multivae_tpu.parallel import data_mesh as jax_data_mesh
from multivae_tpu.train import Config
from multivae_tpu.train.train_step import FlatAdamState
from multivae_tpu.train.train_step import init_train_state as jax_init_state
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.ops import adam as adam_ops
from multivae_tpu_torch.ops import fused_methods, fused_sharded, fused_step
from multivae_tpu_torch.parallel import Mesh, data_mesh, make_mesh, spread

pytestmark = pytest.mark.driver  # cross-framework parity pins

B, N_STEPS = 48, 3
DIMS, HIDDEN, CD, STYLE = (7, 36), 32, 6, (3, 5)
CONSTS = (1.3, 0.7, 1.9)  # beta, beta_style, beta_content
RATE = 0.3
RTOL, ATOL = 1e-5, 1e-6
SUM_RTOL, SUM_ATOL = RTOL, ATOL
LOSS_RTOL = 1e-5
METHODS = ("joint_elbo", "moe", "jsd", "poe")
CASES = [(m, masked) for masked in (False, True) for m in METHODS]
CASE_IDS = [f"{m}{'-masks' if k else ''}" for m, k in CASES]
CPU = torch.device("cpu")


def dims(b=B):
    return bridge.FusedDims(b=b, d1=DIMS[0], d2=DIMS[1], h=HIDDEN, cd=CD,
                            s1=STYLE[0], s2=STYLE[1])


def noise_width(method):
    w = CD + sum(STYLE)
    return w + (2 * CD + sum(STYLE) if method == "poe" else 0)


def split_np(seed=0):
    rng = np.random.default_rng(seed)
    sp = {n: (0.1 * rng.normal(size=s)).astype(np.float32)
          for n, s in bridge.split_shapes(dims()).items()}
    sp["dec1_olv"] = np.full_like(sp["dec1_olv"], -1.0)
    sp["dec2_olv"] = np.full_like(sp["dec2_olv"], -0.5)
    return sp


def batch_np(method, masked, seed):
    """``(x1, x2, noise, masks)`` of B rows; masks ``[n_masks, B, hidden]``
    of pre-scaled keep values, or None."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x1, x2, noise = f(B, DIMS[0]), f(B, DIMS[1]), f(B, noise_width(method))
    masks = None
    if masked:
        n = fused_methods.n_dropout_masks(method, RATE)
        keep = rng.random(size=(n, B, HIDDEN)) < 1.0 - RATE
        masks = (keep / (1.0 - RATE)).astype(np.float32)
    return x1, x2, noise, masks


def t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def shard_rows(k, n_dev):
    local = B // n_dev
    return slice(k * local, (k + 1) * local), k * local, local


def torch_slice_step(method, masked, sp, batch, k, n_dev, learn_scale=True):
    """The port's plain row-slice step of shard ``k``: ``(metrics, grads
    dict)``, through the wrappers (the plain version on CPU tensors)."""
    x1, x2, noise, masks = batch
    rows, offset, local = shard_rows(k, n_dev)
    p = bridge.flatten_split(t(sp))
    consts = fused_step.FusedConsts(*CONSTS)
    tx1, tx2, tn = (torch.from_numpy(a[rows]) for a in (x1, x2, noise))
    counters = (dict(fused_step.KERNEL_LAUNCHES),
                dict(fused_methods.KERNEL_LAUNCHES))
    if method == "joint_elbo" and not masked:
        m, g = fused_step.slice_step_flat(
            p, tx1, tx2, *fused_step.split_noise(tn, dims(local)),
            dims(local), consts, learn_scale, offset, B)
    else:
        m, g = fused_methods.slice_method_step_flat(
            method, p, tx1, tx2, tn, dims(local), consts, learn_scale,
            None if masks is None else torch.from_numpy(masks[:, rows]),
            offset, B)
    # plain on the CPU: no launch is counted
    assert counters == (fused_step.KERNEL_LAUNCHES,
                        fused_methods.KERNEL_LAUNCHES)
    return m, bridge.flat_views(g, dims(local))


def jax_slice_step(method, masked, sp, batch, k, n_dev, learn_scale=True):
    """``jax.value_and_grad(method_loss_split)`` on shard ``k``."""
    x1, x2, noise, masks = batch
    rows, offset, local = shard_rows(k, n_dev)
    jd = jax_fs.FusedDims(*dims(local))

    def loss_fn(p):
        return jax_fm.method_loss_split(
            method, jd, jax_fs.FusedConsts(*CONSTS), learn_scale, False, p,
            jnp.asarray(x1[rows]), jnp.asarray(x2[rows]),
            jnp.asarray(noise[rows]),
            dropout_masks=None if masks is None else tuple(
                jnp.asarray(m[rows]) for m in masks),
            row_offset=offset, b_total=B)

    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(j(sp))
    return loss, np.stack([np.asarray(m) for m in metrics]), grads


def hold_step(got, want_loss, want_metrics, want_grads, rtol=RTOL, atol=ATOL):
    metrics, grads = got
    close(metrics[0], want_loss, rtol=LOSS_RTOL, atol=0)
    close(metrics, want_metrics, rtol, atol)
    for name in bridge.SPLIT_NAMES:
        close(grads[name], want_grads[name], rtol, atol)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("method,masked", CASES, ids=CASE_IDS)
def test_plain_slice_matches_jax_autodiff(method, masked, n_dev):
    sp = split_np(METHODS.index(method))
    batch = batch_np(method, masked, 20 + n_dev)
    for k in range(n_dev):
        hold_step(torch_slice_step(method, masked, sp, batch, k, n_dev),
                  *jax_slice_step(method, masked, sp, batch, k, n_dev))


@pytest.mark.parametrize("learn_scale", [True, False])
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_plain_mopoe_slice_matches_jax_fwd_bwd(n_dev, learn_scale):
    """The MoPoE step's plain version against the hand-derived ``_fwd_bwd``
    with the same ``row_offset`` and ``b_total``."""
    sp = split_np(4)
    x1, x2, noise, _ = batch = batch_np("joint_elbo", False, 30 + n_dev)
    for k in range(n_dev):
        rows, offset, local = shard_rows(k, n_dev)
        ej, es1, es2 = (jnp.asarray(a[rows]) for a in
                        (noise[:, :CD], noise[:, CD:CD + STYLE[0]],
                         noise[:, CD + STYLE[0]:]))
        loss, metrics, grads = jax_fs._fwd_bwd(
            jax_fs.FusedDims(*dims(local)), jax_fs.FusedConsts(*CONSTS),
            learn_scale, False, jnp.asarray(x1[rows]), jnp.asarray(x2[rows]),
            ej, es1, es2, j(sp), row_offset=offset, b_total=B)
        got = torch_slice_step("joint_elbo", False, sp, batch, k, n_dev,
                               learn_scale)
        hold_step(got, loss, np.stack([np.asarray(m) for m in metrics]),
                  grads)
        if not learn_scale:
            assert not got[1]["dec1_olv"].any()


@pytest.mark.parametrize("method,masked", CASES, ids=CASE_IDS)
def test_plain_slice_matches_pallas_bodies(method, masked):
    """Against ``_dp_loss_and_grads`` / ``_dp_method_loss_and_grads`` (the
    TPU kernels' bodies, interpret mode) on every shard of 4."""
    n_dev = 4
    sp = split_np(10 + METHODS.index(method))
    x1, x2, noise, masks = batch = batch_np(method, masked, 40)
    consts = jax_fs.FusedConsts(*CONSTS)
    for k in range(n_dev):
        rows, offset, local = shard_rows(k, n_dev)
        jd = jax_fs.FusedDims(*dims(local))
        jx1, jx2, jn = (jnp.asarray(a[rows]) for a in (x1, x2, noise))
        if method == "joint_elbo" and not masked:
            mvec, grads = jax_fsh._dp_loss_and_grads(
                j(sp), jx1, jx2, jn[:, :CD], jn[:, CD:CD + STYLE[0]],
                jn[:, CD + STYLE[0]:], offset, jd, B, consts, True, True,
                False)
        else:
            jmasks = [] if masks is None else [jnp.asarray(m[rows])
                                               for m in masks]
            mvec, grads = jax_fsh._dp_method_loss_and_grads(
                j(sp), jx1, jx2, jn, jmasks, offset, method, jd, B, consts,
                True, True, False, fused_methods.n_method_metrics(method))
        hold_step(torch_slice_step(method, masked, sp, batch, k, n_dev),
                  mvec[0], mvec, grads)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("method,masked", CASES, ids=CASE_IDS)
def test_sum_over_shards_is_the_unsharded_step(method, masked, n_dev):
    sp = split_np(METHODS.index(method))
    x1, x2, noise, masks = batch = batch_np(method, masked, 50 + n_dev)
    msum, gsum = None, None
    for k in range(n_dev):
        m, g = torch_slice_step(method, masked, sp, batch, k, n_dev)
        g = bridge.flatten_split(g)
        msum = m if msum is None else msum + m
        gsum = g if gsum is None else gsum + g
    p = bridge.flatten_split(t(sp))
    consts = fused_step.FusedConsts(*CONSTS)
    tx1, tx2, tn = (torch.from_numpy(a) for a in (x1, x2, noise))
    if method == "joint_elbo" and not masked:
        want_m, want_g = fused_step.step_flat(
            p, tx1, tx2, *fused_step.split_noise(tn, dims()), dims(), consts)
    else:
        want_m, want_g = fused_methods.method_step_flat(
            method, p, tx1, tx2, tn, dims(), consts, True,
            None if masks is None else torch.from_numpy(masks))
    got_m = fused_sharded.mean_rescale(msum, n_dev)
    close(got_m[0], want_m[0], rtol=LOSS_RTOL, atol=0)
    close(got_m, want_m, SUM_RTOL, SUM_ATOL)
    close(gsum, want_g, SUM_RTOL, SUM_ATOL)
    # the slice that is the whole batch is the unsharded step, bit for bit
    m, g = torch_slice_step(method, masked, sp, batch, 0, 1)
    assert torch.equal(m, want_m)
    assert torch.equal(bridge.flatten_split(g), want_g)


@pytest.mark.parametrize("n_met", [17, 19])
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_mean_rescale_matches_jax(n_dev, n_met):
    mvec = np.random.default_rng(n_dev).normal(size=n_met).astype(np.float32)
    got = fused_sharded.mean_rescale(torch.from_numpy(mvec), n_dev)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_fsh._mean_rescale(jnp.asarray(mvec),
                                                      n_dev)))


def test_slice_arguments_are_checked():
    p = bridge.flatten_split(t(split_np()))
    x1, x2, noise = (torch.from_numpy(a) for a in
                     batch_np("moe", False, 1)[:3])
    consts = fused_step.FusedConsts(*CONSTS)
    d = dims(12)
    args = ("moe", p, x1[:12], x2[:12], noise[:12], d, consts, True, None)
    with pytest.raises(ValueError, match="not inside a batch"):
        fused_methods.slice_method_step_flat(*args, 40, B)
    with pytest.raises(TypeError, match="row_offset is an int"):
        fused_methods.slice_method_step_flat(*args, 12.0, B)
    with pytest.raises(TypeError, match="b_total is an int"):
        fused_step.slice_step_flat(
            p, x1[:12], x2[:12], *fused_step.split_noise(noise[:12], d), d,
            consts, True, 0, float(B))
    with pytest.raises(ValueError, match="row_offset needs b_total"):
        fused_step.fwd_bwd_reference(
            t(split_np()), x1[:12], x2[:12],
            *fused_step.split_noise(noise[:12], d), d, consts, True, 12)


# ------------------------------------------------------- data-parallel epoch
def make_cfg(method="joint_elbo", **kw):
    return Config(method=method, class_dim=CD, hidden_dim=HIDDEN,
                  input_dim=list(DIMS), style_dim=list(STYLE),
                  beta=CONSTS[0], beta_style=CONSTS[1],
                  beta_content=CONSTS[2], learn_output_scale=True,
                  batch_size=B, num_hidden_layer_encoder=1,
                  num_hidden_layer_decoder=0, **kw).derive()


def jax_setup(method, rate, seed=0):
    rng = np.random.default_rng(seed)
    cfg = make_cfg(method, dropout_rate=rate)
    model = jax_build_model(cfg, jax_make_modalities(
        cfg.input_dim, cfg.style_dim, cfg.likelihood))
    names = [m.name for m in model.modalities]
    batches = {n: rng.normal(size=(N_STEPS, B, d)).astype(np.float32)
               for n, d in zip(names, DIMS)}
    params, opt_state = jax_init_state(
        cfg, model, {k: jnp.asarray(v[0]) for k, v in batches.items()})
    rngs = jax.random.split(jax.random.PRNGKey(seed), N_STEPS)
    return cfg, model, names, params, opt_state, batches, rngs


def jax_streams(cfg, rngs):
    """The noise and the masks ``make_fused_dp_scan_train_step`` draws from
    ``rngs`` (``fused_sharded.py:182-200``), as numpy arrays."""
    rate = float(cfg.dropout_rate)
    use_hand = cfg.method == "joint_elbo" and rate == 0.0
    width = CD + sum(STYLE) if use_hand else jax_fm.noise_width(cfg)
    noise = jax.vmap(lambda k: jax.random.normal(
        k, (B, width), jnp.float32))(rngs)
    n_masks = 0 if use_hand else fused_methods.n_dropout_masks(cfg.method,
                                                               rate)
    masks = None
    if n_masks:
        def draw(k):
            keep = jax.random.bernoulli(jax.random.fold_in(k, 7), 1.0 - rate,
                                        (n_masks, B, cfg.hidden_dim))
            return keep.astype(jnp.float32) / (1.0 - rate)
        masks = np.asarray(jax.vmap(draw)(rngs))
    return np.asarray(noise), masks


def port_model(cfg):
    from multivae_tpu_torch.models import build_model, make_modalities

    return build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                            cfg.likelihood), "cpu")


def check_dp_epoch(method, rate, n_dev):
    cfg, jmodel, names, params, opt_state, batches, rngs = jax_setup(method,
                                                                     rate)
    fn = jax_fsh.make_fused_dp_scan_train_step(
        cfg, jmodel, jax_data_mesh(n_dev), interpret=True)
    p_ref, o_ref, l_ref, m_ref = fn(
        params, opt_state, {k: jnp.asarray(v) for k, v in batches.items()},
        rngs)

    noise, masks = jax_streams(cfg, rngs)
    d = dims()
    p = bridge.ravel_to_split_flat(ravel_pytree(params)[0], d, names)
    opt = adam_ops.init_adam_state(p)
    epoch = fused_sharded.make_fused_dp_epoch(
        cfg, port_model(cfg), data_mesh(n_dev, [CPU] * n_dev))
    opt, metrics, mnames = epoch(
        p, opt, {k: torch.from_numpy(v) for k, v in batches.items()},
        torch.from_numpy(noise),
        None if masks is None else torch.from_numpy(masks))

    assert opt.count == int(o_ref.count) == N_STEPS
    close(metrics[:, 0], l_ref, rtol=2e-5, atol=0)
    assert set(mnames) == set(m_ref)
    for i, name in enumerate(mnames):
        close(metrics[:, i], m_ref[name], 5e-4, 5e-4)
    # the port's state in the JAX package's raveled order, and back
    close(bridge.split_flat_to_ravel(p, d, names), ravel_pytree(p_ref)[0],
          1e-4, 1e-5)
    state = FlatAdamState(
        count=jnp.asarray(opt.count, jnp.int32),
        mu=jnp.asarray(bridge.split_flat_to_ravel(opt.mu, d, names)),
        nu=jnp.asarray(bridge.split_flat_to_ravel(opt.nu, d, names)))
    close(state.mu, o_ref.mu, 1e-4, 1e-5)
    close(state.nu, o_ref.nu, 1e-4, 1e-5)
    for vec, buf in ((state.mu, opt.mu), (state.nu, opt.nu)):
        assert torch.equal(bridge.ravel_to_split_flat(vec, d, names), buf)


@pytest.mark.parametrize("method,rate,n_dev", [
    ("joint_elbo", 0.0, 2), ("joint_elbo", 0.0, 8), ("moe", 0.0, 4),
    ("joint_elbo", RATE, 4)])
def test_dp_epoch_matches_jax_dp_scan(method, rate, n_dev):
    check_dp_epoch(method, rate, n_dev)


@pytest.mark.slow
@pytest.mark.parametrize("method,rate", [("poe", 0.0), ("jsd", 0.0),
                                         ("moe", RATE), ("poe", RATE)])
def test_dp_epoch_matches_jax_dp_scan_slow(method, rate):
    check_dp_epoch(method, rate, 4)


def port_epoch_inputs(method, masked, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    xs = {"clinical": f(N_STEPS, B, DIMS[0]), "rois": f(N_STEPS, B, DIMS[1])}
    noise = f(N_STEPS, B, noise_width(method))
    masks = None
    if masked:
        n = fused_methods.n_dropout_masks(method, RATE)
        masks = torch.from_numpy((rng.random(
            size=(N_STEPS, n, B, HIDDEN)) < 1 - RATE).astype(np.float32)
            / (1 - RATE))
    return xs, noise, masks


@pytest.mark.parametrize("method,masked", CASES, ids=CASE_IDS)
def test_dp_epoch_matches_the_unsharded_epoch(method, masked):
    """One seed, ``data_parallel`` 4 against 1: the bounds of
    ``tests/test_fused_sharded.py:81-84``."""
    from multivae_tpu_torch.train import trainer

    cfg = make_cfg(method, dropout_rate=RATE if masked else 0.0)
    model = port_model(cfg)
    xs, noise, masks = port_epoch_inputs(method, masked, 3)
    p0 = bridge.model_flat_params(model, dims())
    out = {}
    for n_dev in (1, 4):
        p = p0.clone()
        fn = (trainer.make_group_fused_epoch(
            cfg, model, (("clinical", "rois"), B)) if n_dev == 1 else
            fused_sharded.make_fused_dp_epoch(
                cfg, model, data_mesh(n_dev, [CPU] * n_dev)))
        opt, metrics, names = fn(p, adam_ops.init_adam_state(p), xs, noise,
                                 masks)
        out[n_dev] = (p, opt, metrics, names)
    assert out[1][3] == out[4][3] and out[4][1].count == N_STEPS
    close(out[4][2][:, 0], out[1][2][:, 0], rtol=2e-5, atol=0)
    close(out[4][2], out[1][2], 5e-4, 5e-4)
    assert float((out[4][0] - out[1][0]).abs().max()) < 1e-5
    assert float((out[4][1].mu - out[1][1].mu).abs().max()) < 1e-5


def test_dp_epoch_checks_its_inputs():
    cfg = make_cfg("moe")
    model = port_model(cfg)
    xs, noise, _ = port_epoch_inputs("moe", False, 4)
    p = bridge.model_flat_params(model, dims())
    opt = adam_ops.init_adam_state(p)
    with pytest.raises(ValueError, match="multiple of data_parallel"):
        fused_sharded.make_fused_dp_epoch(
            cfg, model, data_mesh(5, [CPU] * 5))(p, opt, xs, noise)
    with pytest.raises(ValueError, match="takes 0 masks"):
        fused_sharded.make_fused_dp_epoch(
            cfg, model, data_mesh(4, [CPU] * 4))(
                p, opt, xs, noise, torch.ones(N_STEPS, 2, B, HIDDEN))


# ---------------------------------------------------------------------- mesh
def test_meshes():
    devs = [torch.device("cpu")] * 6
    mesh = make_mesh(2, 3, devs)
    assert mesh.shape == {"model": 2, "data": 3}
    assert mesh.axis_names == ("model", "data")
    assert len(mesh.axis_devices("model")) == 2
    assert len(mesh.axis_devices("data")) == 3
    assert make_mesh(2, None, devs).shape == {"model": 2, "data": 3}
    assert data_mesh(4, devs).shape == {"data": 4}
    assert data_mesh(None, devs).shape == {"data": 6}
    with pytest.raises(ValueError, match="needs 8 devices, have 6"):
        make_mesh(2, 4, devs)
    with pytest.raises(ValueError, match="needs 7 devices, have 6"):
        data_mesh(7, devs)
    with pytest.raises(ValueError, match="does not hold"):
        Mesh(devs, ("data",), (4,))
    assert spread("cpu", 3) == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a visible card"):
            data_mesh(4)


def test_mesh_axis_devices_follow_the_grid():
    grid = [torch.device("cuda", i) for i in range(6)]
    mesh = Mesh(grid, ("model", "data"), (2, 3))
    assert mesh.axis_devices("model") == [grid[0], grid[3]]
    assert mesh.axis_devices("data") == grid[:3]
    assert Mesh(grid[:2] * 2, ("data",), (4,)).axis_devices("data") == \
        grid[:2] * 2
