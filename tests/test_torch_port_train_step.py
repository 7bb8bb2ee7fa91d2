"""The port's MoPoE train step against the JAX package.

On the CPU the port's step runs its plain PyTorch version
(``fwd_bwd_reference``: the hand backward of ``_fwd_bwd``) and the JAX
kernels run in interpret mode, as the JAX package's own tests run them.
Both get the same split params, batches and noise, made with numpy.
Tolerances are the JAX package's own (``tests/test_fused_step.py``): the
loss at rtol 1e-5, metrics and grads at rtol 5e-4 / atol 1e-5 (float32,
another summation order); after a 5-step epoch params, mu and nu at
rtol 1e-4 / atol 1e-6. The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.ops import fused_methods as jax_fm
from multivae_tpu.ops import fused_step as jax_fs
from multivae_tpu.train import Config
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.ops import adam as adam_ops
from multivae_tpu_torch.ops import fused_methods, fused_step
from multivae_tpu_torch.train import train_step

pytestmark = pytest.mark.driver  # cross-framework parity pins

DIMS = (3, 12)
HIDDEN, CD, STYLE = 16, 4, (2, 3)
B, B_PARTIAL = 12, 7
RTOL, ATOL = 5e-4, 1e-5
LOSS_RTOL = 1e-5
CONSTS = (1.0, 1.0, 1.0)
HYPER = adam_ops.AdamHyper(2e-3, 0.9, 0.999)


def dims(b=B):
    return bridge.FusedDims(b=b, d1=DIMS[0], d2=DIMS[1], h=HIDDEN, cd=CD,
                            s1=STYLE[0], s2=STYLE[1])


def make_cfg(**kw):
    base = dict(method="joint_elbo", input_dim=list(DIMS), class_dim=CD,
                style_dim=list(STYLE), hidden_dim=HIDDEN,
                num_hidden_layer_encoder=1, num_hidden_layer_decoder=0)
    base.update(kw)
    return Config(**base).derive()


def split_np(seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    sp = {n: (scale * rng.normal(size=s)).astype(np.float32)
          for n, s in bridge.split_shapes(dims()).items()}
    sp["dec1_olv"] = np.full_like(sp["dec1_olv"], -1.0)
    sp["dec2_olv"] = np.full_like(sp["dec2_olv"], -1.0)
    return sp


def batch_np(b, seed=1, steps=None):
    rng = np.random.default_rng(seed)
    lead = () if steps is None else (steps,)
    f = lambda *s: rng.normal(size=lead + s).astype(np.float32)
    return f(b, DIMS[0]), f(b, DIMS[1]), f(b, CD), f(b, STYLE[0]), \
        f(b, STYLE[1])


def t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("learn_scale", [True, False])
def test_reference_matches_jax_step_kernel(learn_scale):
    sp = split_np()
    xs = batch_np(B)
    jd = jax_fs.FusedDims(*dims())
    loss, grads, mvec = jax_fs.fused_loss_and_grads(
        jax_fs.join_params(j(sp), jd), *map(jnp.asarray, xs), jd,
        jax_fs.FusedConsts(*CONSTS), learn_scale=learn_scale,
        interpret=True)
    want = jax_fs.split_params(grads, jd)
    tloss, tmet, tg = fused_step.fwd_bwd_reference(
        t(sp), *map(torch.from_numpy, xs), dims(),
        fused_step.FusedConsts(*CONSTS), learn_scale)
    close(tloss, loss, rtol=LOSS_RTOL, atol=0)
    close(tmet, mvec)
    for name in bridge.SPLIT_NAMES:
        close(tg[name], want[name])


@pytest.mark.parametrize("learn_scale", [True, False])
def test_reference_matches_jax_grad(learn_scale):
    sp = split_np(3)
    xs = batch_np(B, 4)
    jd = jax_fs.FusedDims(*dims())

    def loss_fn(p):
        return jax_fs.fused_loss_reference(
            p, *map(jnp.asarray, xs), jd, jax_fs.FusedConsts(*CONSTS),
            learn_scale=learn_scale)

    loss, g = jax.value_and_grad(loss_fn)(jax_fs.join_params(j(sp), jd))
    want = jax_fs.split_params(g, jd)
    tloss, _, tg = fused_step.fwd_bwd_reference(
        t(sp), *map(torch.from_numpy, xs), dims(),
        fused_step.FusedConsts(*CONSTS), learn_scale)
    close(tloss, loss, rtol=LOSS_RTOL, atol=0)
    for name in bridge.SPLIT_NAMES:
        close(tg[name], want[name])


def test_partial_batch_matches_method_loss_split():
    """A complete batch of B_PARTIAL rows: the TPU method kernel's
    joint_elbo branch under jax.value_and_grad."""
    sp = split_np(5)
    x1, x2, ej, es1, es2 = batch_np(B_PARTIAL, 6)
    noise = np.concatenate([ej, es1, es2], axis=1)
    jd = jax_fs.FusedDims(*dims(B_PARTIAL))

    def loss_fn(p):
        return jax_fm.method_loss_split(
            "joint_elbo", jd, jax_fs.FusedConsts(*CONSTS), True, False, p,
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(noise))

    (loss, metrics), want = jax.value_and_grad(loss_fn, has_aux=True)(j(sp))
    tloss, tmet, tg = fused_step.loss_and_grads(
        t(sp), *map(torch.from_numpy, (x1, x2, ej, es1, es2)),
        dims(B_PARTIAL), fused_step.FusedConsts(*CONSTS), True)
    close(tloss, loss, rtol=LOSS_RTOL, atol=0)
    close(tmet, np.stack([np.asarray(m) for m in metrics]))
    for name in bridge.SPLIT_NAMES:
        close(tg[name], want[name])


@pytest.mark.parametrize("count", [0, 3])
def test_fused_epoch_matches_jax(count):
    sp = split_np(7)
    n = 5
    x1s, x2s, ejs, es1s, es2s = batch_np(B, 8, steps=n)
    rng = np.random.default_rng(9)
    mu = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in sp.items()}
    nu = {k: (1e-4 * rng.random(size=v.shape)).astype(np.float32)
          for k, v in sp.items()}
    if count == 0:
        mu = {k: np.zeros_like(v) for k, v in sp.items()}
        nu = {k: np.zeros_like(v) for k, v in sp.items()}
    jd = jax_fs.FusedDims(*dims())
    want = jax_fs.fused_epoch(
        j(sp), j(mu), j(nu), count, *map(jnp.asarray,
                                         (x1s, x2s, ejs, es1s, es2s)),
        jd, jax_fs.FusedConsts(*CONSTS), tuple(HYPER), learn_scale=True,
        interpret=True, matmul_bf16=False)
    got = fused_step.fused_epoch(
        t(sp), t(mu), t(nu), count,
        *map(torch.from_numpy, (x1s, x2s, ejs, es1s, es2s)), dims(),
        fused_step.FusedConsts(*CONSTS), HYPER, True)
    close(got[3][:, 0], want[3][:, 0], rtol=LOSS_RTOL, atol=0)
    close(got[3], want[3])
    for k in range(3):
        for name in bridge.SPLIT_NAMES:
            close(got[k][name], want[k][name], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("count", [0, 5])
@pytest.mark.parametrize("n", [1, 3])
def test_epoch_flat_matches_jax_fused_epoch(n, count):
    """``epoch_flat`` (flat buffers updated in place, the stacked noise as
    one ``[n, B, cd + s1 + s2]`` input: the one-launch entry point's
    contract) against ``fused_epoch(interpret=True)`` on the same
    numpy-seeded batches and noise."""
    sp = split_np(31)
    rng = np.random.default_rng(32)
    mu = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in sp.items()}
    nu = {k: (1e-4 * rng.random(size=v.shape)).astype(np.float32)
          for k, v in sp.items()}
    x1s, x2s, ejs, es1s, es2s = batch_np(B, 33, steps=n)
    want = jax_fs.fused_epoch(
        j(sp), j(mu), j(nu), count, *map(jnp.asarray,
                                         (x1s, x2s, ejs, es1s, es2s)),
        jax_fs.FusedDims(*dims()), jax_fs.FusedConsts(*CONSTS), tuple(HYPER),
        learn_scale=True, interpret=True, matmul_bf16=False)
    p, m, v = (bridge.flatten_split(t(d)) for d in (sp, mu, nu))
    noise = torch.from_numpy(np.concatenate([ejs, es1s, es2s], axis=-1))
    metrics = fused_step.epoch_flat(
        p, m, v, count, torch.from_numpy(x1s), torch.from_numpy(x2s), noise,
        dims(), fused_step.FusedConsts(*CONSTS), HYPER, True)
    assert metrics.shape == (n, fused_step.N_METRICS)
    close(metrics[:, 0], want[3][:, 0], rtol=LOSS_RTOL, atol=0)
    close(metrics, want[3])
    for got, ref in zip((p, m, v), want[:3]):
        views = bridge.flat_views(got, dims())
        for name in bridge.SPLIT_NAMES:
            close(views[name], ref[name], rtol=1e-5, atol=1e-6)


def test_fused_epoch_leaves_inputs_and_counts_no_launch():
    sp = t(split_np())
    before = {k: v.clone() for k, v in sp.items()}
    launches = dict(fused_step.KERNEL_LAUNCHES)
    adam_launches = dict(adam_ops.KERNEL_LAUNCHES)
    zeros = {k: torch.zeros_like(v) for k, v in sp.items()}
    fused_step.fused_epoch(sp, zeros, zeros, 0,
                           *map(torch.from_numpy, batch_np(B, steps=2)),
                           dims(), fused_step.FusedConsts(*CONSTS), HYPER)
    for k in sp:
        assert torch.equal(sp[k], before[k])
        assert not zeros[k].any()
    # the CPU path is the plain version: no kernel launch is counted
    assert fused_step.KERNEL_LAUNCHES == launches
    assert adam_ops.KERNEL_LAUNCHES == adam_launches


@pytest.mark.parametrize("learn_scale", [True, False])
def test_general_step_matches_hand_grads(learn_scale):
    """The general autograd step (model + total_loss) is a second oracle
    of the hand backward."""
    cfg = make_cfg(learn_output_scale=learn_scale)
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu")
    sp = t(split_np(11))
    flat = bridge.flatten_split(sp)
    bridge.load_flat_params(model, flat, dims())
    x1, x2, ej, es1, es2 = map(torch.from_numpy, batch_np(B, 12))
    batch = {"clinical": x1, "rois": x2}
    noise = torch.cat([ej, es1, es2], dim=1)
    model.zero_grad()
    loss, metrics = train_step.loss_and_metrics(cfg, model, batch, noise)
    loss.backward()
    got = bridge.flat_views(train_step.grads_flat(model, dims()), dims())
    tloss, tmet, want = fused_step.fwd_bwd_reference(
        sp, x1, x2, ej, es1, es2, dims(), fused_step.FusedConsts(*CONSTS),
        learn_scale)
    close(loss.detach(), tloss, rtol=LOSS_RTOL, atol=0)
    names = fused_step.metric_names(model)
    close(torch.stack([metrics[n].detach() for n in names]), tmet)
    for name in bridge.SPLIT_NAMES:
        close(got[name], want[name])


def test_general_step_applies_adam():
    cfg = make_cfg()
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu")
    p, opt = train_step.init_train_state(model, dims())
    assert train_step.param_count(model) == p.numel() == bridge.flat_size(
        dims())
    x1, x2, ej, es1, es2 = map(torch.from_numpy, batch_np(B, 13))
    batch = {"clinical": x1, "rois": x2}
    noise = torch.cat([ej, es1, es2], dim=1)
    p0 = p.clone()
    _, g = fused_step.step_flat(p0, x1, x2, ej, es1, es2, dims(),
                                fused_step.consts_from(cfg))
    opt2, loss, _ = train_step.general_step(cfg, model, p, opt, batch, noise,
                                            dims(), HYPER)
    assert opt2.count == 1 and torch.isfinite(loss)
    want, mu, nu = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
    adam_ops.adam_update_reference(want, mu, nu, g, 1, HYPER)
    close(p, want, rtol=1e-5, atol=1e-7)


def test_metric_names_and_support_match_jax():
    from multivae_tpu.models import build_model as jax_build
    from multivae_tpu.models import make_modalities as jax_mods

    for kw in ({}, {"method": "moe"}, {"method": "poe"},
               {"dropout_rate": 0.1},
               {"num_hidden_layer_decoder": 1},
               {"learn_output_sample_scale": True}):
        cfg = make_cfg(**kw)
        jm = jax_build(cfg, jax_mods(cfg.input_dim, cfg.style_dim,
                                     cfg.likelihood))
        tm = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                              cfg.likelihood), "cpu")
        batch = {"clinical": None, "rois": None}
        assert fused_step.metric_names(tm) == jax_fs.metric_names(jm)
        assert (fused_step.supports_fused(cfg, tm, batch)
                == jax_fs.supports_fused(cfg, jm, batch))
        assert not fused_step.supports_fused(cfg, tm, {"clinical": None})
        assert (fused_methods.method_metric_names(tm, cfg.method)
                == jax_fm.method_metric_names(jm, cfg.method))
        assert fused_methods.noise_width(cfg) == jax_fm.noise_width(cfg)
        assert (fused_methods.supports_method_fused(cfg, tm, batch)
                == jax_fm.supports_method_fused(cfg, jm, batch))
    for b in (3, 7, 12, 256):
        for k in (2, 3):
            assert (fused_methods._uniform_bounds(b, k)
                    == jax_fm._uniform_bounds(b, k))
        assert fused_step.mixture_bounds(b) == jax_fs._mixture_bounds(b)


def test_step_has_no_kernel_for_other_devices():
    meta = torch.empty(bridge.flat_size(dims()), device="meta")
    x = torch.empty((B, 1), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_step.step_flat(meta, x, x, x, x, x, dims(),
                             fused_step.FusedConsts(*CONSTS))
