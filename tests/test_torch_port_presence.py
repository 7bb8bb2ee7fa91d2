"""The port's presence step (one modality present; four methods, with and
without dropout masks) against the JAX package.

The port's plain version carries a hand-derived backward; the JAX package
gets its gradient from ``jax.value_and_grad`` of ``presence_loss_split``
inside its Pallas kernel, which is the oracle here. The epoch runs the
JAX package's own Pallas body (``_presence_epoch_kernel``) in interpret
mode with the port's noise fed in (``build_presence_epoch`` draws its own,
so the test builds the same ``pallas_call`` with the noise and the masks
as inputs). The method cases use ``beta_style != 1`` and the row counts 12
and 7 (2-way bounds 6 and 3). Tolerances as in
``test_torch_port_train_step.py``; params, mu and nu after a 3-step epoch
of a method case at rtol 1e-4 / atol 1e-5.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from multivae_tpu.ops import fused_presence as jax_fp
from multivae_tpu.ops import fused_step as jax_fs
from multivae_tpu.train import Config
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.ops import adam as adam_ops
from multivae_tpu_torch.ops import fused_presence, fused_step

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


def split_np(seed=0):
    rng = np.random.default_rng(seed)
    sp = {n: (0.3 * rng.normal(size=s)).astype(np.float32)
          for n, s in bridge.split_shapes(dims()).items()}
    sp["dec1_olv"] = np.full_like(sp["dec1_olv"], -1.0)
    sp["dec2_olv"] = np.full_like(sp["dec2_olv"], -1.0)
    return sp


def present_np(mod_idx, b, seed, steps=None):
    rng = np.random.default_rng(seed)
    lead = () if steps is None else (steps,)
    x = rng.normal(size=lead + (b, DIMS[mod_idx])).astype(np.float32)
    noise = rng.normal(size=lead + (b, CD + STYLE[mod_idx])).astype(
        np.float32)
    return x, noise


def t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("b", [B, B_PARTIAL])
@pytest.mark.parametrize("learn_scale", [True, False])
@pytest.mark.parametrize("mod_idx", [0, 1])
def test_reference_matches_jax_autodiff(mod_idx, learn_scale, b):
    sp = split_np(mod_idx)
    x, noise = present_np(mod_idx, b, 10 + mod_idx)
    jd = jax_fs.FusedDims(*dims(b))

    def loss_fn(p):
        return jax_fp.presence_loss_split(
            "joint_elbo", jd, jax_fs.FusedConsts(*CONSTS), learn_scale,
            False, mod_idx, p, jnp.asarray(x), jnp.asarray(noise))

    (loss, metrics), want = jax.value_and_grad(loss_fn, has_aux=True)(j(sp))
    launches = dict(fused_presence.KERNEL_LAUNCHES)
    tmet, tg = fused_presence.presence_step_flat(
        bridge.flatten_split(t(sp)), torch.from_numpy(x),
        torch.from_numpy(noise), dims(b), fused_step.FusedConsts(*CONSTS),
        learn_scale, mod_idx)
    assert fused_presence.KERNEL_LAUNCHES == launches  # plain on the CPU
    close(tmet[0], loss, rtol=LOSS_RTOL, atol=0)
    close(tmet, np.stack([np.asarray(m) for m in metrics]))
    got = bridge.flat_views(tg, dims(b))
    for name in bridge.SPLIT_NAMES:
        close(got[name], want[name])


def jax_presence_epoch(sp, mu, nu, count, xs, noise, mod_idx,
                       method="joint_elbo", masks=None, consts=CONSTS):
    """``build_presence_epoch``'s ``pallas_call`` with the noise and the
    masks (``[n, n_masks, b, hidden]`` or None) as inputs."""
    n = len(jax_fs.SPLIT_NAMES)
    n_steps, b = xs.shape[:2]
    jd = jax_fs.FusedDims(*dims(b))
    n_met = fused_presence.n_presence_metrics(method)
    n_masks = 0 if masks is None else masks.shape[1]
    kernel = partial(jax_fp._presence_epoch_kernel, method, jd,
                     jax_fs.FusedConsts(*consts), True, False, mod_idx,
                     tuple(HYPER), n_met, n_masks)
    whole = pl.BlockSpec(memory_space=pltpu.VMEM)
    stream = lambda w: pl.BlockSpec((1, b, w), lambda i: (i, 0, 0))
    names = jax_fs.SPLIT_NAMES
    outs = pl.pallas_call(
        kernel, grid=(n_steps,),
        out_shape=([jax.ShapeDtypeStruct((n_steps, n_met), jnp.float32)]
                   + [jax.ShapeDtypeStruct(sp[nm].shape, jnp.float32)
                      for nm in names] * 3),
        in_specs=([stream(xs.shape[2]), stream(noise.shape[2])]
                  + [stream(HIDDEN)] * n_masks
                  + [pl.BlockSpec(memory_space=pltpu.SMEM)]
                  + [whole] * (3 * n)),
        out_specs=([pl.BlockSpec(memory_space=pltpu.SMEM)]
                   + [whole] * (3 * n)),
        interpret=True,
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",)),
    )(jnp.asarray(xs), jnp.asarray(noise),
      *[jnp.asarray(masks[:, i]) for i in range(n_masks)],
      jnp.asarray(count, jnp.int32).reshape(1, 1),
      *[jnp.asarray(sp[nm]) for nm in names],
      *[jnp.asarray(mu[nm]) for nm in names],
      *[jnp.asarray(nu[nm]) for nm in names])
    return ([dict(zip(names, outs[1 + k * n:1 + (k + 1) * n]))
             for k in range(3)], outs[0])


@pytest.mark.parametrize("mod_idx", [0, 1])
def test_epoch_matches_jax_pallas_body(mod_idx):
    sp = split_np(20 + mod_idx)
    rng = np.random.default_rng(21)
    mu = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in sp.items()}
    nu = {k: (1e-4 * rng.random(size=v.shape)).astype(np.float32)
          for k, v in sp.items()}
    xs, noise = present_np(mod_idx, B, 22, steps=3)
    (jp, jmu, jnu), jmet = jax_presence_epoch(sp, mu, nu, 4, xs, noise,
                                              mod_idx)
    got = fused_presence.presence_epoch(
        t(sp), t(mu), t(nu), 4, torch.from_numpy(xs),
        torch.from_numpy(noise), dims(), fused_step.FusedConsts(*CONSTS),
        HYPER, True, mod_idx)
    close(got[3][:, 0], jmet[:, 0], rtol=LOSS_RTOL, atol=0)
    close(got[3], jmet)
    for k, want in enumerate((jp, jmu, jnu)):
        for name in bridge.SPLIT_NAMES:
            close(got[k][name], want[name], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("count", [0, 5])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("mod_idx", [0, 1])
def test_epoch_flat_matches_jax_pallas_body(mod_idx, n, count):
    """``presence_epoch_flat`` (flat buffers updated in place: the
    one-launch entry point's contract) against the JAX package's epoch body
    on the same numpy-seeded batches and noise."""
    sp = split_np(40 + mod_idx)
    rng = np.random.default_rng(41)
    mu = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in sp.items()}
    nu = {k: (1e-4 * rng.random(size=v.shape)).astype(np.float32)
          for k, v in sp.items()}
    xs, noise = present_np(mod_idx, B, 42, steps=n)
    want, jmet = jax_presence_epoch(sp, mu, nu, count, xs, noise, mod_idx)
    p, m, v = (bridge.flatten_split(t(d)) for d in (sp, mu, nu))
    metrics = fused_presence.presence_epoch_flat(
        p, m, v, count, torch.from_numpy(xs), torch.from_numpy(noise),
        dims(), fused_step.FusedConsts(*CONSTS), HYPER, True, mod_idx)
    assert metrics.shape == (n, fused_presence.n_presence_metrics(
        "joint_elbo"))
    close(metrics[:, 0], jmet[:, 0], rtol=LOSS_RTOL, atol=0)
    close(metrics, jmet)
    for got, ref in zip((p, m, v), want):
        views = bridge.flat_views(got, dims())
        for name in bridge.SPLIT_NAMES:
            close(views[name], ref[name], rtol=1e-5, atol=1e-6)


# ------------------------------------------------- the four methods, masks
METHOD_CONSTS = (1.3, 0.7, 1.2)  # beta, beta_style, beta_content
RATE = 0.2
OTHER = ("moe", "jsd", "poe")
CASES = [(m, False) for m in OTHER] + [
    (m, True) for m in ("joint_elbo",) + OTHER]


def method_np(method, masked, mod_idx, b, seed, steps=None):
    """``(x, noise, masks)`` of a presence step of ``method``; masks
    ``[(steps,) n_masks, b, hidden]`` of pre-scaled keep values, or None."""
    rng = np.random.default_rng(seed)
    lead = () if steps is None else (steps,)
    width = (CD + STYLE[mod_idx]) * (2 if method == "poe" else 1)
    x = rng.normal(size=lead + (b, DIMS[mod_idx])).astype(np.float32)
    noise = rng.normal(size=lead + (b, width)).astype(np.float32)
    masks = None
    if masked:
        n = fused_presence.n_presence_masks(method, RATE)
        keep = rng.random(size=lead + (n, b, HIDDEN)) < 1.0 - RATE
        masks = (keep / (1.0 - RATE)).astype(np.float32)
    return x, noise, masks


@pytest.mark.parametrize("b", [B, B_PARTIAL])
@pytest.mark.parametrize("learn_scale", [True, False])
@pytest.mark.parametrize("mod_idx", [0, 1])
@pytest.mark.parametrize("method,masked", CASES)
def test_method_reference_matches_jax_autodiff(method, masked, mod_idx,
                                               learn_scale, b):
    sp = split_np(40 + mod_idx)
    x, noise, masks = method_np(method, masked, mod_idx, b, 41 + b)
    jd = jax_fs.FusedDims(*dims(b))

    def loss_fn(p):
        return jax_fp.presence_loss_split(
            method, jd, jax_fs.FusedConsts(*METHOD_CONSTS), learn_scale,
            False, mod_idx, p, jnp.asarray(x), jnp.asarray(noise),
            dropout_masks=None if masks is None else tuple(
                jnp.asarray(m) for m in masks))

    (loss, metrics), want = jax.value_and_grad(loss_fn, has_aux=True)(j(sp))
    launches = dict(fused_presence.KERNEL_LAUNCHES)
    tmet, tg = fused_presence.presence_step_flat(
        bridge.flatten_split(t(sp)), torch.from_numpy(x),
        torch.from_numpy(noise), dims(b),
        fused_step.FusedConsts(*METHOD_CONSTS), learn_scale, mod_idx, method,
        None if masks is None else torch.from_numpy(masks))
    assert fused_presence.KERNEL_LAUNCHES == launches  # plain on the CPU
    assert tmet.shape == (fused_presence.n_presence_metrics(method),)
    close(tmet[0], loss, rtol=LOSS_RTOL, atol=0)
    close(tmet, np.stack([np.asarray(m) for m in metrics]))
    got = bridge.flat_views(tg, dims(b))
    absent = f"{2 - mod_idx}"
    for name in bridge.SPLIT_NAMES:
        close(got[name], want[name])
        if name[3] == absent:
            assert not got[name].any()


@pytest.mark.parametrize("mod_idx", [0, 1])
@pytest.mark.parametrize("method,masked", CASES)
def test_method_epoch_matches_jax_pallas_body(method, masked, mod_idx):
    sp = split_np(50 + mod_idx)
    rng = np.random.default_rng(51)
    mu = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in sp.items()}
    nu = {k: (1e-4 * rng.random(size=v.shape)).astype(np.float32)
          for k, v in sp.items()}
    xs, noise, masks = method_np(method, masked, mod_idx, B_PARTIAL, 52,
                                 steps=3)
    (jp, jmu, jnu), jmet = jax_presence_epoch(
        sp, mu, nu, 4, xs, noise, mod_idx, method, masks, METHOD_CONSTS)
    got = fused_presence.presence_epoch(
        t(sp), t(mu), t(nu), 4, torch.from_numpy(xs),
        torch.from_numpy(noise), dims(B_PARTIAL),
        fused_step.FusedConsts(*METHOD_CONSTS), HYPER, True, mod_idx, method,
        None if masks is None else torch.from_numpy(masks))
    close(got[3][:, 0], jmet[:, 0], rtol=LOSS_RTOL, atol=0)
    close(got[3], jmet)
    for k, want in enumerate((jp, jmu, jnu)):
        for name in bridge.SPLIT_NAMES:
            close(got[k][name], want[name], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mod_idx", [0, 1])
@pytest.mark.parametrize("method", ("joint_elbo",) + OTHER)
def test_plain_step_matches_general_autograd_step(method, mod_idx):
    """Without dropout the kernel path's plain step equals the port's
    general step (autograd of the model and ``total_loss``) on a batch
    with one modality, on the same noise."""
    from multivae_tpu_torch.train import train_step

    cfg = Config(method=method, input_dim=list(DIMS), class_dim=CD,
                 style_dim=list(STYLE), hidden_dim=HIDDEN,
                 beta=METHOD_CONSTS[0], beta_style=METHOD_CONSTS[1],
                 beta_content=METHOD_CONSTS[2]).derive()
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu")
    sp = t(split_np(60))
    bridge.load_flat_params(model, bridge.flatten_split(sp), dims(B_PARTIAL))
    x, noise, _ = method_np(method, False, mod_idx, B_PARTIAL, 61)
    x, noise = torch.from_numpy(x), torch.from_numpy(noise)
    batch = {model.mod_names[mod_idx]: x}
    assert noise.shape[1] == train_step.batch_noise_width(cfg, model, batch)
    model.zero_grad()
    loss, metrics = train_step.loss_and_metrics(cfg, model, batch, noise)
    loss.backward()
    d = dims(B_PARTIAL)
    want = bridge.flat_views(train_step.grads_flat(model, d), d)
    tloss, tmet, got = fused_presence.presence_fwd_bwd_reference(
        sp, x, noise, d, fused_step.consts_from(cfg), True, mod_idx, method)
    close(tloss, loss.detach(), rtol=LOSS_RTOL, atol=0)
    names = fused_presence.presence_metric_names(model, method, mod_idx)
    assert sorted(names) == sorted(metrics)
    close(tmet, torch.stack([metrics[n].detach() for n in names]))
    for name in bridge.SPLIT_NAMES:
        close(got[name], want[name])


def test_absent_half_takes_the_adam_decay():
    """The absent modality's params get zero gradients and still move as
    Adam's decay predicts (mu, nu shrink; a nonzero mu still moves p)."""
    sp = t(split_np(30))
    rng = np.random.default_rng(31)
    mu = {k: torch.from_numpy((0.01 * rng.normal(size=v.shape)).astype(
        np.float32)) for k, v in sp.items()}
    nu = {k: torch.from_numpy((1e-4 * rng.random(size=v.shape)).astype(
        np.float32)) for k, v in sp.items()}
    xs, noise = present_np(0, B, 32, steps=1)
    count = 9
    p2, mu2, nu2, _ = fused_presence.presence_epoch(
        sp, mu, nu, count, torch.from_numpy(xs), torch.from_numpy(noise),
        dims(), fused_step.FusedConsts(*CONSTS), HYPER, True, 0)
    lr, b1, b2, eps = HYPER
    tt = np.float32(count + 1)
    bc1 = np.float32(1) - np.exp(tt * np.float32(np.log(b1)))
    bc2 = np.float32(1) - np.exp(tt * np.float32(np.log(b2)))
    absent = [n for n in bridge.SPLIT_NAMES if n[3] == "2"]
    assert len(absent) == 14
    for name in absent:
        m_want = np.float32(b1) * mu[name].numpy()
        v_want = np.float32(b2) * nu[name].numpy()
        p_want = sp[name].numpy() - np.float32(lr) * (m_want / bc1) / (
            np.sqrt(v_want / bc2) + np.float32(eps))
        close(mu2[name], m_want, rtol=1e-6, atol=0)
        close(nu2[name], v_want, rtol=1e-6, atol=0)
        close(p2[name], p_want, rtol=1e-6, atol=1e-9)
        assert not torch.equal(p2[name], sp[name])


def test_names_width_and_support_match_jax():
    from multivae_tpu.models import build_model as jax_build
    from multivae_tpu.models import make_modalities as jax_mods

    for method in ("joint_elbo", "moe", "jsd", "poe"):
        cfg = Config(method=method, input_dim=list(DIMS), class_dim=CD,
                     style_dim=list(STYLE), hidden_dim=HIDDEN).derive()
        jm = jax_build(cfg, jax_mods(cfg.input_dim, cfg.style_dim,
                                     cfg.likelihood))
        tm = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                              cfg.likelihood), "cpu")
        for mod_idx, batch in ((0, {"clinical": None}), (1, {"rois": None})):
            assert (fused_presence.presence_metric_names(tm, method, mod_idx)
                    == jax_fp.presence_metric_names(jm, method, mod_idx))
            assert (fused_presence.presence_noise_width(cfg, mod_idx)
                    == jax_fp.presence_noise_width(cfg, mod_idx))
            assert (fused_presence.supports_presence_fused(cfg, tm, batch)
                    == jax_fp.supports_presence_fused(cfg, jm, batch))
        both = {"clinical": None, "rois": None}
        assert not fused_presence.supports_presence_fused(cfg, tm, both)


def test_presence_step_checks_mod_idx():
    with pytest.raises(ValueError, match="mod_idx"):
        fused_presence.presence_step_flat(
            torch.zeros(bridge.flat_size(dims())), None, None, dims(),
            fused_step.FusedConsts(*CONSTS), True, 2)


def test_presence_step_checks_method_and_mask_count():
    p = torch.zeros(bridge.flat_size(dims()))
    cs = fused_step.FusedConsts(*CONSTS)
    with pytest.raises(ValueError, match="unknown method"):
        fused_presence.presence_step_flat(p, None, None, dims(), cs, True, 0,
                                          "mopoe")
    x, noise, masks = method_np("poe", True, 0, B, 70)
    with pytest.raises(ValueError, match="dropout masks"):
        fused_presence.presence_step_flat(
            p, torch.from_numpy(x), torch.from_numpy(noise), dims(), cs,
            True, 0, "poe", torch.from_numpy(masks)[:1])
    assert fused_presence.PORTED_METHODS == jax_fp.METHODS
