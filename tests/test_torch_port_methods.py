"""The port's method step (moe, jsd, poe and joint_elbo with dropout masks
on complete batches) against the JAX package.

The port's plain version carries a hand-derived backward; the JAX package
gets its gradient from ``jax.value_and_grad`` of ``method_loss_split``
inside its Pallas kernel, which is the oracle here. The epoch runs the JAX
package's own Pallas body (``_method_epoch_kernel``) in interpret mode with
the port's noise and masks fed in (``build_method_epoch`` draws its own, so
the test builds the same ``pallas_call`` with them as inputs). Inputs come
from numpy seeds; ``beta_style != 1`` so the squared style factor shows;
the row counts 12 and 7 give 3-way bounds 4, 8 and 2, 4 and 2-way bounds 6
and 3 (7 is divisible by neither 2 nor 3). Tolerances: the loss at rtol
1e-5, metrics and grads at rtol 5e-4 / atol 1e-5 (float32, another
summation order), after a 3-step epoch params, mu and nu at rtol 1e-4 /
atol 1e-5.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from multivae_tpu.ops import fused_methods as jax_fm
from multivae_tpu.ops import fused_step as jax_fs
from multivae_tpu.train import Config
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.ops import adam as adam_ops
from multivae_tpu_torch.ops import fused_methods, fused_step
from multivae_tpu_torch.train import train_step

DIMS = (3, 12)
HIDDEN, CD, STYLE = 16, 4, (2, 3)
B, B_ODD = 12, 7
RTOL, ATOL = 5e-4, 1e-5
LOSS_RTOL = 1e-5
CONSTS = (1.3, 0.7, 1.2)  # beta, beta_style, beta_content
HYPER = adam_ops.AdamHyper(2e-3, 0.9, 0.999)
RATE = 0.2
METHODS = ("moe", "jsd", "poe")
# every method without masks, and with them (joint_elbo without masks is
# the MoPoE step's, held in test_torch_port_train_step.py)
CASES = [(m, False) for m in METHODS] + [
    (m, True) for m in ("joint_elbo",) + METHODS]


def dims(b=B):
    return bridge.FusedDims(b=b, d1=DIMS[0], d2=DIMS[1], h=HIDDEN, cd=CD,
                            s1=STYLE[0], s2=STYLE[1])


def noise_width(method):
    w = CD + sum(STYLE)
    return w + (2 * CD + sum(STYLE) if method == "poe" else 0)


def split_np(seed=0):
    rng = np.random.default_rng(seed)
    sp = {n: (0.3 * rng.normal(size=s)).astype(np.float32)
          for n, s in bridge.split_shapes(dims()).items()}
    sp["dec1_olv"] = np.full_like(sp["dec1_olv"], -1.0)
    sp["dec2_olv"] = np.full_like(sp["dec2_olv"], -0.5)
    return sp


def batch_np(method, masked, b, seed, steps=None):
    """``(x1, x2, noise, masks)``; masks ``[(steps,) n_masks, b, hidden]``
    of pre-scaled keep values, or None."""
    rng = np.random.default_rng(seed)
    lead = () if steps is None else (steps,)
    f = lambda *s: rng.normal(size=lead + s).astype(np.float32)
    x1, x2, noise = f(b, DIMS[0]), f(b, DIMS[1]), f(b, noise_width(method))
    masks = None
    if masked:
        n = fused_methods.n_dropout_masks(method, RATE)
        keep = rng.random(size=lead + (n, b, HIDDEN)) < 1.0 - RATE
        masks = (keep / (1.0 - RATE)).astype(np.float32)
    return x1, x2, noise, masks


def t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("b", [B, B_ODD])
@pytest.mark.parametrize("learn_scale", [True, False])
@pytest.mark.parametrize("method,masked", CASES)
def test_reference_matches_jax_autodiff(method, masked, learn_scale, b):
    sp = split_np(METHODS.index(method) if method in METHODS else 5)
    x1, x2, noise, masks = batch_np(method, masked, b, 10 + b)
    jd = jax_fs.FusedDims(*dims(b))

    def loss_fn(p):
        return jax_fm.method_loss_split(
            method, jd, jax_fs.FusedConsts(*CONSTS), learn_scale, False, p,
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(noise),
            dropout_masks=None if masks is None else tuple(
                jnp.asarray(m) for m in masks))

    (loss, metrics), want = jax.value_and_grad(loss_fn, has_aux=True)(j(sp))
    launches = dict(fused_methods.KERNEL_LAUNCHES)
    tmet, tg = fused_methods.method_step_flat(
        method, bridge.flatten_split(t(sp)), torch.from_numpy(x1),
        torch.from_numpy(x2), torch.from_numpy(noise), dims(b),
        fused_step.FusedConsts(*CONSTS), learn_scale,
        None if masks is None else torch.from_numpy(masks))
    assert fused_methods.KERNEL_LAUNCHES == launches  # plain on the CPU
    assert tmet.shape == (fused_methods.n_method_metrics(method),)
    close(tmet[0], loss, rtol=LOSS_RTOL, atol=0)
    close(tmet, np.stack([np.asarray(m) for m in metrics]))
    got = bridge.flat_views(tg, dims(b))
    for name in bridge.SPLIT_NAMES:
        close(got[name], want[name])
    if not learn_scale:
        assert not got["dec1_olv"].any() and not got["dec2_olv"].any()


def jax_method_epoch(method, sp, mu, nu, count, x1s, x2s, noise, masks):
    """``build_method_epoch``'s ``pallas_call`` with the noise and the
    masks as inputs."""
    n = len(jax_fs.SPLIT_NAMES)
    n_steps, b = x1s.shape[:2]
    jd = jax_fs.FusedDims(*dims(b))
    n_met = fused_methods.n_method_metrics(method)
    n_masks = 0 if masks is None else masks.shape[1]
    kernel = partial(jax_fm._method_epoch_kernel, method, jd,
                     jax_fs.FusedConsts(*CONSTS), True, False, tuple(HYPER),
                     n_met, n_masks)
    whole = pl.BlockSpec(memory_space=pltpu.VMEM)
    stream = lambda w: pl.BlockSpec((1, b, w), lambda i: (i, 0, 0))
    names = jax_fs.SPLIT_NAMES
    mask_grids = [jnp.asarray(masks[:, i]) for i in range(n_masks)]
    outs = pl.pallas_call(
        kernel, grid=(n_steps,),
        out_shape=([jax.ShapeDtypeStruct((n_steps, n_met), jnp.float32)]
                   + [jax.ShapeDtypeStruct(sp[nm].shape, jnp.float32)
                      for nm in names] * 3),
        in_specs=([stream(DIMS[0]), stream(DIMS[1]),
                   stream(noise.shape[2])] + [stream(HIDDEN)] * n_masks
                  + [pl.BlockSpec(memory_space=pltpu.SMEM)]
                  + [whole] * (3 * n)),
        out_specs=([pl.BlockSpec(memory_space=pltpu.SMEM)]
                   + [whole] * (3 * n)),
        interpret=True,
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",)),
    )(jnp.asarray(x1s), jnp.asarray(x2s), jnp.asarray(noise), *mask_grids,
      jnp.asarray(count, jnp.int32).reshape(1, 1),
      *[jnp.asarray(sp[nm]) for nm in names],
      *[jnp.asarray(mu[nm]) for nm in names],
      *[jnp.asarray(nu[nm]) for nm in names])
    return ([dict(zip(names, outs[1 + k * n:1 + (k + 1) * n]))
             for k in range(3)], outs[0])


def moments_np(sp, seed):
    rng = np.random.default_rng(seed)
    mu = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in sp.items()}
    nu = {k: (1e-4 * rng.random(size=v.shape)).astype(np.float32)
          for k, v in sp.items()}
    return mu, nu


@pytest.mark.parametrize("method,masked", CASES)
def test_epoch_matches_jax_pallas_body(method, masked):
    sp = split_np(20)
    mu, nu = moments_np(sp, 21)
    x1s, x2s, noise, masks = batch_np(method, masked, B_ODD, 22, steps=3)
    (jp, jmu, jnu), jmet = jax_method_epoch(method, sp, mu, nu, 4, x1s, x2s,
                                            noise, masks)
    got = fused_methods.method_epoch(
        method, t(sp), t(mu), t(nu), 4, torch.from_numpy(x1s),
        torch.from_numpy(x2s), torch.from_numpy(noise), dims(B_ODD),
        fused_step.FusedConsts(*CONSTS), HYPER, True,
        None if masks is None else torch.from_numpy(masks))
    close(got[3][:, 0], jmet[:, 0], rtol=LOSS_RTOL, atol=0)
    close(got[3], jmet)
    for k, want in enumerate((jp, jmu, jnu)):
        for name in bridge.SPLIT_NAMES:
            close(got[k][name], want[name], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b", [B, B_ODD])
@pytest.mark.parametrize("method", ("joint_elbo",) + METHODS)
def test_plain_step_matches_general_autograd_step(method, b):
    """Without dropout the kernel path's plain step equals the port's
    general step (autograd of the model and ``total_loss``) on the same
    noise."""
    cfg = Config(method=method, input_dim=list(DIMS), class_dim=CD,
                 style_dim=list(STYLE), hidden_dim=HIDDEN, beta=CONSTS[0],
                 beta_style=CONSTS[1], beta_content=CONSTS[2]).derive()
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu")
    sp = t(split_np(30))
    bridge.load_flat_params(model, bridge.flatten_split(sp), dims(b))
    x1, x2, noise, _ = map(
        lambda a: None if a is None else torch.from_numpy(a),
        batch_np(method, False, b, 31))
    batch = {"clinical": x1, "rois": x2}
    assert noise.shape[1] == train_step.batch_noise_width(cfg, model, batch)
    model.zero_grad()
    loss, metrics = train_step.loss_and_metrics(cfg, model, batch, noise)
    loss.backward()
    want = bridge.flat_views(train_step.grads_flat(model, dims(b)), dims(b))
    tloss, tmet, got = fused_methods.method_fwd_bwd_reference(
        method, sp, x1, x2, noise, dims(b), fused_step.consts_from(cfg),
        True)
    close(tloss, loss.detach(), rtol=LOSS_RTOL, atol=0)
    names = fused_methods.method_metric_names(model, method)
    assert sorted(names) == sorted(metrics)
    close(tmet, torch.stack([metrics[n].detach() for n in names]))
    for name in bridge.SPLIT_NAMES:
        close(got[name], want[name])


def test_ported_methods_and_mask_counts():
    assert fused_methods.PORTED_METHODS == jax_fm.METHODS
    for method in jax_fm.METHODS:
        assert fused_methods.n_dropout_masks(method, 0.0) == 0
        assert fused_methods.n_dropout_masks(method, RATE) == (
            4 if method == "poe" else 2)
        cfg = Config(method=method, input_dim=list(DIMS), class_dim=CD,
                     style_dim=list(STYLE), hidden_dim=HIDDEN).derive()
        assert noise_width(method) == jax_fm.noise_width(cfg)


@pytest.mark.parametrize("method", ("joint_elbo",) + METHODS)
def test_step_checks_the_mask_count(method):
    x1, x2, noise, masks = batch_np(method, True, B, 40)
    with pytest.raises(ValueError, match="dropout masks"):
        fused_methods.method_step_flat(
            method, bridge.flatten_split(t(split_np())),
            torch.from_numpy(x1), torch.from_numpy(x2),
            torch.from_numpy(noise), dims(), fused_step.FusedConsts(*CONSTS),
            True, torch.from_numpy(masks)[:1])


def test_step_has_no_kernel_for_other_devices():
    meta = torch.empty(bridge.flat_size(dims()), device="meta")
    x = torch.empty((B, 1), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_methods.method_step_flat("moe", meta, x, x, x, dims(),
                                       fused_step.FusedConsts(*CONSTS))
    with pytest.raises(ValueError, match="unknown method"):
        fused_methods.method_step_flat("mopoe", meta, x, x, x, dims(),
                                       fused_step.FusedConsts(*CONSTS))


def test_plain_versions_leave_the_tf32_flag_alone():
    """No plain version changes the process-wide TF32 setting; the scoped
    block sets full float32 and restores what it found."""
    from multivae_tpu_torch.ops import fused_presence

    flag = torch.backends.cuda.matmul
    saved = flag.allow_tf32
    try:
        flag.allow_tf32 = True
        sp = t(split_np())
        x1, x2, noise, _ = map(
            lambda a: None if a is None else torch.from_numpy(a),
            batch_np("moe", False, B, 50))
        cs = fused_step.FusedConsts(*CONSTS)
        fused_step.fwd_bwd_reference(sp, x1, x2, noise[:, :CD],
                                     noise[:, CD:CD + STYLE[0]],
                                     noise[:, CD + STYLE[0]:], dims(), cs)
        fused_methods.method_fwd_bwd_reference("moe", sp, x1, x2, noise,
                                               dims(), cs)
        fused_presence.presence_fwd_bwd_reference(sp, x1, noise, dims(), cs,
                                                  True, 0)
        assert flag.allow_tf32 is True
        with fused_step.full_f32_products():
            assert flag.allow_tf32 is False
        assert flag.allow_tf32 is True
    finally:
        flag.allow_tf32 = saved
