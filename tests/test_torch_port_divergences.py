"""The port's auxiliary divergences (``multivae_tpu_torch.ops.
divergences_extra``) against the JAX package's (``multivae_tpu/ops/
divergences_extra.py``) on the same seeded numpy inputs, float32, at
rtol 1e-5 / atol 1e-6 (another order of the same sums); the autograd
gradient of the two-modality JSD against ``jax.grad`` at rtol 1e-4 /
atol 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu import ops as jops
from multivae_tpu_torch import ops

pytestmark = pytest.mark.driver  # cross-framework parity pins

B, D = 12, 5
ALPHA = [0.2, 0.5, 0.3]


def inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda scale: (scale * rng.normal(size=(B, D))).astype(np.float32)
    return f(1.0), f(0.5), f(1.0), f(0.5)


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def both(fn, *args, **kw):
    """``fn`` of the port on torch tensors and of the JAX package on jnp
    arrays, numpy arrays passed to both."""
    conv = lambda f: [f(a) if isinstance(a, np.ndarray) else a
                      for a in args]
    got = getattr(ops, fn)(*conv(torch.from_numpy), **kw)
    want = getattr(jops, fn)(*conv(jnp.asarray), **kw)
    return got, want


@pytest.mark.parametrize("norm", [None, B])
@pytest.mark.parametrize("pair", [False, True])
def test_gaussian_scaling_factors(pair, norm):
    mu1, lv1, mu2, lv2 = inputs(1)
    args = (mu1, lv1, mu2, lv2) if pair else (mu1, lv1)
    close(*both("gaussian_scaling_factor", *args, norm_value=norm))
    close(*both("gaussian_scaling_factor_self", lv1, norm_value=norm))


@pytest.mark.parametrize("bound", ["lb", "ub"])
@pytest.mark.parametrize("index", [0, 1])
def test_mixture_kl_bounds(bound, index):
    mu1, lv1, mu2, lv2 = inputs(2)
    fn = f"kl_divergence_{bound}_gauss_mixture"
    extra = (np.float32(0.7),) if bound == "ub" else ()
    got = getattr(ops, fn)(
        ALPHA, index, torch.from_numpy(mu1), torch.from_numpy(lv1),
        [torch.from_numpy(mu1), torch.from_numpy(mu2)],
        [torch.from_numpy(lv1), torch.from_numpy(lv2)], *extra,
        norm_value=B)
    want = getattr(jops, fn)(
        ALPHA, index, jnp.asarray(mu1), jnp.asarray(lv1),
        [jnp.asarray(mu1), jnp.asarray(mu2)],
        [jnp.asarray(lv1), jnp.asarray(lv2)], *extra, norm_value=B)
    close(got, want)


def test_alpha_jsd_modalities_mixture_and_its_gradient():
    mu1, lv1, mu2, lv2 = inputs(3)
    got, want = both("alpha_jsd_modalities_mixture", mu1, lv1, mu2, lv2,
                     ALPHA, B)
    for g, w in zip(got, want):
        close(g, w)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (mu1, lv1, mu2, lv2)]
    ops.alpha_jsd_modalities_mixture(*leaves, ALPHA, B)[0].backward()
    grads = jax.grad(lambda *a: jops.alpha_jsd_modalities_mixture(
        *a, ALPHA, B)[0], argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, (mu1, lv1, mu2, lv2)))
    for t, g in zip(leaves, grads):
        close(t.grad, g, rtol=1e-4)


@pytest.mark.parametrize("poe", [False, True])
def test_modality_divergence(poe):
    got, want = both("modality_divergence", *inputs(4), modality_poe=poe)
    for g, w in zip(np.atleast_1d(got) if poe else got,
                    np.atleast_1d(want) if poe else want):
        close(g, w)


@pytest.mark.parametrize("exclude_diag", [True, False])
def test_im_kernel_sum_and_mmd(exclude_diag):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(B, D)).astype(np.float32)
    b = (rng.normal(size=(B, D)) + 0.5).astype(np.float32)
    close(*both("im_kernel_sum", a, b, 0.7, exclude_diag=exclude_diag))
    close(*both("mmd_loss", a, b, 1.3))
