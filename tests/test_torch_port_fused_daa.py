"""The port's avatar sweep against the JAX package's Pallas kernel.

On the CPU the port's ``sweep_cells`` runs its plain PyTorch version; the
JAX kernel runs in interpret mode, as its own tests run it. Both get the
same weights, posteriors, perturbed cells and noise. Tolerance atol 1e-5 /
rtol 2e-4 (float32, different summation order; the JAX package's own
fused-vs-general tolerance). The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.models import build_model as jax_build_model
from multivae_tpu.models import make_modalities as jax_make_modalities
from multivae_tpu.ops import fused_daa as jax_daa
from multivae_tpu.ops.fused_step import flatten_params, split_params
from multivae_tpu.train import Config
from multivae_tpu.train.train_step import init_params as jax_init_params
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.ops import fused_daa

pytestmark = pytest.mark.driver  # cross-framework parity pins

B = 24
DIMS = (5, 18)
CD = 6
STYLE = (2, 4)
HIDDEN = 16
METHODS = ("joint_elbo", "moe", "jsd", "poe")
# 23 cells: not a multiple of the JAX kernel's 21-cell pack at B=24, nor of
# the CUDA kernel's 16-row tile (23 * 24 = 552 rows)
N_SAMPLES, N_SCORES = 23, 1
RTOL, ATOL = 2e-4, 1e-5


def make_cfg(method):
    return Config(method=method, input_dim=list(DIMS), class_dim=CD,
                  style_dim=list(STYLE), hidden_dim=HIDDEN,
                  num_hidden_layer_encoder=1, num_hidden_layer_decoder=0,
                  learn_output_scale=True).derive()


def setup(method, seed=2):
    rng = np.random.default_rng(seed)
    cfg = make_cfg(method)
    data = {"clinical": rng.normal(size=(B, DIMS[0])).astype(np.float32),
            "rois": rng.normal(size=(B, DIMS[1])).astype(np.float32)}
    jmodel = jax_build_model(cfg, jax_make_modalities(
        cfg.input_dim, cfg.style_dim, cfg.likelihood))
    params = jax_init_params(cfg, jmodel,
                             {k: jnp.asarray(v) for k, v in data.items()},
                             seed=seed)
    tmodel = build_model(cfg, make_modalities(
        cfg.input_dim, cfg.style_dim, cfg.likelihood), "cpu")
    tmodel.load_state_dict(bridge.tree_to_state_dict(jax.device_get(params)))
    return cfg, data, jmodel, params, tmodel, rng


def jdata(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def tdata(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


def test_supports_fused_sweep_matches_jax():
    for method in METHODS:
        cfg, data, jmodel, _, tmodel, _ = setup(method)
        assert fused_daa.supports_fused_sweep(cfg, tmodel, data)
        assert jax_daa.supports_fused_sweep(cfg, jmodel, data)
        assert not fused_daa.supports_fused_sweep(
            cfg, tmodel, {"clinical": data["clinical"]})


def test_build_cell_grid_matches():
    rng = np.random.default_rng(0)
    clinical = rng.normal(size=(B, DIMS[0])).astype(np.float32)
    scores = rng.normal(size=(4, B, DIMS[0])).astype(np.float32)
    j = jax_daa.build_cell_grid(jnp.asarray(clinical), jnp.asarray(scores))
    t = fused_daa.build_cell_grid(torch.from_numpy(clinical),
                                  torch.from_numpy(scores))
    assert t.shape == (4 * DIMS[0], B, DIMS[0])
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_rois_posteriors_match():
    _, data, jmodel, params, tmodel, _ = setup("joint_elbo")
    j = jax_daa.rois_posteriors(jmodel, params, jnp.asarray(data["rois"]))
    t = fused_daa.rois_posteriors(tmodel, torch.from_numpy(data["rois"]))
    for a, b in zip(j, t):
        assert b.is_contiguous()
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("sample_latents", [True, False],
                         ids=["sampled", "deterministic"])
@pytest.mark.parametrize("method", METHODS)
def test_sweep_cells_matches_jax_kernel(method, sample_latents):
    cfg, data, jmodel, params, tmodel, rng = setup(method)
    dims = bridge.dims_from(cfg, B)
    n_cells = N_SAMPLES * N_SCORES
    cdata = rng.normal(size=(n_cells, B, DIMS[0])).astype(np.float32)
    eps = rng.normal(size=(n_cells, B, CD + STYLE[1])).astype(np.float32)
    jsp = split_params(flatten_params(params, jmodel), dims)
    jpost = jax_daa.rois_posteriors(jmodel, params,
                                    jnp.asarray(data["rois"]))
    want = jax_daa.sweep_cells(jsp, jpost, jnp.asarray(cdata),
                               jnp.asarray(eps), dims, sample_latents,
                               interpret=True, method=method)
    launches = dict(fused_daa.KERNEL_LAUNCHES)
    got = fused_daa.sweep_cells(
        bridge.model_split_params(tmodel, dims),
        fused_daa.rois_posteriors(tmodel, torch.from_numpy(data["rois"])),
        torch.from_numpy(cdata), torch.from_numpy(eps), dims,
        sample_latents, method=method)
    # the CPU path is the plain version: no kernel launch is counted
    assert fused_daa.KERNEL_LAUNCHES == launches
    assert got.shape == (n_cells, B, DIMS[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("method", METHODS)
def test_fused_avatar_sweep_layout_matches(method):
    """Deterministic sweep end to end: cell grid, posteriors, kernel and the
    ``[B, n_scores, n_samples, R]`` relayout."""
    cfg, data, jmodel, params, tmodel, rng = setup(method)
    scores = rng.normal(size=(3, B, DIMS[0])).astype(np.float32)
    want = jax_daa.fused_avatar_sweep(jmodel, params, jdata(data),
                                      jnp.asarray(scores), False,
                                      jax.random.PRNGKey(0), cfg,
                                      interpret=True)
    got = fused_daa.fused_avatar_sweep(tmodel, tdata(data),
                                       torch.from_numpy(scores), False,
                                       torch.Generator(), cfg)
    assert got.shape == (B, DIMS[0], 3, DIMS[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_sampled_sweep_draws_from_generator():
    cfg, data, _, _, tmodel, rng = setup("joint_elbo")
    scores = torch.from_numpy(
        rng.normal(size=(2, B, DIMS[0])).astype(np.float32))
    runs = [fused_daa.fused_avatar_sweep(
        tmodel, tdata(data), scores, True,
        torch.Generator().manual_seed(s), cfg) for s in (4, 4, 5)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])


def test_sweep_cells_has_no_kernel_for_other_devices():
    cfg, data, _, _, tmodel, _ = setup("joint_elbo")
    dims = bridge.dims_from(cfg, B)
    meta = torch.empty((2, B, DIMS[0]), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_daa.sweep_cells(bridge.model_split_params(tmodel, dims),
                              (None,) * 4, meta, meta, dims, True)
