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
# the CUDA kernel's 32-row tile (23 * 24 = 552 rows)
N_SAMPLES, N_SCORES = 23, 1
RTOL, ATOL = 2e-4, 1e-5
# the odd shape the card check also holds the kernel to: B=37 and 3 cells,
# 111 rows, a multiple of no tile (4, 8, 16 or 32 rows)
ODD_B, ODD_CELLS = 37, 3


def make_cfg(method):
    return Config(method=method, input_dim=list(DIMS), class_dim=CD,
                  style_dim=list(STYLE), hidden_dim=HIDDEN,
                  num_hidden_layer_encoder=1, num_hidden_layer_decoder=0,
                  learn_output_scale=True).derive()


def setup(method, seed=2, b=B):
    rng = np.random.default_rng(seed)
    cfg = make_cfg(method)
    data = {"clinical": rng.normal(size=(b, DIMS[0])).astype(np.float32),
            "rois": rng.normal(size=(b, DIMS[1])).astype(np.float32)}
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


def sweep_cases():
    """(method, sample_latents, B, n_cells): every method and branch at
    B=24 x 23 cells, then at the odd shape (ids with ``-B37``)."""
    cases = []
    for b, n_cells, tag in ((B, N_SAMPLES * N_SCORES, ""),
                            (ODD_B, ODD_CELLS, f"-B{ODD_B}")):
        for method in METHODS:
            for sample, name in ((True, "sampled"),
                                 (False, "deterministic")):
                cases.append(pytest.param(method, sample, b, n_cells,
                                          id=f"{method}-{name}{tag}"))
    return cases


@pytest.mark.parametrize("method,sample_latents,b,n_cells", sweep_cases())
def test_sweep_cells_matches_jax_kernel(method, sample_latents, b, n_cells):
    cfg, data, jmodel, params, tmodel, rng = setup(method, b=b)
    dims = bridge.dims_from(cfg, b)
    cdata = rng.normal(size=(n_cells, b, DIMS[0])).astype(np.float32)
    eps = rng.normal(size=(n_cells, b, CD + STYLE[1])).astype(np.float32)
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
    assert got.shape == (n_cells, b, DIMS[1])
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


# ------------------------------------------------------- the kernel's plan
# The CUDA kernel's plan is pure Python (the kernel runs only on the card):
# shared memory per block, resident or chunked weights, tile rows and the
# heads' K splits, which set the order of every sum.
MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use
PLAN_WIDTHS = [(d1, h, cd, s2, d2) for d1 in (3, 7) for h in (16, 256, 1024)
               for cd in (4, 20) for s2 in (4, 20) for d2 in (12, 444, 4096)]


def plan_dims(d1, h, cd, s2, d2, b=50):
    return bridge.FusedDims(b=b, d1=d1, d2=d2, h=h, cd=cd, s1=3, s2=s2)


def tile_per_block_smem(d1, h, cd, s2):
    """Shared memory of the tile-per-block sweep kernel (16 rows a block,
    x | h | heads | latents), which took every width up to this limit."""
    return 16 * (d1 + h + 2 * cd + s2 + cd) * 4


@pytest.mark.parametrize("d1,h,cd,s2,d2", PLAN_WIDTHS,
                         ids=[f"{d1}-{h}-{cd}-{s2}-{d2}"
                              for d1, h, cd, s2, d2 in PLAN_WIDTHS])
def test_sweep_plan_fits_shared_memory(d1, h, cd, s2, d2):
    dims = plan_dims(d1, h, cd, s2, d2)
    plan = fused_daa.sweep_plan(dims, 132, 70000)
    assert plan.smem <= MAX_SMEM
    assert plan.rows in fused_daa.SWEEP_ROWS and plan.split >= 1
    assert plan.grid == 132
    # resident whenever the weights fit whole beside a tile of 16 rows or
    # more, with the widest such tile
    fits = [r for r in fused_daa.SWEEP_ROWS if r >= 16 and 4 * (
        fused_daa._sweep_floats(dims, r, 1, True)) <= MAX_SMEM]
    if fits:
        assert plan.resident and plan.rows == fits[0]
    if (cd, s2) == (20, 20) and (h == 1024 or d2 == 4096):
        assert not plan.resident   # the wide widths at the flagship latents
    if not plan.resident:
        assert plan.h_chunk % 4 == 0 and 4 <= plan.h_chunk <= h + 3
        assert 1 <= plan.k_chunk <= h
        assert plan.n_chunk % 4 == 0 and 4 <= plan.n_chunk <= d2 + 3
    # the order of the sums depends on the widths alone: not on the grid,
    # the row count or the slice of cells a launch takes
    for n_sms, n_rows in ((7, 70000), (132, 17500), (132, 111), (1, 5)):
        other = fused_daa.sweep_plan(dims, n_sms, n_rows)
        assert other._replace(grid=0) == plan._replace(grid=0)


def test_sweep_plan_of_the_flagship():
    plan = fused_daa.sweep_plan(plan_dims(7, 256, 20, 20, 444), 132, 70000)
    assert plan == fused_daa.SweepPlan(rows=32, split=6, resident=True,
                                       h_chunk=0, k_chunk=0, n_chunk=0,
                                       grid=132, smem=197648)
    # fewer tiles than SMs: one block a tile
    assert fused_daa.sweep_plan(plan_dims(7, 256, 20, 20, 444, b=37), 132,
                                111).grid == 4
    wide = fused_daa.sweep_plan(plan_dims(7, 1024, 20, 20, 444), 132, 70000)
    assert not wide.resident and wide.smem <= MAX_SMEM


# the widest of each width the tile-per-block kernel took, the others at 1
# or at the flagship's; and decoders far wider than any SM's memory
EDGE_WIDTHS = [(3627, 1, 1, 1, 444), (1, 3627, 1, 1, 444),
               (1, 1, 1209, 1, 444), (1, 1, 1, 3627, 444),
               (7, 256, 20, 20, 1_000_003), (7, 3000, 20, 20, 100_000),
               (7, 256, 1100, 20, 444)]


@pytest.mark.parametrize("widths", EDGE_WIDTHS,
                         ids=["-".join(map(str, w)) for w in EDGE_WIDTHS])
def test_sweep_plan_takes_every_width_the_old_kernel_took(widths):
    d1, h, cd, s2, d2 = widths
    assert tile_per_block_smem(d1, h, cd, s2) <= MAX_SMEM
    plan = fused_daa.sweep_plan(plan_dims(*widths), 132, 70000)
    assert plan.smem <= MAX_SMEM


def test_sweep_plan_takes_random_widths_the_old_kernel_took():
    rng = np.random.default_rng(9)
    taken = 0
    while taken < 400:
        d1, h, cd, s2 = (int(x) for x in np.exp(rng.uniform(0, 8.2, 4)))
        d2 = int(np.exp(rng.uniform(0, 12)))
        if tile_per_block_smem(d1, h, cd, s2) > MAX_SMEM:
            continue
        taken += 1
        plan = fused_daa.sweep_plan(plan_dims(d1, h, cd, s2, d2), 132, 1000)
        assert plan.smem <= MAX_SMEM, (d1, h, cd, s2, d2, plan)


def test_sweep_plan_refuses_what_fits_no_block():
    with pytest.raises(ValueError, match="no tile"):
        fused_daa.sweep_plan(plan_dims(100_000, 256, 20, 20, 444), 132, 10)
