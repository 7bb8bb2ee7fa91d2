"""The port's model, fusion math and weights bridge against the JAX package,
on shared numpy inputs, weights and noise.

Tolerance: float32 on both sides with different summation orders; rtol
2e-5 / atol 1e-5 for the model, 1e-6 for the elementwise fusion math.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.models import build_model as jax_build_model
from multivae_tpu.models import make_modalities as jax_make_modalities
from multivae_tpu.ops import fused_step as jax_fused_step
from multivae_tpu.ops import fusion as jax_fusion
from multivae_tpu.train import Config
from multivae_tpu.train.train_step import init_params as jax_init_params
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.ops import fusion
from multivae_tpu_torch.train.checkpoint import (
    find_checkpoint,
    load_tree,
    restore_checkpoint,
    save_checkpoint,
    save_tree,
)

pytestmark = pytest.mark.driver  # cross-framework parity pins

B = 24
DIMS = (5, 18)
CD = 6
STYLE = (2, 4)
HIDDEN = 16
METHODS = ("joint_elbo", "moe", "jsd", "poe")
PATTERNS = (("clinical", "rois"), ("clinical",), ("rois",))
RTOL, ATOL = 2e-5, 1e-5


def make_cfg(method):
    return Config(method=method, input_dim=list(DIMS), class_dim=CD,
                  style_dim=list(STYLE), hidden_dim=HIDDEN,
                  num_hidden_layer_encoder=1, num_hidden_layer_decoder=0,
                  learn_output_scale=True, initial_out_logvar=-3.0).derive()


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"clinical": rng.normal(size=(B, DIMS[0])).astype(np.float32),
            "rois": rng.normal(size=(B, DIMS[1])).astype(np.float32)}


def jax_pair(method, seed=3):
    """JAX model + params, and the port's model carrying the same weights."""
    cfg = make_cfg(method)
    mods = jax_make_modalities(cfg.input_dim, cfg.style_dim, cfg.likelihood)
    jmodel = jax_build_model(cfg, mods)
    batch = make_batch(seed)
    params = jax_init_params(cfg, jmodel,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             seed=seed)
    tmodel = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                              cfg.likelihood), "cpu")
    tmodel.load_state_dict(bridge.tree_to_state_dict(jax.device_get(params)))
    return cfg, jmodel, params, tmodel


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def assert_close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=rtol, atol=atol)


def sub_batch(pattern, seed=1):
    batch = make_batch(seed)
    return ({k: jnp.asarray(batch[k]) for k in pattern},
            {k: torch.from_numpy(batch[k]) for k in pattern})


# ---------------------------------------------------------------- bridge
def test_params_bridge_roundtrips_exactly(tmp_path):
    _, _, params, tmodel = jax_pair("joint_elbo")
    tree = jax.device_get(params)
    sd = bridge.tree_to_state_dict(tree)
    assert set(sd) == set(tmodel.state_dict())
    assert sd["enc_rois.heads.weight"].shape == (2 * CD + 2 * STYLE[1],
                                                 HIDDEN)
    back = bridge.flatten_tree(bridge.state_dict_to_tree(sd))
    flat = bridge.flatten_tree(tree)
    assert set(back) == set(flat)
    for key, val in flat.items():
        np.testing.assert_array_equal(back[key], np.asarray(val))
    # and through a checkpoint on disk
    save_tree(str(tmp_path / "0005"), tree)
    save_checkpoint(str(tmp_path / "0010"), tmodel)
    path, epoch = find_checkpoint(str(tmp_path))
    assert epoch == 10
    for key, val in bridge.flatten_tree(load_tree(path)).items():
        np.testing.assert_array_equal(val, np.asarray(flat[key]))
    path5, epoch5 = find_checkpoint(str(tmp_path), load_epoch=7)
    assert epoch5 == 5
    fresh = build_model(make_cfg("joint_elbo"), make_modalities(
        list(DIMS), list(STYLE), "normal"), "cpu", seed=99)
    restore_checkpoint(path5, fresh)
    for key, val in fresh.state_dict().items():
        torch.testing.assert_close(val, sd[key], rtol=0, atol=0)


def test_split_layout_matches_jax():
    cfg, jmodel, params, tmodel = jax_pair("joint_elbo")
    dims = bridge.dims_from(cfg, B)
    jsp = jax_fused_step.split_params(
        jax_fused_step.flatten_params(params, jmodel), dims)
    tsp = bridge.model_split_params(tmodel, dims)
    assert tuple(tsp) == bridge.SPLIT_NAMES == jax_fused_step.SPLIT_NAMES
    assert bridge.FLAT_NAMES == jax_fused_step.FLAT_NAMES
    for name in bridge.SPLIT_NAMES:
        np.testing.assert_array_equal(to_np(tsp[name]), np.asarray(jsp[name]))
        assert tsp[name].is_contiguous()
    packed = bridge.join_params(tsp, dims)
    for name in bridge.FLAT_NAMES:
        np.testing.assert_array_equal(
            to_np(packed[name]),
            np.asarray(jax_fused_step.flatten_params(params, jmodel)[name]))


def test_init_law_follows_torch_linear():
    cfg = make_cfg("joint_elbo")
    mods = make_modalities(cfg.input_dim, cfg.style_dim, cfg.likelihood)
    m1 = build_model(cfg, mods, "cpu", seed=5)
    m2 = build_model(cfg, mods, "cpu", seed=5)
    m3 = build_model(cfg, mods, "cpu", seed=6)
    for name, p in m1.named_parameters():
        torch.testing.assert_close(p, m2.state_dict()[name], rtol=0, atol=0)
        if name.endswith("out_logvar"):
            assert torch.all(p == -3.0)
            continue
        fan_in = (p.shape[1] if p.dim() == 2
                  else m1.get_submodule(name.rsplit(".", 1)[0]).in_features)
        assert p.abs().max() <= 1.0 / np.sqrt(fan_in)
        assert not torch.equal(p, m3.state_dict()[name])


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("method", METHODS)
def test_encode_matches(method):
    _, jmodel, params, tmodel = jax_pair(method)
    jb, tb = sub_batch(("clinical", "rois"))
    jl = jmodel.apply({"params": params}, jb, method="encode")
    with torch.no_grad():
        tl = tmodel.encode(tb)
    assert set(jl) == set(tl)
    for key in jl:
        for a, b in zip(jl[key], tl[key]):
            assert_close(b, a)


@pytest.mark.parametrize("pattern", PATTERNS, ids="+".join)
@pytest.mark.parametrize("method", METHODS)
def test_inference_matches(method, pattern):
    _, jmodel, params, tmodel = jax_pair(method)
    jb, tb = sub_batch(pattern)
    for sample in (True, False):
        jl = jmodel.apply({"params": params}, jb, sample=sample,
                          method="inference")
        with torch.no_grad():
            tl = tmodel.inference(tb, sample=sample)
        assert_close(tl["mus"], jl["mus"])
        assert_close(tl["logvars"], jl["logvars"])
        np.testing.assert_allclose(tl["weights"], np.asarray(jl["weights"]))
        for a, b in zip(jl["joint"], tl["joint"]):
            assert_close(b, a)
        assert set(jl["subsets"]) == set(tl["subsets"])
        for key in jl["subsets"]:
            for a, b in zip(jl["subsets"][key], tl["subsets"][key]):
                assert_close(b, a)


@pytest.mark.parametrize("pattern", PATTERNS, ids="+".join)
@pytest.mark.parametrize("method", METHODS)
def test_forward_with_noise_matches(method, pattern):
    _, jmodel, params, tmodel = jax_pair(method)
    jb, tb = sub_batch(pattern)
    width = tmodel.noise_width(pattern)
    assert width == jmodel.noise_width(pattern)
    noise = np.random.default_rng(7).normal(size=(B, width)).astype(
        np.float32)
    for sample in (True, False):
        jo = jmodel.apply({"params": params}, jb, sample_latents=sample,
                          noise=jnp.asarray(noise))
        with torch.no_grad():
            to = tmodel(tb, sample_latents=sample,
                        noise=torch.from_numpy(noise))
        assert set(jo["rec"]) == set(to["rec"]) == set(pattern)
        for mod in pattern:
            for a, b in zip(jo["rec"][mod], to["rec"][mod]):
                assert_close(b, a)
        assert_close(to["joint_divergence"], jo["joint_divergence"])
        assert_close(to["individual_divs"], jo["individual_divs"])
        if method == "jsd":
            for a, b in zip(jo["dyn_prior"], to["dyn_prior"]):
                assert_close(b, a)


def test_forward_draws_noise_from_generator():
    _, _, _, tmodel = jax_pair("joint_elbo")
    _, tb = sub_batch(("clinical", "rois"))
    with torch.no_grad():
        a = tmodel(tb, generator=torch.Generator().manual_seed(1))
        b = tmodel(tb, generator=torch.Generator().manual_seed(1))
        c = tmodel(tb, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a["rec"]["rois"][0], b["rec"]["rois"][0],
                               rtol=0, atol=0)
    assert not torch.equal(a["rec"]["rois"][0], c["rec"]["rois"][0])


# ---------------------------------------------------------------- fusion
def _experts(k=3, b=7, d=5, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(k, b, d)).astype(np.float32),
            rng.normal(size=(k, b, d)).astype(np.float32))


def _both(fn_j, fn_t, *arrays, **kw):
    return (fn_j(*[jnp.asarray(a) for a in arrays], **kw),
            fn_t(*[torch.from_numpy(a) for a in arrays], **kw))


def _assert_tree_close(a, b, tol=1e-6):
    if isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _assert_tree_close(x, y, tol)
    else:
        np.testing.assert_allclose(to_np(b), np.asarray(a), rtol=tol,
                                   atol=tol)


def test_poe_and_alpha_poe_match():
    mus, lvs = _experts()
    _assert_tree_close(*_both(jax_fusion.poe, fusion.poe, mus, lvs))
    alpha = np.array([0.2, 0.5, 0.3], np.float32)
    j = jax_fusion.alpha_poe(alpha, jnp.asarray(mus), jnp.asarray(lvs))
    t = fusion.alpha_poe(alpha, torch.from_numpy(mus), torch.from_numpy(lvs))
    _assert_tree_close(j, t)


@pytest.mark.parametrize("n_subsets", [3, 20])
def test_masked_poe_all_subsets_matches(n_subsets):
    """3 rows take the unrolled branch, 20 the einsum branch."""
    mus, lvs = _experts(k=4)
    rng = np.random.default_rng(n_subsets)
    mask = (rng.random((n_subsets, 4)) < 0.6).astype(np.float32)
    mask[:, 0] = 1.0  # every subset holds at least one expert
    prior = (rng.random(n_subsets) < 0.5).astype(np.float32)
    j = jax_fusion.masked_poe_all_subsets(jnp.asarray(mus), jnp.asarray(lvs),
                                          mask, prior)
    t = fusion.masked_poe_all_subsets(torch.from_numpy(mus),
                                      torch.from_numpy(lvs), mask, prior)
    _assert_tree_close(j, t)


@pytest.mark.parametrize("k,b", [(2, 24), (3, 24), (3, 25), (4, 7)])
def test_mixture_partition_and_selection_match(k, b):
    np.testing.assert_array_equal(fusion.mixture_partition(k, b),
                                  jax_fusion.mixture_partition(k, b))
    mus, lvs = _experts(k=k, b=b)
    _assert_tree_close(*_both(jax_fusion.mixture_component_selection,
                              fusion.mixture_component_selection, mus, lvs))


@pytest.mark.parametrize("normalization", [None, 7])
def test_group_divergences_match(normalization):
    mus, lvs = _experts()
    w = np.array([0.25, 0.25, 0.5], np.float32)
    j = jax_fusion.group_divergence_moe(jnp.asarray(mus), jnp.asarray(lvs),
                                        w, normalization=normalization)
    t = fusion.group_divergence_moe(torch.from_numpy(mus),
                                    torch.from_numpy(lvs), w,
                                    normalization=normalization)
    _assert_tree_close(j, t, tol=1e-5)
    j = jax_fusion.alpha_jsd_divergence(jnp.asarray(mus), jnp.asarray(lvs),
                                        w, normalization=normalization)
    t = fusion.alpha_jsd_divergence(torch.from_numpy(mus),
                                    torch.from_numpy(lvs), w,
                                    normalization=normalization)
    _assert_tree_close(j, t, tol=1e-5)
    np.testing.assert_allclose(fusion.reweight_weights([1.0, 3.0]),
                               jax_fusion.reweight_weights([1.0, 3.0]))


# ------------------------------------------------------------ dropout masks
def deep_pair(n_enc, n_dec, sample, rate, seed=5):
    """JAX model + params of a deep architecture with dropout, and the
    port's model carrying the same weights."""
    cfg = Config(method="joint_elbo", input_dim=list(DIMS), class_dim=CD,
                 style_dim=list(STYLE), hidden_dim=HIDDEN,
                 num_hidden_layer_encoder=n_enc,
                 num_hidden_layer_decoder=n_dec, dropout_rate=rate,
                 learn_output_sample_scale=sample).derive()
    jmodel = jax_build_model(cfg, jax_make_modalities(
        cfg.input_dim, cfg.style_dim, cfg.likelihood))
    batch = make_batch(seed)
    params = jax_init_params(cfg, jmodel,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             seed=seed)
    tmodel = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                              cfg.likelihood), "cpu")
    tmodel.load_state_dict(bridge.tree_to_state_dict(jax.device_get(params)))
    return cfg, jmodel, params, tmodel


@pytest.mark.parametrize("n_enc,n_dec,sample", [(1, 1, True), (2, 1, False),
                                                (3, 2, False)])
def test_masked_encoder_and_decoder_forward_match_flax_dropout(n_enc, n_dec,
                                                               sample):
    """The port's ``Encoder`` / ``Decoder`` take their dropout as explicit
    keep masks after each hidden layer's ReLU, where flax's ``nn.Dropout``
    sits: fed flax's own masks (read off ``capture_intermediates`` as
    ``dropout_out / relu_out`` where the ReLU is positive, elsewhere the
    mask does not matter) they give flax's outputs."""
    rate = 0.3
    cfg, jmodel, params, tmodel = deep_pair(n_enc, n_dec, sample, rate)
    jb, tb = sub_batch(("clinical", "rois"))
    rng = np.random.default_rng(9)
    noise = rng.normal(size=(B, CD + sum(STYLE))).astype(np.float32)
    out, state = jmodel.apply(
        {"params": params}, jb, train=True, noise=jnp.asarray(noise),
        rngs={"dropout": jax.random.PRNGKey(4)}, capture_intermediates=True,
        mutable=["intermediates"])
    masks = {}
    for mod in ("clinical", "rois"):
        per_net = []
        for net, depth in ((f"enc_{mod}", n_enc), (f"dec_{mod}", n_dec)):
            inter = state["intermediates"][net]
            layer_masks = []
            for i in range(depth):
                act = np.maximum(np.asarray(
                    inter[f"hidden_{i}"]["__call__"][0]), 0.0)
                dropped = np.asarray(inter[f"Dropout_{i}"]["__call__"][0])
                mask = np.where(act > 0, dropped / np.where(act > 0, act, 1),
                                0.0).astype(np.float32)
                assert np.isclose(mask[act > 0][:, None],
                                  [0.0, 1 / (1 - rate)]).any(1).all()
                layer_masks.append(torch.from_numpy(mask))
            per_net.append(layer_masks)
        masks[mod] = tuple(per_net)
    with torch.no_grad():
        got = tmodel(tb, noise=torch.from_numpy(noise), masks=masks)
        plain = tmodel(tb, noise=torch.from_numpy(noise))
    for mod in ("clinical", "rois"):
        for k in range(2):
            assert_close(got["rec"][mod][k], out["rec"][mod][k], rtol=1e-4)
            assert_close(got["latents"]["modalities"][mod][k],
                         out["latents"]["modalities"][mod][k], rtol=1e-4)
        # the masks change the pass
        assert not torch.allclose(got["rec"][mod][0], plain["rec"][mod][0])
    # the encoder alone, and the wrong number of masks
    enc = tmodel.encoders["rois"]
    heads = enc(tb["rois"], masks["rois"][0])
    assert_close(heads[2], out["latents"]["modalities"]["rois"][0],
                 rtol=1e-4)
    with pytest.raises(ValueError, match="dropout masks"):
        enc(tb["rois"], masks["rois"][0] + [masks["rois"][0][0]])


def test_no_masks_is_the_inference_pass():
    cfg, jmodel, params, tmodel = deep_pair(2, 1, True, 0.5)
    jb, tb = sub_batch(("clinical", "rois"))
    want = jmodel.apply({"params": params}, jb, train=False,
                        sample_latents=False)
    with torch.no_grad():
        got = tmodel(tb, sample_latents=False)
    for mod in ("clinical", "rois"):
        for k in range(2):
            assert_close(got["rec"][mod][k], want["rec"][mod][k], rtol=1e-4)
    assert not any(isinstance(m, torch.nn.Dropout)
                   for m in tmodel.modules())
