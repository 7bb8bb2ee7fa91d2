"""The port's layer-stack step (architectures outside the split layout)
against the JAX package.

The JAX package's generic kernel traces ``jax.value_and_grad`` of
``model.apply`` + ``total_loss`` into its Pallas body; the port's plain
version carries a hand-derived backward at any depth. Here the same weights
(numpy, seeded), batches, noise and dropout masks go through both:

* one step: ``generic_step_flat`` (the plain version on the CPU) against
  ``jax.value_and_grad`` of the JAX model and loss with injected noise, for
  the four methods, three architectures (deep-A-like: 1 + 1 hidden layers;
  deep-B-like: 2 + 1; and 3 + 2) and the three output-scale modes;
* an epoch: ``generic_epoch_flat`` against ``make_generic_fused_epoch(cfg,
  model, interpret=True)``, the noise redrawn from the same step keys;
* dropout: flax draws its masks inside ``model.apply`` from a key. A mask
  depends on the key and the module's path only, so a probe ``apply`` whose
  hidden layers output ones (zero kernels, unit biases) returns each
  ``Dropout``'s pre-scaled keep mask exactly
  (``capture_intermediates``); the port is fed those masks;
* the general flat layout, its conversion to the JAX package's raveled
  ``FlatAdamState`` order, and the port's general autograd step with masks
  against the plain version on the same masks.

Sizes as ``tests/test_fused_generic.py``: input dims 5 and 16, hidden 16,
latent 4, styles 2 and 3, B=32. Tolerances: the loss at rtol 1e-5, metrics
and grads at rtol 5e-4 / atol 1e-5 (float32, another summation order);
after a 3-step epoch params, mu and nu at rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from multivae_tpu.models import build_model as jax_build_model
from multivae_tpu.models import make_modalities as jax_make_modalities
from multivae_tpu.ops import fused_generic as jax_fg
from multivae_tpu.train import Config as JaxConfig
from multivae_tpu.train.losses import total_loss as jax_total_loss
from multivae_tpu.train.train_step import FlatAdamState
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.ops import adam as adam_ops
from multivae_tpu_torch.ops import fused_generic, fused_methods, fused_step
from multivae_tpu_torch.train import train_step
from multivae_tpu_torch.train.config import Config

pytestmark = pytest.mark.driver  # cross-framework parity pins

DIMS, HIDDEN, CD, STYLE, B = (5, 16), 16, 4, (2, 3), 32
RTOL, ATOL = 5e-4, 1e-5
LOSS_RTOL = 1e-5
RATE = 0.4
METHODS = ("joint_elbo", "moe", "jsd", "poe")
NAMES = ("clinical", "rois")
# (encoder hidden layers, decoder hidden layers)
ARCHS = {"deep-A-like": (1, 1), "deep-B-like": (2, 1), "3+2": (3, 2),
         "2+0": (2, 0)}
# (learn_output_scale, learn_output_sample_scale)
SCALES = {"learned": (True, False), "frozen": (False, False),
          "per-sample": (True, True)}


def cfg_kw(method, arch, scale="learned", rate=0.0):
    n_enc, n_dec = ARCHS[arch]
    learn, sample = SCALES[scale]
    return dict(method=method, input_dim=list(DIMS), class_dim=CD,
                style_dim=list(STYLE), hidden_dim=HIDDEN, batch_size=B,
                num_hidden_layer_encoder=n_enc,
                num_hidden_layer_decoder=n_dec, learn_output_scale=learn,
                learn_output_sample_scale=sample, dropout_rate=rate,
                beta=1.3, beta_style=0.7, beta_content=1.2,
                initial_learning_rate=2e-3)


def both_models(kw):
    jcfg = JaxConfig(**kw).derive()
    jmodel = jax_build_model(jcfg, jax_make_modalities(
        jcfg.input_dim, jcfg.style_dim, jcfg.likelihood))
    cfg = Config(**kw).derive()
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu")
    return jcfg, jmodel, cfg, model


def seeded_tree(model, seed):
    """A param tree of the port's model's shapes with numpy-seeded
    leaves."""
    rng = np.random.default_rng(seed)
    flat = bridge.flatten_tree(bridge.state_dict_to_tree(model.state_dict()))
    return bridge.unflatten_tree({
        k: (0.3 * rng.normal(size=v.shape)).astype(np.float32)
        for k, v in sorted(flat.items())})


def noise_width(method):
    w = CD + sum(STYLE)
    return w + (2 * CD + sum(STYLE) if method == "poe" else 0)


def split_uni(noise, method):
    """``(main, {mod: unimodal noise} or None)`` as jnp arrays."""
    w = CD + sum(STYLE)
    if method != "poe":
        return jnp.asarray(noise), None
    w1 = CD + STYLE[0]
    return jnp.asarray(noise[:, :w]), {
        "clinical": jnp.asarray(noise[:, w:w + w1]),
        "rois": jnp.asarray(noise[:, w + w1:])}


def batch_np(method, seed, b=B, steps=None):
    rng = np.random.default_rng(seed)
    lead = () if steps is None else (steps,)
    f = lambda *s: rng.normal(size=lead + s).astype(np.float32)
    return f(b, DIMS[0]), f(b, DIMS[1]), f(b, noise_width(method))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def flat_of(model, tree, dims):
    model.load_state_dict(bridge.tree_to_state_dict(tree))
    return bridge.model_flat_params(model, dims)


def tree_of(flat, dims):
    """A flat buffer of the general layout as ``{flax path: numpy leaf}``."""
    return {k: v.numpy() for k, v in
            bridge._flat_tree(flat, dims, NAMES).items()}


# ------------------------------------------------------------ dropout masks
def probe_masks(jmodel, tree, batch, dkey):
    """Every ``Dropout``'s pre-scaled keep mask of ``jmodel.apply(...,
    rngs={"dropout": dkey})`` on ``batch``: ``{network: [mask per hidden
    layer]}``. The probe's hidden layers output ones whatever they read."""
    probe = {}
    for path, leaf in bridge.flatten_tree(tree).items():
        hidden = "/hidden_" in path
        fill = 1.0 if hidden and path.endswith("bias") else 0.0
        probe[path] = (np.full_like(leaf, fill) if hidden else leaf)
    b = len(next(iter(batch.values())))
    width = jmodel.noise_width(batch)
    _, state = jmodel.apply(
        {"params": jax.tree_util.tree_map(
            jnp.asarray, bridge.unflatten_tree(probe))},
        batch, train=True, noise=jnp.zeros((b, width)),
        rngs={"dropout": dkey}, capture_intermediates=True,
        mutable=["intermediates"])
    out = {}
    for net, mods in state["intermediates"].items():
        if not net.startswith(("enc_", "dec_")):
            continue
        drops = sorted((k for k in mods if k.startswith("Dropout_")),
                       key=lambda k: int(k.split("_")[1]))
        out[net] = [np.asarray(mods[k]["__call__"][0]) for k in drops]
    return out


def port_masks(jmodel, tree, batch, dkey, method):
    """The masks of one step in the port's order ``[n_masks, B, hidden]``:
    the main pass's encoder 1, encoder 2, decoder 1, decoder 2 layers, then
    poe's unimodal re-runs' (keys ``fold_in(dkey, 100 + i)``)."""
    main = probe_masks(jmodel, tree, batch, dkey)
    passes = [main]
    if method == "poe":
        uni = {}
        for i, name in enumerate(NAMES):
            uni.update(probe_masks(jmodel, tree, {name: batch[name]},
                                   jax.random.fold_in(dkey, 100 + i)))
        passes.append(uni)
    masks = []
    for p in passes:
        for kind in ("enc", "dec"):
            for name in NAMES:
                masks += p.get(f"{kind}_{name}", [])
    values = np.unique(np.stack(masks))
    assert np.isclose(values[:, None], [0.0, 1 / (1 - RATE)]).any(1).all()
    return np.stack(masks).astype(np.float32)


# ------------------------------------------------------------------ one step
def jax_step(jcfg, jmodel, tree, x1, x2, noise, dkey=None):
    batch = {"clinical": jnp.asarray(x1), "rois": jnp.asarray(x2)}
    main, uni = split_uni(noise, jcfg.method)
    kw, drop_uni = {}, None
    if dkey is not None:
        kw["rngs"] = {"dropout": dkey}
        if uni is not None:
            drop_uni = {name: jax.random.fold_in(dkey, 100 + i)
                        for i, name in enumerate(uni)}

    def loss_fn(p):
        out = jmodel.apply({"params": p}, batch, train=True, noise=main,
                           **kw)
        return jax_total_loss(jcfg, jmodel, {"params": p}, batch, out, None,
                              train=True, noise_uni=uni,
                              dropout_rngs_uni=drop_uni)

    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    return loss, metrics, bridge.flatten_tree(jax.device_get(grads)), batch


def hold_step(method, arch, scale, masked, seed):
    kw = cfg_kw(method, arch, scale, RATE if masked else 0.0)
    jcfg, jmodel, cfg, model = both_models(kw)
    tree = seeded_tree(model, seed)
    x1, x2, noise = batch_np(method, seed + 1)
    dkey = jax.random.PRNGKey(seed) if masked else None
    loss, metrics, want, batch = jax_step(jcfg, jmodel, tree, x1, x2, noise,
                                          dkey)
    masks = (torch.from_numpy(port_masks(jmodel, tree, batch, dkey, method))
             if masked else None)
    dims = bridge.dims_from(cfg, B)
    assert isinstance(dims, bridge.GenericDims)
    assert fused_generic.supports_generic_fused(cfg, model, batch)
    launches = dict(fused_generic.KERNEL_LAUNCHES)
    tmet, tg = fused_generic.generic_step_flat(
        method, flat_of(model, tree, dims),
        (torch.from_numpy(x1), torch.from_numpy(x2)),
        torch.from_numpy(noise), dims, fused_step.consts_from(cfg),
        cfg.learn_output_scale, masks)
    assert fused_generic.KERNEL_LAUNCHES == launches  # plain on the CPU
    names = fused_methods.method_metric_names(model, method)
    assert set(names) == set(metrics)
    close(tmet[0], loss, rtol=LOSS_RTOL, atol=0)
    for n, v in zip(names, tmet):
        close(v, metrics[n], msg=n)
    got = tree_of(tg, dims)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], msg=k)
    if scale == "frozen":
        assert not got["dec_clinical/out_logvar"].any()
        assert not got["dec_rois/out_logvar"].any()


@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("arch", ["deep-A-like", "deep-B-like", "3+2"])
@pytest.mark.parametrize("method", METHODS)
def test_reference_matches_jax_autodiff(method, arch, scale):
    hold_step(method, arch, scale, False, 3)


@pytest.mark.parametrize("method", METHODS)
def test_reference_matches_jax_autodiff_linear_decoder(method):
    """A deep encoder before a linear decoder with a per-sample scale: the
    output projection reads the latents themselves."""
    hold_step(method, "2+0", "per-sample", False, 4)


@pytest.mark.parametrize("arch,scale", [("deep-A-like", "per-sample"),
                                        ("deep-B-like", "learned"),
                                        ("3+2", "frozen")])
@pytest.mark.parametrize("method", METHODS)
def test_reference_with_dropout_matches_jax_autodiff(method, arch, scale):
    """flax's own masks, recovered from a probe apply with the same key,
    fed to the port: poe's unimodal re-runs under fresh masks included."""
    hold_step(method, arch, scale, True, 5)


# --------------------------------------------------------------- the epoch
def moments_np(tree, seed):
    rng = np.random.default_rng(seed)
    flat = bridge.flatten_tree(tree)
    mu = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in sorted(flat.items())}
    nu = {k: (1e-4 * rng.random(size=v.shape)).astype(np.float32)
          for k, v in sorted(flat.items())}
    return bridge.unflatten_tree(mu), bridge.unflatten_tree(nu)


def hold_epoch(method, arch, scale, masked, seed, steps=3, count=4):
    kw = cfg_kw(method, arch, scale, RATE if masked else 0.0)
    jcfg, jmodel, cfg, model = both_models(kw)
    tree = seeded_tree(model, seed)
    mu, nu = moments_np(tree, seed + 1)
    x1s, x2s, _ = batch_np(method, seed + 2, steps=steps)
    rngs = jax.random.split(jax.random.PRNGKey(seed), steps)
    # the kernel's own draws: normal(key, (B, total_w)) per step key, and
    # under dropout the key fold_in(key, 7)
    noise = np.stack([np.asarray(jax.random.normal(
        k, (B, noise_width(method)), jnp.float32)) for k in rngs])
    as_jnp = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    state = FlatAdamState(count=jnp.asarray(count, jnp.int32),
                          mu=ravel_pytree(as_jnp(mu))[0],
                          nu=ravel_pytree(as_jnp(nu))[0])
    epoch = jax_fg.make_generic_fused_epoch(jcfg, jmodel, interpret=True)
    jp, jstate, jlosses, jmetrics = epoch(
        as_jnp(tree), state,
        {"clinical": jnp.asarray(x1s), "rois": jnp.asarray(x2s)}, rngs)

    masks = None
    if masked:
        batch0 = {"clinical": jnp.asarray(x1s[0]),
                  "rois": jnp.asarray(x2s[0])}
        masks = torch.from_numpy(np.stack([
            port_masks(jmodel, tree, batch0, jax.random.fold_in(k, 7),
                       method) for k in rngs]))
    dims = bridge.dims_from(cfg, B)
    p = flat_of(model, tree, dims)
    m = flat_of(model, mu, dims)
    v = flat_of(model, nu, dims)
    names = fused_generic.generic_metric_names(model, method)
    got = fused_generic.generic_epoch_flat(
        method, p, m, v, count,
        (torch.from_numpy(x1s), torch.from_numpy(x2s)),
        torch.from_numpy(noise), dims, fused_step.consts_from(cfg),
        adam_ops.adam_hyper(cfg), cfg.learn_output_scale, masks,
        fused_generic.metric_permutation(model, method))
    # the TPU kernel's metric columns: loss, then the other names sorted
    assert list(names) == ["loss"] + sorted(k for k in jmetrics
                                            if k != "loss")
    close(got[:, 0], jlosses, rtol=LOSS_RTOL, atol=0)
    for j, n in enumerate(names):
        close(got[:, j], jmetrics[n], msg=n)
    assert int(jstate.count) == count + steps
    want_p = bridge.flatten_tree(jax.device_get(jp))
    for k, leaf in tree_of(p, dims).items():
        close(leaf, want_p[k], rtol=1e-4, atol=1e-5, msg=k)
    for buf, want in ((m, jstate.mu), (v, jstate.nu)):
        close(bridge.split_flat_to_ravel(buf, dims, NAMES), want, rtol=1e-4,
              atol=1e-5)


# the interpret-mode epochs of poe, moe and jsd are marked slow for their
# cost, as in tests/test_fused_generic.py
SLOW_METHODS = [pytest.param(m, marks=pytest.mark.slow)
                for m in ("poe", "moe", "jsd")]


@pytest.mark.parametrize("arch,scale", [("deep-A-like", "per-sample"),
                                        ("deep-B-like", "learned"),
                                        ("3+2", "learned")])
@pytest.mark.parametrize("method", ["joint_elbo"] + SLOW_METHODS)
def test_epoch_matches_jax_pallas_epoch(method, arch, scale):
    hold_epoch(method, arch, scale, False, 11)


@pytest.mark.parametrize("method", ["joint_elbo"] + SLOW_METHODS)
def test_epoch_with_dropout_matches_jax_pallas_epoch(method):
    """deep-B-like under dropout: the kernel's in-kernel flax masks (keys
    ``fold_in(step key, 7)``), recovered by the probe and streamed to the
    port."""
    hold_epoch(method, "deep-B-like", "learned", True, 12)


# ------------------------------------------------------ layout and bridge
@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_general_layout_round_trip(arch, scale):
    _, _, cfg, model = both_models(cfg_kw("joint_elbo", arch, scale))
    tree = seeded_tree(model, 20)
    dims = bridge.dims_from(cfg, B)
    flat = flat_of(model, tree, dims)
    n_params = sum(p.numel() for p in model.parameters())
    assert flat.numel() == bridge.flat_size(dims) == n_params
    # the views are the flax leaves, in model order
    views = bridge.flat_views(flat, dims)
    assert list(views)[0] == "enc1/hidden_0/kernel"
    np.testing.assert_array_equal(views["enc2/heads/kernel"].numpy(),
                                  tree["enc_rois"]["heads"]["kernel"])
    out = "out_heads" if dims.sample_scale else "out_mu"
    np.testing.assert_array_equal(views[f"dec1/{out}/bias"].numpy(),
                                  tree["dec_clinical"][out]["bias"])
    # back into a model, bit for bit
    other = both_models(cfg_kw("joint_elbo", arch, scale))[3]
    bridge.load_flat_params(other, flat, dims)
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    # to and from the JAX package's raveled order
    want = np.asarray(ravel_pytree(jax.tree_util.tree_map(jnp.asarray,
                                                          tree))[0])
    vec = bridge.split_flat_to_ravel(flat, dims, NAMES)
    np.testing.assert_array_equal(vec, want)
    assert torch.equal(bridge.ravel_to_split_flat(vec, dims, NAMES), flat)
    with pytest.raises(ValueError, match="raveled vector"):
        bridge.ravel_to_split_flat(vec[:-1], dims, NAMES)


def test_dims_from_picks_the_layout():
    flagship = Config(input_dim=[7, 444]).derive()
    assert isinstance(bridge.dims_from(flagship, 256), bridge.FusedDims)
    for kw in (dict(num_hidden_layer_decoder=1),
               dict(num_hidden_layer_encoder=2),
               dict(learn_output_sample_scale=True)):
        dims = bridge.dims_from(Config(input_dim=[7, 444], **kw).derive(),
                                256)
        assert isinstance(dims, bridge.GenericDims)
        assert (dims.d1, dims.d2, dims.h, dims.cd) == (7, 444, 256, 20)


def test_opt_state_checkpoint_round_trip_on_a_deep_tree(tmp_path):
    from multivae_tpu_torch.train import checkpoint

    _, _, cfg, model = both_models(cfg_kw("poe", "3+2", "per-sample"))
    dims = bridge.dims_from(cfg, B)
    rng = np.random.default_rng(30)
    n = bridge.flat_size(dims)
    opt = adam_ops.AdamState(17, torch.from_numpy(
        rng.normal(size=n).astype(np.float32)), torch.from_numpy(
        rng.random(size=n).astype(np.float32)))
    checkpoint.save_checkpoint(str(tmp_path), model, opt, dims=dims)
    with np.load(tmp_path / "opt_state.npz") as fh:
        # on disk: the JAX package's ravel order of the deep tree
        mu_tree = bridge.unflatten_tree(tree_of(opt.mu, dims))
        np.testing.assert_array_equal(fh["mu"], np.asarray(ravel_pytree(
            jax.tree_util.tree_map(jnp.asarray, mu_tree))[0]))
    back = checkpoint.restore_opt_state(str(tmp_path), dims, NAMES, "cpu")
    assert back.count == 17
    assert torch.equal(back.mu, opt.mu) and torch.equal(back.nu, opt.nu)


# ------------------------------------------------ the general autograd step
@pytest.mark.parametrize("arch,scale,masked", [
    ("deep-A-like", "per-sample", False), ("deep-B-like", "learned", True),
    ("3+2", "frozen", True)])
@pytest.mark.parametrize("method", METHODS)
def test_general_step_matches_the_plain_version(method, arch, scale, masked):
    """The port's general step (torch autograd of the model and
    ``total_loss``) and the layer-stack step's plain version take the same
    noise and the same masks and give the same update."""
    _, _, cfg, model = both_models(cfg_kw(method, arch, scale,
                                          RATE if masked else 0.0))
    tree = seeded_tree(model, 40)
    dims = bridge.dims_from(cfg, B)
    x1, x2, noise = (torch.from_numpy(a) for a in batch_np(method, 41))
    masks = None
    if masked:
        n = fused_generic.n_dropout_masks(method, RATE, dims.n_enc,
                                          dims.n_dec)
        assert n == train_step.general_mask_count(cfg, NAMES)
        keep = np.random.default_rng(42).random((n, B, HIDDEN)) < 1 - RATE
        masks = torch.from_numpy((keep / (1 - RATE)).astype(np.float32))
    hyper = adam_ops.adam_hyper(cfg)
    p_gen = flat_of(model, tree, dims)
    p_ker = p_gen.clone()
    opt = adam_ops.init_adam_state(p_gen)
    opt, loss, metrics = train_step.general_step(
        cfg, model, p_gen, opt, {"clinical": x1, "rois": x2}, noise, dims,
        hyper, masks)
    m, v = torch.zeros_like(p_ker), torch.zeros_like(p_ker)
    got = fused_generic.generic_epoch_flat(
        method, p_ker, m, v, 0, (x1[None], x2[None]), noise[None], dims,
        fused_step.consts_from(cfg), hyper, cfg.learn_output_scale,
        None if masks is None else masks[None])
    close(got[0, 0], loss, rtol=LOSS_RTOL, atol=0)
    for n, val in zip(fused_methods.method_metric_names(model, method),
                      got[0]):
        close(val, metrics[n], msg=n)
    assert opt.count == 1
    # one Adam step from zero moments moves every element by ~lr: hold the
    # moments (the gradients) at the step bound, the params at the epoch's
    close(m, opt.mu, rtol=RTOL, atol=ATOL * (1 - hyper.b1))
    close(p_ker, p_gen, rtol=1e-4, atol=1e-5)


def test_general_mask_count_is_the_kernel_routes():
    from multivae_tpu_torch.ops import fused_presence

    for method in METHODS:
        flagship = Config(method=method, dropout_rate=0.2).derive()
        assert train_step.general_mask_count(flagship, NAMES) == \
            fused_methods.n_dropout_masks(method, 0.2)
        assert train_step.general_mask_count(flagship, NAMES[:1]) == \
            fused_presence.n_presence_masks(method, 0.2)
        deep = Config(method=method, dropout_rate=0.2,
                      num_hidden_layer_encoder=2,
                      num_hidden_layer_decoder=1).derive()
        assert train_step.general_mask_count(deep, NAMES) == \
            fused_generic.n_dropout_masks(method, 0.2, 2, 1)
        assert train_step.general_mask_count(
            Config(method=method).derive(), NAMES) == 0


# ------------------------------------------------------------ the envelope
FULL_WIDTH = dict(input_dim=[7, 444], class_dim=20, style_dim=[3, 20],
                  hidden_dim=256, batch_size=256)
DEEP_A = dict(num_hidden_layer_encoder=1, num_hidden_layer_decoder=1,
              learn_output_sample_scale=True)
DEEP_B = dict(num_hidden_layer_encoder=2, num_hidden_layer_decoder=1,
              dropout_rate=0.2)


@pytest.mark.parametrize("arch", [DEEP_A, DEEP_B], ids=["deep-A", "deep-B"])
@pytest.mark.parametrize("method", METHODS)
def test_slice_configs_are_the_jax_generic_kernels(method, arch):
    """deep-A and deep-B at full width: the JAX package routes them to its
    generic kernel (neither split-layout kernel takes them, the VMEM guard
    passes), and the port to its layer-stack step."""
    from multivae_tpu.ops import fused_methods as jax_fm
    from multivae_tpu.ops import fused_step as jax_fs

    jcfg, jmodel, cfg, model = both_models(dict(method=method, **FULL_WIDTH,
                                                **arch))
    example = {n: None for n in NAMES}
    assert not jax_fs.supports_fused(jcfg, jmodel, example)
    assert not jax_fm.supports_method_fused(jcfg, jmodel, example)
    assert jax_fg.supports_generic_fused(jcfg, jmodel, example)
    assert fused_generic.supports_generic_fused(cfg, model, example)
    assert not fused_generic.supports_generic_fused(cfg, model,
                                                    {"clinical": None})
    assert not fused_methods.supports_method_fused(cfg, model, example)
    assert method in fused_generic.PORTED_METHODS


@pytest.mark.parametrize("kw,what", [
    (dict(likelihood="laplace"), None),
    (dict(factorized_representation=False), None),
    (dict(input_dim=[5, 16, 7], style_dim=[2, 3, 2]), None),
    (dict(num_hidden_layer_encoder=5), None),
    (dict(num_hidden_layer_decoder=5), None),
    (dict(input_dim=[3] * (fused_generic.MAX_MODS + 1),
          style_dim=[1] * (fused_generic.MAX_MODS + 1)),
     f"{fused_generic.MAX_MODS + 1} modalities"),
    (dict(num_hidden_layer_encoder=fused_generic.MAX_DEPTH + 1),
     "num_hidden_layer_encoder"),
    (dict(num_hidden_layer_decoder=fused_generic.MAX_DEPTH + 1),
     "num_hidden_layer_decoder"),
])
def test_outside_the_envelope_names_its_roadmap_item(kw, what):
    """M = 3 and a depth of 5 are inside the step's envelope, as are the
    other likelihoods and the unfactorized latent (``what`` None): they pass
    the trainer's check. A modality count or a depth past the kernel's caps
    raises, naming its ROADMAP item."""
    from multivae_tpu_torch.train import trainer

    base = cfg_kw("joint_elbo", "deep-A-like")
    base.update(kw)
    cfg = Config(**base).derive()
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu")
    gaps = fused_generic.envelope_gaps(cfg, model)
    example = {m.name: None for m in model.modalities}
    if what is None:
        assert gaps == []
        assert fused_generic.supports_generic_fused(cfg, model, example)
        trainer.check_supported(cfg, model)
        return
    assert len(gaps) == 1 and what in gaps[0] and "ROADMAP" in gaps[0]
    assert not fused_generic.supports_generic_fused(cfg, model, example)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 item 2"):
        trainer.check_supported(cfg, model)


def test_step_refuses_wrong_masks_and_methods():
    _, _, cfg, model = both_models(cfg_kw("poe", "deep-B-like"))
    dims = bridge.dims_from(cfg, B)
    p = bridge.model_flat_params(model, dims)
    x1, x2, noise = (torch.from_numpy(a) for a in batch_np("poe", 50))
    consts = fused_step.consts_from(cfg)
    with pytest.raises(ValueError, match="dropout masks"):
        fused_generic.generic_step_flat("poe", p, (x1, x2), noise, dims,
                                        consts, True,
                                        torch.ones(6, B, HIDDEN))
    with pytest.raises(ValueError, match="unknown method"):
        fused_generic.generic_step_flat("mopoe", p, (x1, x2), noise, dims,
                                        consts)
    assert fused_generic.n_dropout_masks("poe", 0.2, 2, 1) == 12
    assert fused_generic.n_dropout_masks("moe", 0.2, 2, 1) == 6
    assert fused_generic.n_dropout_masks("poe", 0.0, 2, 1) == 0
