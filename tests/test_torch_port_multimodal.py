"""The port at modality counts other than two against the JAX package.

The JAX package trains any modality count M: its model builds every subset
of the modality powerset, and its generic kernel traces
``jax.value_and_grad`` of ``model.apply`` + ``total_loss`` for whatever
model the config builds. The port writes that step by hand
(``ops/latent_multi.py`` between the layer stacks of
``ops/fused_generic.py``). Here the same weights (numpy, seeded, through
the weights bridge), batches, noise and dropout masks go through both:

* the port's ``MultimodalVAE`` forward and ``total_loss`` at M = 3 and 4
  against ``model.apply`` + ``total_loss``, for the four methods and the
  presence patterns of ``tests/test_m4_modalities.py``;
* one step of the plain layer-stack step (``generic_step_flat`` on the
  CPU) against ``jax.value_and_grad`` of the model and loss: M = 3 and 4
  and the four methods, the three output-scale modes, M = 5 at B = 16
  (2^M - 1 > B: every row is the full set's), depths 5 to 8, poe without
  its unimodal ELBOs (set after ``derive``, the only way a run reaches
  that branch) and dropout;
* the M-modality general layout against ``ravel_pytree``, with names that
  sort apart from model order (``clinical, rois, mod2, mod3``);
* one trainer epoch of a tiny four-block cohort (the ROI block split by
  measure) against the JAX package's steps and ``flat_adam``, and the
  ``train`` CLI on that cohort with a checkpoint and a resume.

Tolerances as ``tests/test_torch_port_generic.py``: the loss at rtol 1e-5,
metrics and grads at rtol 5e-4 / atol 1e-5 (float32, another summation
order); params and the Adam moments after an epoch at rtol 1e-4 / atol
1e-5.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from multivae_tpu.models import build_model as jax_build_model
from multivae_tpu.models import make_modalities as jax_make_modalities
from multivae_tpu.train import Config as JaxConfig
from multivae_tpu.train.losses import total_loss as jax_total_loss
from multivae_tpu.train.train_step import flat_adam
from multivae_tpu_torch import cli
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.data import make_synthetic_cohort
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.ops import fused_generic, fused_methods, fused_step
from multivae_tpu_torch.ops import latent_multi
from multivae_tpu_torch.train import routes, train_step, trainer
from multivae_tpu_torch.train.config import Config
from multivae_tpu_torch.train.experiment import MultimodalExperiment

pytestmark = pytest.mark.driver  # cross-framework parity pins

WIDTHS, STYLES = (5, 7, 6, 4, 3), (2, 3, 1, 2, 2)
HIDDEN, CD, B = 16, 4, 24
RTOL, ATOL = 5e-4, 1e-5
LOSS_RTOL = 1e-5
RATE = 0.4
METHODS = ("joint_elbo", "moe", "jsd", "poe")
# (learn_output_scale, learn_output_sample_scale)
SCALES = {"learned": (True, False), "frozen": (False, False),
          "per-sample": (True, True)}


def cfg_kw(method, m, n_enc=1, n_dec=0, scale="learned", rate=0.0, b=B,
           hidden=HIDDEN):
    learn, sample = SCALES[scale]
    return dict(method=method, input_dim=list(WIDTHS[:m]), class_dim=CD,
                style_dim=list(STYLES[:m]), hidden_dim=hidden, batch_size=b,
                num_hidden_layer_encoder=n_enc,
                num_hidden_layer_decoder=n_dec, learn_output_scale=learn,
                learn_output_sample_scale=sample, dropout_rate=rate,
                beta=1.3, beta_style=0.7, beta_content=1.2,
                initial_learning_rate=2e-3)


def both_models(kw, uni=True):
    """The JAX and the port's config and model; ``uni`` False sets poe's
    unimodal ELBOs off after ``derive``."""
    jcfg = JaxConfig(**kw).derive()
    cfg = Config(**kw).derive()
    jcfg.poe_unimodal_elbos = cfg.poe_unimodal_elbos = uni
    jmodel = jax_build_model(jcfg, jax_make_modalities(
        jcfg.input_dim, jcfg.style_dim, jcfg.likelihood))
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu")
    return jcfg, jmodel, cfg, model


def seeded_tree(model, seed):
    rng = np.random.default_rng(seed)
    flat = bridge.flatten_tree(bridge.state_dict_to_tree(model.state_dict()))
    return bridge.unflatten_tree({
        k: (0.3 * rng.normal(size=v.shape)).astype(np.float32)
        for k, v in sorted(flat.items())})


def as_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def jax_noise(jcfg, jmodel, batch, noise):
    """``(main, {mod: unimodal noise} or None)`` as the JAX loss takes
    them: the model's draw, then poe's per present modality."""
    main = jmodel.noise_width(batch)
    if not (jcfg.method == "poe" and jcfg.poe_unimodal_elbos):
        return jnp.asarray(noise[:, :main]), None
    uni, off = {}, main
    for m in jmodel.modalities:
        if m.name in batch:
            w = jmodel.noise_width({m.name: None})
            uni[m.name] = jnp.asarray(noise[:, off:off + w])
            off += w
    return jnp.asarray(noise[:, :main]), uni


# --------------------------------------------- model and loss, any pattern
PATTERNS = {3: [(0, 1, 2), (0, 2), (1,)],
            4: [(0, 1, 2, 3), (0, 1, 2), (1, 3), (0, 3), (2,)]}
CASES = [(m, p) for m in PATTERNS for p in PATTERNS[m]]


@pytest.mark.parametrize("m,present", CASES,
                         ids=[f"M{m}-{''.join(map(str, p))}"
                              for m, p in CASES])
@pytest.mark.parametrize("method", METHODS)
def test_model_and_loss_match_jax(method, m, present):
    """The port's forward and ``total_loss`` on a batch of any presence
    pattern, every subset of the powerset fused."""
    jcfg, jmodel, cfg, model = both_models(cfg_kw(method, m))
    tree = seeded_tree(model, 11 * m)
    model.load_state_dict(bridge.tree_to_state_dict(tree))
    names = [model.modalities[i].name for i in present]
    rng = np.random.default_rng(5)
    data = {n: rng.normal(size=(B, WIDTHS[model.mod_names.index(n)]))
            .astype(np.float32) for n in names}
    width = train_step.batch_noise_width(cfg, model, data)
    noise = rng.normal(size=(B, width)).astype(np.float32)
    with torch.no_grad():
        loss, metrics = train_step.loss_and_metrics(
            cfg, model, {k: torch.from_numpy(v) for k, v in data.items()},
            torch.from_numpy(noise))
    batch = {k: jnp.asarray(v) for k, v in data.items()}
    main, uni = jax_noise(jcfg, jmodel, batch, noise)
    variables = {"params": as_jnp(tree)}
    out = jmodel.apply(variables, batch, noise=main)
    jloss, want = jax_total_loss(jcfg, jmodel, variables, batch, out, None,
                                 noise_uni=uni)
    assert sorted(metrics) == sorted(want)
    close(loss, jloss, rtol=LOSS_RTOL, atol=0)
    for k in want:
        close(metrics[k], want[k], msg=k)
    n_sub = len(latent_multi.powerset(len(present)))
    assert sum(k.startswith("kld/") for k in metrics) == n_sub


# ------------------------------------------------------------------ one step
def probe_masks(jmodel, tree, batch, dkey):
    """Every ``Dropout``'s pre-scaled keep mask of ``jmodel.apply(...,
    rngs={"dropout": dkey})`` on ``batch`` (a probe whose hidden layers
    output ones: zero kernels, unit biases): ``{network: [masks]}``."""
    probe = {}
    for path, leaf in bridge.flatten_tree(tree).items():
        hidden = "/hidden_" in path
        fill = 1.0 if hidden and path.endswith("bias") else 0.0
        probe[path] = np.full_like(leaf, fill) if hidden else leaf
    b = len(next(iter(batch.values())))
    _, state = jmodel.apply(
        {"params": as_jnp(bridge.unflatten_tree(probe))}, batch, train=True,
        noise=jnp.zeros((b, jmodel.noise_width(batch))),
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


def port_masks(jcfg, jmodel, tree, batch, dkey):
    """One step's masks in the port's order ``[n_masks, B, hidden]``: the
    main pass's encoders in model order, then its decoders, then poe's
    unimodal re-runs' (keys ``fold_in(dkey, 100 + i)``)."""
    names = [m.name for m in jmodel.modalities]
    passes = [probe_masks(jmodel, tree, batch, dkey)]
    if jcfg.method == "poe" and jcfg.poe_unimodal_elbos:
        uni = {}
        for i, name in enumerate(names):
            uni.update(probe_masks(jmodel, tree, {name: batch[name]},
                                   jax.random.fold_in(dkey, 100 + i)))
        passes.append(uni)
    masks = [mk for p in passes for kind in ("enc", "dec") for name in names
             for mk in p.get(f"{kind}_{name}", [])]
    values = np.unique(np.stack(masks))
    assert np.isclose(values[:, None], [0.0, 1 / (1 - RATE)]).any(1).all()
    return np.stack(masks).astype(np.float32)


def hold_step(kw, seed, uni=True):
    jcfg, jmodel, cfg, model = both_models(kw, uni)
    tree = seeded_tree(model, seed)
    rng = np.random.default_rng(seed + 1)
    names = list(model.mod_names)
    b = kw["batch_size"]
    xs = [rng.normal(size=(b, d)).astype(np.float32)
          for d in kw["input_dim"]]
    batch = {n: jnp.asarray(x) for n, x in zip(names, xs)}
    dims = bridge.generic_dims(cfg, b)
    assert dims.m == len(names)
    noise = rng.normal(size=(b, latent_multi.noise_width(
        cfg.method, dims.cd, dims.ss, uni))).astype(np.float32)
    assert noise.shape[1] == train_step.batch_noise_width(cfg, model, batch)
    main, noise_uni = jax_noise(jcfg, jmodel, batch, noise)
    masked = kw["dropout_rate"] > 0
    dkey = jax.random.PRNGKey(seed) if masked else None
    apply_kw, drop_uni = {}, None
    if masked:
        apply_kw["rngs"] = {"dropout": dkey}
        if noise_uni is not None:
            drop_uni = {n: jax.random.fold_in(dkey, 100 + i)
                        for i, n in enumerate(noise_uni)}

    def loss_fn(p):
        out = jmodel.apply({"params": p}, batch, train=True, noise=main,
                           **apply_kw)
        return jax_total_loss(jcfg, jmodel, {"params": p}, batch, out, None,
                              train=True, noise_uni=noise_uni,
                              dropout_rngs_uni=drop_uni)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(as_jnp(tree))
    masks = None
    if masked:
        masks = torch.from_numpy(port_masks(jcfg, jmodel, tree, batch, dkey))
        assert len(masks) == train_step.general_mask_count(cfg, names)
    assert fused_generic.supports_generic_fused(cfg, model, batch)
    model.load_state_dict(bridge.tree_to_state_dict(tree))
    launches = dict(fused_generic.KERNEL_LAUNCHES)
    tmet, tg = fused_generic.generic_step_flat(
        cfg.method, bridge.model_flat_params(model, dims),
        [torch.from_numpy(x) for x in xs], torch.from_numpy(noise), dims,
        fused_step.consts_from(cfg), cfg.learn_output_scale, masks,
        unimodal_elbos=uni)
    assert fused_generic.KERNEL_LAUNCHES == launches  # plain on the CPU
    step_names = latent_multi.step_metric_names(names, cfg.method, uni)
    assert set(step_names) == set(metrics)
    close(tmet[0], loss, rtol=LOSS_RTOL, atol=0)
    for n, v in zip(step_names, tmet):
        close(v, metrics[n], msg=n)
    got = {k: v.numpy() for k, v in
           bridge._flat_tree(tg, dims, names).items()}
    want = bridge.flatten_tree(jax.device_get(grads))
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], msg=k)
    return got


@pytest.mark.parametrize("m", [3, 4])
@pytest.mark.parametrize("method", METHODS)
def test_step_matches_jax_autodiff(method, m):
    hold_step(cfg_kw(method, m), 3 + m)


@pytest.mark.parametrize("method,m,scale,arch", [
    ("joint_elbo", 3, "frozen", (1, 1)), ("poe", 3, "per-sample", (2, 1)),
    ("jsd", 4, "per-sample", (1, 0)), ("moe", 4, "frozen", (2, 0))])
def test_step_of_each_scale_mode(method, m, scale, arch):
    got = hold_step(cfg_kw(method, m, *arch, scale=scale), 21)
    if scale == "frozen":
        lv = [k for k in got if k.endswith("/out_logvar")]
        assert len(lv) == m and not any(got[k].any() for k in lv)


@pytest.mark.parametrize("method", ["joint_elbo", "poe"])
def test_step_with_more_subsets_than_rows(method):
    """M = 5 at B = 16: 31 subsets, so joint_elbo's partition gives every
    row to the full set, as ``mixture_partition`` does."""
    assert latent_multi.owner_rows(31, 16, "cpu").tolist() == [30] * 16
    hold_step(cfg_kw(method, 5, b=16), 31)


@pytest.mark.parametrize("method,m,arch", [
    ("joint_elbo", 2, (5, 1)), ("poe", 3, (6, 6)), ("moe", 2, (7, 3)),
    ("jsd", 3, (8, 8))])
def test_step_at_depths_past_four(method, m, arch):
    hold_step(cfg_kw(method, m, *arch, hidden=8), 40 + sum(arch))


@pytest.mark.parametrize("m,rate", [(2, 0.0), (3, 0.0), (2, RATE),
                                    (4, RATE)])
def test_poe_without_unimodal_elbos(m, rate):
    """``poe_unimodal_elbos=False`` after ``derive``: the joint ELBO alone,
    noise without the unimodal draws, one pass of masks."""
    kw = cfg_kw("poe", m, 1, 1, rate=rate)
    cfg = Config(**kw).derive()
    dims = bridge.dims_from(cfg, B)
    assert fused_generic.multi_latents("poe", dims, False)
    assert latent_multi.noise_width("poe", CD, dims.ss, False) == CD + sum(
        STYLES[:m])
    hold_step(kw, 60 + m, uni=False)


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_poe_without_unimodal_elbos_at_the_split_architecture(rate):
    """The split layout's architecture (M = 2, 1 + 0, normal, per-feature
    scale): without its unimodal ELBOs poe is no method step's, so the
    full complete batches take the layer-stack step, as in the JAX
    package."""
    kw = cfg_kw("poe", 2, rate=rate)
    _, _, cfg, model = both_models(kw, uni=False)
    assert bridge.split_layout(cfg)
    example = {n: None for n in model.mod_names}
    assert not fused_methods.supports_method_fused(cfg, model, example)
    assert routes.Routes(cfg, model, "cpu").full == routes.LAYER_STACK
    assert not routes.Routes(cfg, model).gaps
    hold_step(kw, 64, uni=False)


@pytest.mark.parametrize("method,m", [("poe", 3), ("moe", 4),
                                      ("joint_elbo", 3)])
def test_step_with_dropout(method, m):
    hold_step(cfg_kw(method, m, 2, 1, scale="per-sample", rate=RATE), 70 + m)


@pytest.mark.parametrize("method", METHODS)
def test_two_modality_routes_agree(method):
    """At M = 2 the M-modality latent math is the method step's
    (``fused_methods.latent_fwd_bwd``, which the kernel keeps there)."""
    _, _, cfg, model = both_models(cfg_kw(method, 2, 1, 1))
    dims = bridge.dims_from(cfg, B)
    tree = seeded_tree(model, 80)
    model.load_state_dict(bridge.tree_to_state_dict(tree))
    sp = bridge.flat_views(bridge.model_flat_params(model, dims), dims)
    rng = np.random.default_rng(81)
    xs = [torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
          for d in WIDTHS[:2]]
    noise = torch.from_numpy(rng.normal(size=(
        B, latent_multi.noise_width(method, CD, dims.ss))).astype(np.float32))
    consts = fused_step.consts_from(cfg)
    outs = []
    for latent in (fused_methods.latent_fwd_bwd, None):
        nets = fused_generic.StackNets(sp, xs, dims, True)
        if latent is None:
            loss, met = latent_multi.latent_fwd_bwd(
                method, nets, noise, B, CD, dims.ss, consts)
        else:
            loss, met = latent(method, nets, noise, B, CD, dims.s1, dims.s2,
                               consts)
        outs.append((loss, met, nets.g))
    (l2, m2, g2), (lm, mm, gm) = outs
    assert latent_multi.step_metric_names(model.mod_names, method) == \
        fused_methods.method_metric_names(model, method)
    close(lm, l2, rtol=LOSS_RTOL, atol=0)
    close(mm, m2)
    for k in g2:
        close(gm[k], g2[k], msg=k)


# ------------------------------------------------------------------ layout
def test_layout_of_four_modalities_against_ravel_pytree():
    """``clinical, rois, mod2, mod3`` ravel as ``clinical, mod2, mod3,
    rois``; the general layout keeps model order and converts by path."""
    _, _, cfg, model = both_models(cfg_kw("poe", 4, 2, 1,
                                          scale="per-sample"))
    dims = bridge.dims_from(cfg, B)
    names = list(model.mod_names)
    assert names == ["clinical", "rois", "mod2", "mod3"]
    assert names != sorted(names)
    tree = seeded_tree(model, 90)
    model.load_state_dict(bridge.tree_to_state_dict(tree))
    flat = bridge.model_flat_params(model, dims)
    assert flat.numel() == bridge.flat_size(dims) == sum(
        p.numel() for p in model.parameters())
    shapes = bridge.generic_shapes(dims)
    nets = list(dict.fromkeys(n.split("/")[0] for n in shapes))
    assert nets == [f"enc{e}" for e in range(1, 5)] + [
        f"dec{e}" for e in range(1, 5)]
    want, _ = ravel_pytree(as_jnp(tree))
    vec = bridge.split_flat_to_ravel(flat, dims, names)
    np.testing.assert_array_equal(vec, np.asarray(want))
    back = bridge.ravel_to_split_flat(vec, dims, names)
    assert torch.equal(back, flat)
    # the layout's first tensor is model-order encoder 1, not ravel's
    first = next(iter(bridge._flat_tree(flat, dims, names)))
    assert first == "enc_clinical/hidden_0/kernel"
    raveled = list(dict.fromkeys(p.split("/")[0]
                                 for p in bridge.ravel_order(tree)))
    assert raveled == ["dec_clinical", "dec_mod2", "dec_mod3", "dec_rois",
                       "enc_clinical", "enc_mod2", "enc_mod3", "enc_rois"]


def test_layout_index_moves_the_split_layout_to_the_general_one():
    """A flat buffer of the split layout gathered by ``layout_index`` is the
    same params in the general layout, and scattering it back restores
    the buffer."""
    _, _, cfg, model = both_models(cfg_kw("poe", 2))
    model.load_state_dict(bridge.tree_to_state_dict(seeded_tree(model, 91)))
    split, general = bridge.dims_from(cfg, B), bridge.generic_dims(cfg, B)
    assert isinstance(split, bridge.FusedDims)
    flat = bridge.model_flat_params(model, split)
    index = bridge.layout_index(split, general, model.mod_names)
    assert sorted(index.tolist()) == list(range(flat.numel()))
    moved = flat[index]
    assert torch.equal(moved, bridge.model_flat_params(model, general))
    back = torch.empty_like(flat)
    back[index] = moved
    assert torch.equal(back, flat)


def test_sizes_of_the_m_modality_step():
    dims = bridge.GenericDims(b=4, ds=(3, 5, 2, 6), h=8, cd=2,
                              ss=(1, 0, 2, 3), n_enc=2, n_dec=1,
                              sample_scale=False)
    assert dims.m == 4 and (dims.d1, dims.s2) == (3, 0)
    assert fused_generic.n_dropout_masks("poe", 0.2, 2, 1, 4) == 24
    assert fused_generic.n_dropout_masks("poe", 0.2, 2, 1, 4, False) == 12
    assert fused_generic.n_dropout_masks("jsd", 0.2, 2, 1, 4) == 12
    assert latent_multi.noise_width("moe", 2, dims.ss) == 2 + 6
    assert latent_multi.noise_width("poe", 2, dims.ss) == 8 + 4 * 2 + 6
    assert latent_multi.n_step_metrics(4, "poe") == 2 + 24 + 15 + 4
    assert latent_multi.n_step_metrics(4, "poe", False) == 41
    assert latent_multi.powerset(3) == [(0,), (1,), (2,), (0, 1), (0, 2),
                                        (1, 2), (0, 1, 2)]
    assert fused_generic.multi_latents("joint_elbo", dims)
    assert not fused_generic.multi_latents(
        "poe", dims._replace(ds=(3, 5), ss=(1, 0)))
    # past the cap of modalities the step raises, naming its ROADMAP item
    wide = dims._replace(ds=(3,) * 11, ss=(1,) * 11)
    with pytest.raises(ValueError, match="ROADMAP Queue 2 item 2"):
        fused_generic.generic_step_flat(
            "moe", torch.zeros(bridge.flat_size(wide)),
            [torch.zeros(4, 3)] * 11, torch.zeros(4, 13), wide,
            fused_step.FusedConsts(1.0, 1.0, 1.0))


# ------------------------------------------------------ a four-block cohort
FOUR_BLOCK_ROIS = 12  # 4 ROIs x 3 measures


def split_roi_block(datadir: str) -> None:
    """Rewrite a synthetic cohort's ROI block into three blocks by the
    measure each column holds (the ``_thickness`` / ``_area`` /
    ``_meancurv`` suffix of ``rois_names.npy``): ``rois``, ``mod2``,
    ``mod3``. A subject without ROIs lacks all three."""
    data = np.load(os.path.join(datadir, "rois_data.npy"))
    names = np.load(os.path.join(datadir, "rois_names.npy"),
                    allow_pickle=True)
    subjects = np.load(os.path.join(datadir, "rois_subjects.npy"),
                       allow_pickle=True)
    for block, measure in (("rois", "thickness"), ("mod2", "area"),
                           ("mod3", "meancurv")):
        cols = [i for i, n in enumerate(names)
                if str(n).endswith("_" + measure)]
        np.save(os.path.join(datadir, f"{block}_data.npy"),
                np.ascontiguousarray(data[:, cols]))
        np.save(os.path.join(datadir, f"{block}_names.npy"), names[cols])
        np.save(os.path.join(datadir, f"{block}_subjects.npy"), subjects)


@pytest.fixture(scope="module")
def four_block(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("four_block"))
    make_synthetic_cohort(d, n_subjects=100, n_scores=3,
                          n_rois=FOUR_BLOCK_ROIS, missing_rate=0.2, seed=1)
    split_roi_block(d)
    return d


FOUR_DIMS, FOUR_STYLES, FOUR_BATCH = [3, 4, 4, 4], [2, 3, 3, 3], 12


def four_block_exp(datadir, uni=True, **kw):
    base = dict(dataset="synthetic", datasetdir=datadir,
                input_dim=FOUR_DIMS, class_dim=CD, style_dim=FOUR_STYLES,
                hidden_dim=HIDDEN, batch_size=FOUR_BATCH, end_epoch=1,
                initial_learning_rate=2e-3, beta_style=0.7,
                beta_content=1.2, seed=7)
    base.update(kw)
    exp = MultimodalExperiment(Config(**base).derive(), "cpu")
    exp.cfg.poe_unimodal_elbos = uni
    exp.set_datasets()
    exp.set_optimizers()
    return exp


def rows(data):
    return len(next(iter(data.values())))


@pytest.mark.parametrize("method,uni", [("joint_elbo", True), ("poe", True),
                                        ("poe", False)],
                         ids=["joint_elbo", "poe", "poe-no-unimodal"])
def test_one_epoch_of_a_four_block_cohort_matches_jax(four_block, method,
                                                      uni):
    """``train_one_epoch``: the full complete batches on the layer-stack
    step (its plain version), the others on the general autograd step,
    against the JAX package's ``value_and_grad`` of ``model.apply`` +
    ``total_loss`` and ``flat_adam`` over the same batches in the same order
    with the port's noise."""
    exp = four_block_exp(four_block, uni, method=method)
    assert list(exp.mod_names) == ["clinical", "rois", "mod2", "mod3"]
    hold_trainer_epoch(exp, uni)


def test_one_split_architecture_epoch_of_poe_without_unimodal_elbos(
        four_block):
    """As above at the split layout's architecture (the cohort's first two
    blocks, 1 + 0, per-feature scale) with poe's unimodal ELBOs off: the
    state stays in the split layout and the full complete batches take the
    layer-stack step in the general one."""
    exp = four_block_exp(four_block, False, method="poe",
                         input_dim=FOUR_DIMS[:2], style_dim=FOUR_STYLES[:2])
    assert list(exp.mod_names) == ["clinical", "rois"]
    assert isinstance(bridge.dims_from(exp.cfg, FOUR_BATCH),
                      bridge.FusedDims)
    hold_trainer_epoch(exp, False)


def hold_trainer_epoch(exp, uni):
    from multivae_tpu_torch.ops import adam

    cfg, model = exp.cfg, exp.models[0]
    names = list(exp.mod_names)
    assert routes.Routes(cfg, model, "cpu").full == routes.LAYER_STACK
    dims = bridge.dims_from(cfg, FOUR_BATCH)
    p0 = exp.params[0].clone()
    launches = (dict(adam.KERNEL_LAUNCHES),
                dict(fused_generic.KERNEL_LAUNCHES))
    steps = trainer.train_one_epoch(exp, 0, None,
                                    trainer.epoch_generator(cfg, 0, 0), 0)
    assert launches == (adam.KERNEL_LAUNCHES, fused_generic.KERNEL_LAUNCHES)

    from multivae_tpu.data import MissingModalitySampler as JaxSampler

    ds = exp.dataset_train
    batches = [ds.gather(i)[0] for i in
               JaxSampler(ds, batch_size=FOUR_BATCH, seed=cfg.seed)]
    is_full = [rows(b) == FOUR_BATCH and all(m in b for m in names)
               for b in batches]
    emitted = ([b for b, f in zip(batches, is_full) if f]
               + [b for b, f in zip(batches, is_full) if not f])
    n_full = sum(is_full)
    noise = trainer.draw_noise(
        trainer.epoch_generator(cfg, 0, 0),
        [(rows(b), trainer.batch_noise_width(cfg, model, b))
         for b in emitted], "cpu")
    groups = {}
    for i, b in enumerate(emitted[n_full:]):
        groups.setdefault((tuple(sorted(b)), rows(b)), []).append(n_full + i)
    order = list(range(n_full))
    for key in trainer.canonical_group_order(groups, names, FOUR_BATCH):
        order += groups[key]
    assert steps == len(order) == len(batches) and n_full >= 2
    assert {len(emitted[i]) for i in order} == {1, len(names)}

    jcfg = JaxConfig(**{k: getattr(cfg, k) for k in (
        "method", "input_dim", "class_dim", "style_dim", "hidden_dim",
        "batch_size", "beta", "beta_style", "beta_content",
        "initial_learning_rate")}).derive()
    jcfg.poe_unimodal_elbos = uni
    jm = jax_build_model(jcfg, jax_make_modalities(
        jcfg.input_dim, jcfg.style_dim, jcfg.likelihood))
    params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v)), bridge.unflatten_tree(
            {k: v.numpy() for k, v in
             bridge._flat_tree(p0, dims, names).items()}))
    opt = flat_adam(cfg.initial_learning_rate, cfg.beta_1, cfg.beta_2)
    state = opt.init(params)

    @jax.jit
    def grad_fn(p, batch, main, noise_uni):
        def loss_fn(p):
            out = jm.apply({"params": p}, batch, train=True, noise=main)
            return jax_total_loss(jcfg, jm, {"params": p}, batch, out, None,
                                  train=True, noise_uni=noise_uni)[0]
        return jax.grad(loss_fn)(p)

    for i in order:
        batch = {k: jnp.asarray(v) for k, v in emitted[i].items()}
        main, noise_uni = jax_noise(jcfg, jm, batch, noise[i].numpy())
        grads = grad_fn(params, batch, main, noise_uni)
        upd, state = opt.update(grads, state, params)
        params = jax.tree_util.tree_map(lambda a, u: a + u, params, upd)

    want = bridge.flatten_tree(jax.device_get(params))
    got = {k: v.numpy() for k, v in
           bridge._flat_tree(exp.params[0], dims, names).items()}
    for k in want:
        close(got[k], want[k], rtol=1e-4, atol=1e-5, msg=k)
    assert exp.opt_states[0].count == int(state.count) == steps
    for buf, ref in ((exp.opt_states[0].mu, state.mu),
                     (exp.opt_states[0].nu, state.nu)):
        close(bridge.split_flat_to_ravel(buf, dims, names), ref, rtol=1e-4,
              atol=1e-5)


def test_train_cli_on_a_four_block_cohort(four_block, tmp_path):
    """``python -m multivae_tpu_torch train`` on the four-block cohort on
    the CPU: a falling loss with every subset's family, a checkpoint whose
    optimizer state is the JAX package's raveled vector, and a resume that
    continues the run."""
    import pandas as pd

    out = str(tmp_path / "out")
    argv = ["train", "--dataset", "synthetic", "--datasetdir", four_block,
            "--outdir", out, "--input-dims", "3", "4", "4", "4",
            "--style-dim", "2", "3", "3", "3", "--latent-dim", str(CD),
            "--batch-size", str(FOUR_BATCH), "--num-epochs", "5",
            "--use-tensorboard", "false", "--device", "cpu"]
    assert cli.main(argv) == 0
    run = next(d for d in os.listdir(out) if d.startswith("synthetic"))
    csv = pd.read_csv(os.path.join(out, run, "logs", "metrics.csv"))
    train = csv[csv.phase == "train"]
    kld = {m for m in train.metric if m.startswith("kld/")}
    assert len(kld) == 15 and "kld/clinical_mod2_mod3_rois" in kld
    loss = train[train.metric == "loss"].value.to_numpy()
    assert np.isfinite(csv.value).all() and loss[-4:].mean() < loss[:4].mean()
    ckpt = os.path.join(out, run, "checkpoints", "0004")
    with np.load(os.path.join(ckpt, "opt_state.npz")) as fh:
        assert int(fh["count"]) > 0
        assert fh["mu"].size == sum(
            np.load(os.path.join(ckpt, "model.npz"))[k].size
            for k in np.load(os.path.join(ckpt, "model.npz")).files)
    assert cli.main(["resume", "--dataset", "synthetic", "--datasetdir",
                     four_block, "--outdir", out, "--run", run,
                     "--num-epochs", "6", "--device", "cpu"]) == 0
    assert os.path.isfile(os.path.join(out, run, "checkpoints", "0005",
                                       "opt_state.npz"))
    csv = pd.read_csv(os.path.join(out, run, "logs", "metrics.csv"))
    assert csv[csv.phase == "train"].step.max() > train.step.max()
