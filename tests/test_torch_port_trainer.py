"""The port's `train` slice as a whole against the JAX package.

One epoch of ``train_one_epoch`` on a tiny synthetic cohort (full and
partial complete batches, full and partial clinical-only batches) is
rebuilt from the JAX package's own functions: its sampler and group order,
the port's noise, ``jax.value_and_grad`` of ``fused_loss_reference`` or
``presence_loss_split``, and ``flat_adam``. Params agree at rtol 1e-4 /
atol 1e-6 (float32; ``flat_adam`` writes its bias correction ``1 - b ** t``
where the kernels write ``1 - exp(t log b)``). The test pass is held to
``total_loss`` with injected noise, and the CLI-level runs (train, resume,
unported options, checkpoint durability) are checked on the CPU. The moe,
jsd and poe routes and the dropout masks get the same rebuild from
``method_loss_split`` / ``presence_loss_split`` with the port's noise and
masks, and a ``train_exp`` run each.
"""

import json
import os
import stat

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multivae_tpu.data import MissingModalitySampler as JaxSampler
from multivae_tpu.models import build_model as jax_build_model
from multivae_tpu.models import make_modalities as jax_make_modalities
from multivae_tpu.ops import fused_methods as jax_fm
from multivae_tpu.ops import fused_presence as jax_fp
from multivae_tpu.ops import fused_step as jax_fs
from multivae_tpu.train import trainer as jax_trainer
from multivae_tpu.train.losses import total_loss as jax_total_loss
from multivae_tpu.train.train_step import flat_adam
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch import workflows
from multivae_tpu_torch.data import make_synthetic_cohort
from multivae_tpu_torch.train import checkpoint, train_step, trainer
from multivae_tpu_torch.train.config import Config
from multivae_tpu_torch.train.experiment import MultimodalExperiment

pytestmark = pytest.mark.driver  # cross-framework parity pins

DIMS, HIDDEN, CD, STYLE, BATCH = (3, 12), 16, 4, (2, 3), 12
# 100 subjects, 20 without ROIs: 64 complete train subjects (5 full + 1
# partial batch of 12), 20 clinical-only (1 full + 1 partial), 16 test
N_SUBJECTS = 100


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cohort"))
    make_synthetic_cohort(d, n_subjects=N_SUBJECTS, n_scores=DIMS[0],
                          n_rois=DIMS[1], missing_rate=0.2, seed=1)
    return d


def make_cfg(datasetdir, outdir="", **kw):
    base = dict(dataset="synthetic", datasetdir=datasetdir,
                dir_experiment=outdir, input_dim=list(DIMS), class_dim=CD,
                style_dim=list(STYLE), hidden_dim=HIDDEN, batch_size=BATCH,
                end_epoch=1, initial_learning_rate=2e-3, seed=7)
    base.update(kw)
    return Config(**base).derive()


def make_exp(datasetdir, **kw):
    exp = MultimodalExperiment(make_cfg(datasetdir, **kw), "cpu")
    exp.set_datasets()
    exp.set_optimizers()
    return exp


def jax_model(cfg):
    return jax_build_model(cfg, jax_make_modalities(
        cfg.input_dim, cfg.style_dim, cfg.likelihood))


def rows(data):
    return len(next(iter(data.values())))


def test_one_epoch_matches_jax_rebuild(cohort):
    exp = make_exp(cohort)
    cfg, model = exp.cfg, exp.models[0]
    dims = bridge.dims_from(cfg, BATCH)
    p0 = exp.params[0].clone()
    steps = trainer.train_one_epoch(exp, 0, None,
                                    trainer.epoch_generator(cfg, 0, 0), 0)

    # ---- the same epoch from the JAX package's functions
    ds = exp.dataset_train
    batches = [ds.gather(i)[0] for i in
               JaxSampler(ds, batch_size=BATCH, seed=cfg.seed)]
    names = list(exp.mod_names)
    is_full = [rows(b) == BATCH and all(m in b for m in names)
               for b in batches]
    full = [b for b, f in zip(batches, is_full) if f]
    general = [b for b, f in zip(batches, is_full) if not f]
    widths = [CD + sum(STYLE[names.index(m)] for m in b) for b in
              full + general]
    noise = trainer.draw_noise(trainer.epoch_generator(cfg, 0, 0),
                               [(rows(b), w) for b, w in
                                zip(full + general, widths)], "cpu")
    groups = {}
    for i, b in enumerate(general):
        groups.setdefault((tuple(sorted(b)), rows(b)), []).append(i)
    order = [(b, noise[i]) for i, b in enumerate(full)]
    for key in jax_trainer.canonical_group_order(groups, names, BATCH):
        order += [(general[i], noise[len(full) + i]) for i in groups[key]]
    kinds = {(len(b), rows(b) == BATCH) for b, _ in order}
    assert kinds == {(1, True), (1, False), (2, True), (2, False)}
    assert steps == len(order) == len(batches)

    jm = jax_model(cfg)
    consts = jax_fs.FusedConsts(cfg.beta, cfg.beta_style, cfg.beta_content)
    params = jax.tree_util.tree_map(jnp.asarray, bridge.packed_to_tree(
        {k: v.numpy() for k, v in bridge.join_params(
            bridge.flat_views(p0, dims), dims).items()}, names))
    opt = flat_adam(cfg.initial_learning_rate, cfg.beta_1, cfg.beta_2)
    state = opt.init(params)
    for data, eps in order:
        eps = jnp.asarray(eps.numpy())
        jd = jax_fs.FusedDims(*bridge.dims_from(cfg, rows(data)))
        if len(data) == 2:
            def loss_fn(p):
                return jax_fs.fused_loss_reference(
                    jax_fs.flatten_params(p, jm), jnp.asarray(data[names[0]]),
                    jnp.asarray(data[names[1]]), eps[:, :CD],
                    eps[:, CD:CD + STYLE[0]], eps[:, CD + STYLE[0]:], jd,
                    consts, learn_scale=True)
        else:
            mod_idx = names.index(next(iter(data)))

            def loss_fn(p, mod_idx=mod_idx):
                sp = jax_fs.split_params(jax_fs.flatten_params(p, jm), jd)
                return jax_fp.presence_loss_split(
                    "joint_elbo", jd, consts, True, False, mod_idx, sp,
                    jnp.asarray(data[names[mod_idx]]), eps)[0]
        grads = jax.grad(loss_fn)(params)
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)

    want = bridge.flatten_split(bridge.split_params(
        {k: torch.from_numpy(np.array(v)) for k, v in
         bridge.flatten_params(params, names).items()}, dims))
    np.testing.assert_allclose(exp.params[0].numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-6)
    assert exp.opt_states[0].count == int(state.count) == steps
    np.testing.assert_allclose(
        bridge.split_flat_to_ravel(exp.opt_states[0].mu, dims, names),
        np.asarray(state.mu), rtol=1e-4, atol=1e-6)
    # the model holds the trained weights
    torch.testing.assert_close(bridge.model_flat_params(model, dims),
                               exp.params[0], rtol=0, atol=0)


ROUTES = [("moe", 0.0), ("jsd", 0.0), ("poe", 0.0), ("poe", 0.2),
          ("joint_elbo", 0.2), ("moe", 0.2), ("jsd", 0.2)]
ROUTE_IDS = [f"{m}-dropout{r}" for m, r in ROUTES]


@pytest.mark.parametrize("method,rate", ROUTES, ids=ROUTE_IDS)
def test_one_epoch_of_each_route_matches_jax_rebuild(cohort, method, rate):
    """One epoch of a method's kernel routes (plain versions on the CPU)
    against ``jax.grad`` of the JAX package's split losses and
    ``flat_adam``, fed the port's noise and masks; ``beta_style != 1``."""
    from multivae_tpu_torch.ops import adam, fused_methods, fused_presence
    from multivae_tpu_torch.ops import fused_step

    exp = make_exp(cohort, method=method, dropout_rate=rate, beta_style=0.7,
                   beta_content=1.2)
    cfg = exp.cfg
    dims = bridge.dims_from(cfg, BATCH)
    p0 = exp.params[0].clone()
    counters = (adam.KERNEL_LAUNCHES, fused_methods.KERNEL_LAUNCHES,
                fused_presence.KERNEL_LAUNCHES, fused_step.KERNEL_LAUNCHES)
    launches = [dict(c) for c in counters]
    steps = trainer.train_one_epoch(exp, 0, None,
                                    trainer.epoch_generator(cfg, 0, 2), 2)
    assert [dict(c) for c in counters] == launches  # plain on the CPU

    ds = exp.dataset_train
    batches = [ds.gather(i)[0] for i in
               JaxSampler(ds, batch_size=BATCH, seed=cfg.seed + 2)]
    names = list(exp.mod_names)
    is_full = [rows(b) == BATCH and all(m in b for m in names)
               for b in batches]
    emitted = ([b for b, f in zip(batches, is_full) if f]
               + [b for b, f in zip(batches, is_full) if not f])
    n_full = sum(is_full)
    noise = trainer.draw_noise(
        trainer.epoch_generator(cfg, 0, 2),
        [(rows(b), trainer.batch_noise_width(cfg, exp.models[0], b))
         for b in emitted], "cpu")
    masks = trainer.draw_masks(
        trainer.mask_generator(cfg, 0, 2),
        [(train_step.general_mask_count(cfg, b), rows(b), HIDDEN)
         for b in emitted], rate, "cpu")
    assert all((m is None) == (rate == 0.0) for m in masks)
    groups = {}
    for i, b in enumerate(emitted[n_full:]):
        groups.setdefault((tuple(sorted(b)), rows(b)), []).append(n_full + i)
    order = list(range(n_full))
    for key in jax_trainer.canonical_group_order(groups, names, BATCH):
        order += groups[key]
    assert steps == len(order) == len(batches)
    assert {(len(emitted[i]), rows(emitted[i]) == BATCH) for i in order} \
        == {(1, True), (1, False), (2, True), (2, False)}

    jm = jax_model(cfg)
    consts = jax_fs.FusedConsts(cfg.beta, cfg.beta_style, cfg.beta_content)
    params = jax.tree_util.tree_map(jnp.asarray, bridge.packed_to_tree(
        {k: v.numpy() for k, v in bridge.join_params(
            bridge.flat_views(p0, dims), dims).items()}, names))
    opt = flat_adam(cfg.initial_learning_rate, cfg.beta_1, cfg.beta_2)
    state = opt.init(params)
    for i in order:
        data = emitted[i]
        eps = jnp.asarray(noise[i].numpy())
        dm = None if masks[i] is None else tuple(
            jnp.asarray(m.numpy()) for m in masks[i])
        jd = jax_fs.FusedDims(*bridge.dims_from(cfg, rows(data)))

        def loss_fn(p, data=data, eps=eps, dm=dm, jd=jd):
            sp = jax_fs.split_params(jax_fs.flatten_params(p, jm), jd)
            if len(data) == 2:
                return jax_fm.method_loss_split(
                    method, jd, consts, True, False, sp,
                    jnp.asarray(data[names[0]]), jnp.asarray(data[names[1]]),
                    eps, dropout_masks=dm)[0]
            mod_idx = names.index(next(iter(data)))
            return jax_fp.presence_loss_split(
                method, jd, consts, True, False, mod_idx, sp,
                jnp.asarray(data[names[mod_idx]]), eps, dropout_masks=dm)[0]
        grads = jax.grad(loss_fn)(params)
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)

    want = bridge.flatten_split(bridge.split_params(
        {k: torch.from_numpy(np.array(v)) for k, v in
         bridge.flatten_params(params, names).items()}, dims))
    np.testing.assert_allclose(exp.params[0].numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert exp.opt_states[0].count == int(state.count) == steps


def test_masks_are_a_stream_of_their_own():
    """The mask stream is a function of (seed, member, epoch) apart from
    the noise's: a run with dropout draws the noise of a run without."""
    cfg = make_cfg("")
    shapes = [(2, 5, HIDDEN), (0, 5, HIDDEN), (1, 3, HIDDEN)]
    a = trainer.draw_masks(trainer.mask_generator(cfg, 0, 1), shapes, 0.25,
                           "cpu")
    b = trainer.draw_masks(trainer.mask_generator(cfg, 0, 1), shapes, 0.25,
                           "cpu")
    c = trainer.draw_masks(trainer.mask_generator(cfg, 0, 2), shapes, 0.25,
                           "cpu")
    assert a[1] is None and a[0].shape == (2, 5, HIDDEN)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[0], c[0])
    values = torch.cat([a[0].reshape(-1), a[2].reshape(-1)]).unique()
    np.testing.assert_allclose(values.numpy(), [0.0, 1.0 / 0.75], rtol=1e-6)
    gen = trainer.epoch_generator(cfg, 0, 1)
    mgen = trainer.mask_generator(cfg, 0, 1)
    assert gen.initial_seed() != mgen.initial_seed()
    assert trainer.draw_masks(mgen, [(0, 4, 2)], 0.25, "cpu") == [None]


def test_test_epoch_matches_jax_total_loss(cohort):
    exp = make_exp(cohort)
    cfg, model = exp.cfg, exp.models[0]
    got = trainer.test_one_epoch(exp, 0, None,
                                 trainer.epoch_generator(cfg, 0, 3), 3)
    order, emitted = trainer.test_batches(exp, 0, 3)
    noise = trainer.draw_noise(
        trainer.epoch_generator(cfg, 0, 3),
        [(rows(d), CD + sum(STYLE[exp.mod_names.index(m)] for m in d))
         for d in emitted], "cpu")
    assert len(got) == len(order) > 1
    jm = jax_model(cfg)
    variables = {"params": bridge.state_dict_to_tree(model.state_dict())}
    for metrics, (data, i) in zip(got, order):
        batch = {k: jnp.asarray(v.numpy()) for k, v in data.items()}
        out = jm.apply(variables, batch, noise=jnp.asarray(noise[i].numpy()))
        _, want = jax_total_loss(cfg, jm, variables, batch, out,
                                 jax.random.PRNGKey(0), train=False)
        assert sorted(metrics) == sorted(want)
        for k in want:
            np.testing.assert_allclose(metrics[k].numpy(),
                                       np.asarray(want[k]), rtol=5e-4,
                                       atol=1e-5, err_msg=k)


def test_general_path_matches_the_fused_path(cohort):
    """fused_training=False runs every batch through autograd of the model
    and total_loss, in the same order with the same noise."""
    fused, general = make_exp(cohort), make_exp(cohort,
                                                fused_training=False)
    for exp in (fused, general):
        trainer.train_one_epoch(exp, 0, None,
                                trainer.epoch_generator(exp.cfg, 0, 0), 0)
    np.testing.assert_allclose(general.params[0].numpy(),
                               fused.params[0].numpy(), rtol=1e-4,
                               atol=1e-6)
    assert general.opt_states[0].count == fused.opt_states[0].count


def test_general_path_takes_other_methods(cohort):
    exp = make_exp(cohort, method="moe", fused_training=False)
    p0 = exp.params[0].clone()
    trainer.train_one_epoch(exp, 0, None,
                            trainer.epoch_generator(exp.cfg, 0, 0), 0)
    assert torch.isfinite(exp.params[0]).all()
    assert not torch.equal(exp.params[0], p0)


def train(cohort, outdir, epochs, **kw):
    return workflows.train_exp(
        "synthetic", cohort, str(outdir), list(DIMS), latent_dim=CD,
        style_dim=list(STYLE), batch_size=BATCH, num_epochs=epochs,
        use_tensorboard=False, device="cpu", **kw)


def test_train_exp_writes_the_run(cohort, tmp_path, capsys):
    run = train(cohort, tmp_path, 2)
    rundir = tmp_path / run
    flags = json.loads((rundir / "flags.json").read_text())
    assert flags["end_epoch"] == 2 and flags["hidden_dim"] == 256
    for f in ("model.npz", "opt_state.npz"):
        assert (rundir / "checkpoints" / "0001" / f).is_file()
    for m in ("clinical", "rois"):
        assert (rundir / "checkpoints" / f"enc_{m}.npz").is_file()
    assert (tmp_path / "runs.tsv").read_text().count(run) == 1
    import pandas as pd
    csv = pd.read_csv(rundir / "logs" / "metrics.csv")
    train_metrics = set(csv[csv.phase == "train"].metric)
    # the complete routes' and the clinical-only route's families
    assert {"loss", "joint_divergence", "log_prob/clinical",
            "log_prob/rois", "kld/clinical_rois", "kld_style/rois_style",
            "latent_logvar/clinical_style"} <= train_metrics
    assert set(csv[csv.phase == "test"].metric) >= {"loss",
                                                    "log_prob/rois"}
    assert np.isfinite(csv.value).all()
    walls = [ln for ln in capsys.readouterr().out.splitlines()
             if "train wall per epoch (s):" in ln]
    assert len(walls[-1].split(":", 1)[1].split()) == 2
    with np.load(rundir / "checkpoints" / "0001" / "opt_state.npz") as fh:
        assert int(fh["count"]) > 0
        assert fh["mu"].shape == fh["nu"].shape


def test_resume_continues_exactly(cohort, tmp_path):
    straight = train(cohort, tmp_path / "a", 3)
    split = train(cohort, tmp_path / "b", 2)
    workflows.resume_exp("synthetic", cohort, str(tmp_path / "b"), split, 3,
                         use_tensorboard=False, device="cpu")
    for f in ("model.npz", "opt_state.npz"):
        with np.load(tmp_path / "a" / straight / "checkpoints" / "0002"
                     / f) as a, \
                np.load(tmp_path / "b" / split / "checkpoints" / "0002"
                        / f) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


UNPORTED = [
    # past the layer-stack step's caps (a depth of 9, kMaxDepth is 8), where
    # the full complete batches of these configs would take that step
    dict(likelihood="laplace", num_hidden_layer_encoder=9),
    dict(factorized_representation=False, num_hidden_layer_decoder=9),
    dict(out_scale_per_subject=True, num_hidden_layer_encoder=9),
]


@pytest.mark.parametrize("kw", UNPORTED, ids=lambda kw: ",".join(kw))
def test_unported_options_raise(cohort, tmp_path, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train(cohort, tmp_path, 1, **kw)
    assert not (tmp_path / "runs.tsv").exists()


# options the port refused before it had the row-sharded general step,
# tensor parallelism and tracing: (kw, the step every batch takes, members)
ROUTED = [
    (dict(likelihood="bernoulli", data_parallel=2), "dp_general_step", 1),
    (dict(num_hidden_layer_decoder=1, data_parallel=2), "dp_general_step",
     1),
    (dict(data_parallel=2, fused_training=False), "dp_general_step", 1),
    (dict(tensor_parallel=2), "tp_step", 1),
    (dict(num_models=2, tensor_parallel=2), "tp_step", 2),
    (dict(profile_dir="trace"), None, 1),
]


@pytest.mark.parametrize("kw,step,members", ROUTED,
                         ids=[",".join(kw) for kw, _, _ in ROUTED])
def test_formerly_refused_options_train(cohort, tmp_path, monkeypatch, kw,
                                        step, members, capsys):
    """Each option trains on its route: per epoch every batch (rows 12, 4,
    12 and 8, each a multiple of 2) takes ``step``, the members in turn,
    and no step kernel and no unsharded general step runs. ``profile_dir``
    traces the first epoch on the kernels' routes (their plain versions
    here): a Chrome trace that parses as JSON and holds the epoch's
    products."""
    from multivae_tpu_torch.ops import (fused_generic, fused_methods,
                                        fused_presence, fused_sharded,
                                        fused_step)

    calls = {}

    def spy(module, name):
        fn = getattr(module, name)
        calls[name] = 0

        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)

    for name in ("dp_general_step", "tp_step", "general_step"):
        spy(trainer, name)
    kernels = ((fused_step, "epoch_flat"),
               (fused_methods, "method_epoch_flat"),
               (fused_presence, "presence_epoch_flat"),
               (fused_generic, "generic_epoch_flat"),
               (fused_sharded, "dp_step_flat"))
    for module, name in kernels:
        spy(module, name)
    if "profile_dir" in kw:
        kw = dict(kw, profile_dir=str(tmp_path / "trace"))
    epochs = 2
    run = train(cohort, tmp_path / "out", epochs, **kw)
    rundir = tmp_path / "out" / run
    for m in range(members):
        sub = f"model_{m}/" if members > 1 else ""
        assert np.isfinite(train_losses(rundir, sub)).all()
    assert (rundir / "checkpoints" / (
        "model_0/0001" if members > 1 else "0001") / "model.npz").is_file()
    if step is None:
        with open(tmp_path / "trace" / "epoch_0000.pt.trace.json") as fh:
            events = json.load(fh)["traceEvents"]
        names = {e.get("name") for e in events}
        assert {"aten::mm", "aten::addmm", "aten::matmul"} & names
        assert calls["epoch_flat"] == epochs * 2
        return
    assert "ensemble of" not in capsys.readouterr().out
    if members == 1:
        assert calls[step] == 8 * epochs
    else:   # each member's fold has its own batches
        assert calls[step] > 8 * epochs
    for name, n in calls.items():
        assert n == 0 or name == step, (name, n)


@pytest.mark.parametrize("method,rate", ROUTES, ids=ROUTE_IDS)
def test_train_exp_runs_each_route(cohort, tmp_path, method, rate):
    """The slice as a whole on the CPU: ``train_exp`` of each method runs
    the plain versions, launches no kernel and logs each route's metric
    families."""
    import pandas as pd

    from multivae_tpu_torch.ops import adam, fused_methods, fused_presence
    from multivae_tpu_torch.ops import fused_step

    counters = (adam.KERNEL_LAUNCHES, fused_methods.KERNEL_LAUNCHES,
                fused_presence.KERNEL_LAUNCHES, fused_step.KERNEL_LAUNCHES)
    launches = [dict(c) for c in counters]
    run = train(cohort, tmp_path, 2, method=method, dropout_rate=rate)
    assert [dict(c) for c in counters] == launches
    rundir = tmp_path / run
    flags = json.loads((rundir / "flags.json").read_text())
    assert flags["method"] == method and flags["dropout_rate"] == rate
    csv = pd.read_csv(rundir / "logs" / "metrics.csv")
    assert np.isfinite(csv.value).all()
    per_step = csv[csv.phase == "train"].groupby("step").metric.apply(
        frozenset)
    model = MultimodalExperiment(make_cfg(cohort, method=method),
                                 "cpu").models[0]
    from multivae_tpu_torch.ops.fused_methods import method_metric_names
    from multivae_tpu_torch.ops.fused_presence import presence_metric_names
    complete = frozenset(method_metric_names(model, method))
    clinical = frozenset(presence_metric_names(model, method, 0))
    assert ("log_prob_uni/clinical" in complete) == (method == "poe")
    # per epoch: 6 complete steps and 2 clinical-only steps
    assert sum(s == complete for s in per_step) == 12
    assert sum(s == clinical for s in per_step) == 4
    for f in ("model.npz", "opt_state.npz"):
        assert (rundir / "checkpoints" / "0001" / f).is_file()


def test_resume_restores_the_route_and_the_mask_stream(cohort, tmp_path):
    """A resumed poe run with dropout ends where the uninterrupted one
    does: same route, same noise and mask streams."""
    kw = dict(method="poe", dropout_rate=0.2)
    straight = train(cohort, tmp_path / "a", 3, **kw)
    split = train(cohort, tmp_path / "b", 2, **kw)
    workflows.resume_exp("synthetic", cohort, str(tmp_path / "b"), split, 3,
                         use_tensorboard=False, device="cpu")
    for f in ("model.npz", "opt_state.npz"):
        with np.load(tmp_path / "a" / straight / "checkpoints" / "0002"
                     / f) as a, \
                np.load(tmp_path / "b" / split / "checkpoints" / "0002"
                        / f) as b:
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_checkpoint_fsyncs_the_directory(tmp_path, monkeypatch):
    events = []
    real_fsync, real_replace = os.fsync, os.replace

    def fsync(fd):
        kind = "dir" if stat.S_ISDIR(os.fstat(fd).st_mode) else "file"
        events.append(("fsync", kind))
        real_fsync(fd)

    def replace(src, dst):
        events.append(("replace", os.path.basename(dst)))
        real_replace(src, dst)

    monkeypatch.setattr(checkpoint.os, "fsync", fsync)
    monkeypatch.setattr(checkpoint.os, "replace", replace)
    cfg = make_cfg("")
    exp = MultimodalExperiment(cfg, "cpu")
    dims = bridge.dims_from(cfg, BATCH)
    exp.set_optimizers()
    checkpoint.save_checkpoint(str(tmp_path / "0004"), exp.models[0],
                               exp.opt_states[0], dims=dims)
    assert events == [("fsync", "file"), ("replace", "opt_state.npz"),
                      ("fsync", "dir"), ("fsync", "file"),
                      ("replace", "model.npz"), ("fsync", "dir")]
    restored = checkpoint.restore_opt_state(str(tmp_path / "0004"), dims,
                                            exp.mod_names, "cpu")
    assert restored.count == 0 and torch.equal(restored.mu,
                                               exp.opt_states[0].mu)


def test_epoch_generator_is_a_function_of_seed_member_epoch():
    cfg = make_cfg("")
    draw = lambda *a: torch.randn(5, generator=trainer.epoch_generator(*a))
    assert torch.equal(draw(cfg, 0, 3), draw(cfg, 0, 3))
    assert not torch.equal(draw(cfg, 0, 3), draw(cfg, 0, 4))
    assert not torch.equal(draw(cfg, 0, 3), draw(cfg, 1, 3))


def test_canonical_group_order_matches_jax():
    keys = {(("clinical",), 8), (("clinical", "rois"), 12),
            (("clinical", "rois"), 4), (("clinical",), 12),
            (("rois",), 3)}
    names = ["clinical", "rois"]
    assert (trainer.canonical_group_order(keys, names, 12)
            == jax_trainer.canonical_group_order(keys, names, 12))


def test_ensemble_members_train_in_turn(cohort, tmp_path):
    """``num_models > 1`` trains each member on its fold, in turn, with
    per-member logs and checkpoints (the sequential member loop)."""
    run = train(cohort, tmp_path, 1, num_models=2)
    rundir = tmp_path / run
    states = []
    for m in range(2):
        ckpt = rundir / "checkpoints" / f"model_{m}" / "0000"
        assert (ckpt / "model.npz").is_file()
        assert (ckpt / "opt_state.npz").is_file()
        assert (rundir / "logs" / f"model_{m}" / "metrics.csv").is_file()
        with np.load(ckpt / "model.npz") as fh:
            states.append(fh["enc_rois/heads/kernel"])
    assert not np.array_equal(*states)


# ------------------------------------------- data-parallel and ensemble runs
def run_arrays(rundir, sub=""):
    out = {}
    for f in ("model.npz", "opt_state.npz"):
        with np.load(rundir / "checkpoints" / sub / f) as fh:
            out.update({f"{f}:{k}": fh[k] for k in fh.files})
    return out


def train_losses(rundir, sub=""):
    import pandas as pd

    csv = pd.read_csv(rundir / "logs" / sub / "metrics.csv")
    tr = csv[(csv.phase == "train") & (csv.metric == "loss")]
    return tr.sort_values("step").value.to_numpy()


@pytest.mark.parametrize("method,rate", [("joint_elbo", 0.0), ("poe", 0.2),
                                         ("jsd", 0.0)])
def test_data_parallel_matches_single_device(cohort, tmp_path, method, rate):
    """``data_parallel=4`` against ``data_parallel=1`` from one seed: the
    same noise and masks, row-sliced, so the runs agree to the order of the
    sums (the bounds of ``tests/test_fused_sharded.py:81-84``)."""
    kw = dict(method=method, dropout_rate=rate)
    one = tmp_path / "one" / train(cohort, tmp_path / "one", 1, **kw)
    dp = tmp_path / "dp" / train(cohort, tmp_path / "dp", 1,
                                 data_parallel=4, **kw)
    assert json.loads((dp / "flags.json").read_text())["data_parallel"] == 4
    a, b = train_losses(one), train_losses(dp)
    assert len(a) == len(b) == 8
    np.testing.assert_allclose(b, a, rtol=2e-5)
    one_arrays, dp_arrays = run_arrays(one, "0000"), run_arrays(dp, "0000")
    assert sorted(one_arrays) == sorted(dp_arrays)
    for k, v in one_arrays.items():
        assert np.abs(dp_arrays[k] - v).max() < 1e-5, k


@pytest.mark.parametrize("method,rate,slice_fn,whole_fn", [
    ("joint_elbo", 0.0, "slice_step_flat", "step_flat"),
    ("moe", 0.0, "slice_method_step_flat", "method_step_flat"),
    ("poe", 0.2, "slice_method_step_flat", "method_step_flat")])
def test_data_parallel_routes(cohort, tmp_path, monkeypatch, method, rate,
                              slice_fn, whole_fn):
    """Per epoch: the 5 full complete batches take 4 row-slice steps each,
    the partial complete batch the unsharded step, the 2 clinical-only
    batches the presence step, and every batch one Adam update."""
    from multivae_tpu_torch.ops import (fused_methods, fused_presence,
                                        fused_sharded, fused_step)

    calls = {}

    def spy(module, name):
        fn = getattr(module, name)

        def counted(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(module, name, counted)

    whole_mod = fused_step if whole_fn == "step_flat" else fused_methods
    spy(fused_sharded, slice_fn)
    spy(whole_mod, whole_fn)
    spy(fused_presence, "presence_step_flat")
    for module in (fused_sharded, whole_mod, fused_presence):
        spy(module, "adam_update")
    train(cohort, tmp_path, 2, method=method, dropout_rate=rate,
          data_parallel=4)
    assert calls == {slice_fn: 2 * 5 * 4, whole_fn: 2 * 1,
                     "presence_step_flat": 2 * 2, "adam_update": 2 * 8}


@pytest.mark.parametrize("kw,members", [
    (dict(), 1), (dict(data_parallel=4), 1),
    (dict(num_models=2, ensemble_parallel=True), 2)],
    ids=["flagship", "data_parallel", "ensemble"])
def test_groups_per_epoch_take_one_epoch_call_each(cohort, tmp_path,
                                                   monkeypatch, kw, members):
    """Per ``joint_elbo`` epoch the trainer hands each ``(presence pattern,
    rows)`` group to ONE call of its epoch entry point (on a card: one
    launch of the persistent kernel, Adam inside): the 5 full complete
    batches and the partial one to ``epoch_flat`` (2 calls for 6 steps), the
    clinical-only groups to ``presence_epoch_flat`` (2 calls for 2 steps).
    Under ``data_parallel`` the full batches take the sharded step instead,
    one call a batch (4 row-slice steps and one Adam update each). On the
    CPU those calls loop the plain step; no launch is counted."""
    from multivae_tpu_torch.ops import (adam, fused_presence, fused_sharded,
                                        fused_step)

    calls = {"epoch_flat": [], "presence_epoch_flat": [], "dp_step_flat": 0}

    def spy_epoch(module, name):
        fn = getattr(module, name)

        def counted(p, mu, nu, count, xs, *args, **kwargs):
            calls[name].append(int(xs.shape[0]))
            return fn(p, mu, nu, count, xs, *args, **kwargs)
        monkeypatch.setattr(module, name, counted)

    spy_epoch(fused_step, "epoch_flat")
    spy_epoch(fused_presence, "presence_epoch_flat")
    dp_fn = fused_sharded.dp_step_flat

    def dp_counted(*args, **kwargs):
        calls["dp_step_flat"] += 1
        return dp_fn(*args, **kwargs)
    monkeypatch.setattr(fused_sharded, "dp_step_flat", dp_counted)
    counters = (adam.KERNEL_LAUNCHES, fused_presence.KERNEL_LAUNCHES,
                fused_presence.KERNEL_STEPS, fused_step.KERNEL_LAUNCHES,
                fused_step.KERNEL_STEPS)
    before = [dict(c) for c in counters]
    epochs = 2
    train(cohort, tmp_path, epochs, **kw)
    dp = kw.get("data_parallel", 1) > 1
    per_epoch = [1] if dp else [5, 1]
    assert calls["epoch_flat"] == per_epoch * (epochs * members)
    assert calls["presence_epoch_flat"] == [1, 1] * (epochs * members)
    assert calls["dp_step_flat"] == (5 * epochs if dp else 0)
    assert [dict(c) for c in counters] == before


def test_batch_size_not_a_multiple_of_data_parallel_raises(cohort, tmp_path):
    with pytest.raises(ValueError, match="multiple of data_parallel"):
        train(cohort, tmp_path, 1, data_parallel=5)


@pytest.mark.parametrize("kw", [dict(), dict(method="poe", dropout_rate=0.2),
                                dict(data_parallel=2)],
                         ids=["joint_elbo", "poe-dropout", "data_parallel"])
def test_ensemble_parallel_is_the_sequential_run(cohort, tmp_path, kw):
    """``ensemble_parallel=True`` (epochs outermost, members inside) gives
    every member the sequential loop's params, moments and logs, bit for
    bit."""
    runs = {}
    for parallel in (True, False):
        out = tmp_path / str(parallel)
        runs[parallel] = out / train(cohort, out, 2, num_models=2,
                                     ensemble_parallel=parallel, **kw)
    for m in range(2):
        a = run_arrays(runs[True], f"model_{m}/0001")
        b = run_arrays(runs[False], f"model_{m}/0001")
        assert sorted(a) == sorted(b) and len(a) > 10
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(
            train_losses(runs[True], f"model_{m}"),
            train_losses(runs[False], f"model_{m}"))
        assert (runs[True] / "checkpoints" / f"model_{m}"
                / "enc_rois.npz").is_file()


RESOLVE = [
    # num_models, ensemble_parallel, tensor_parallel, cards, fused -> runner
    (1, True, 1, 4, True, False),      # one member: nothing to drive
    (2, True, 2, 4, True, False),      # the ensemble runners are not TP-aware
    (2, True, 1, 1, True, True),
    (2, False, 1, 4, True, False),
    (2, "auto", 1, 4, True, True),     # the members spread over the cards
    (2, "auto", 1, 2, True, True),
    (3, "auto", 1, 4, True, False),    # 4 cards, 3 members: kernel loop
    (2, "auto", 1, 1, True, False),    # one card: the kernel loop
    (2, "auto", 1, 0, True, False),
    (2, "auto", 1, 1, False, True),    # no kernel route anyway
]


@pytest.mark.parametrize("n,parallel,tp,cards,fused,want", RESOLVE)
def test_resolve_ensemble(monkeypatch, n, parallel, tp, cards, fused, want):
    cfg = make_cfg("", num_models=n, ensemble_parallel=parallel,
                   tensor_parallel=tp, fused_training=fused)
    monkeypatch.setattr(trainer, "visible_cards",
                        lambda: [torch.device("cuda", i)
                                 for i in range(cards)])
    monkeypatch.setattr(trainer, "make_mesh",
                        lambda n_model, n_data: (n_model, n_data))
    model = MultimodalExperiment(cfg, "cpu").models[0]
    assert trainer.resolve_ensemble(cfg, model) is want
    mesh = trainer.ensemble_mesh(cfg)
    if cards > 1 and cards % n == 0:
        assert mesh == (n, cards // n)
    else:
        assert mesh is None
    # the JAX package's table, with the card count for its device count
    monkeypatch.setattr(jax_trainer.jax, "devices", lambda: [None] * cards)
    monkeypatch.setattr(jax_trainer, "ensemble_mesh",
                        lambda c: mesh if cards > 1 else None)
    assert jax_trainer.resolve_ensemble(cfg, jax_model(cfg)) is want


@pytest.mark.parametrize("n_samples", [6, 5])
@pytest.mark.parametrize("method", ["joint_elbo", "jsd"])
def test_avatar_sweep_sharded_equals_avatar_sweep(method, n_samples):
    """Over a 4-entry mesh: 18 cells need 2 pad cells, 15 cells one."""
    from multivae_tpu_torch.analysis import daa
    from multivae_tpu_torch.parallel import data_mesh

    cfg = make_cfg("", method=method)
    model = MultimodalExperiment(cfg, "cpu").models[0]
    rng = np.random.default_rng(3)
    b = 9
    data = {"clinical": torch.from_numpy(
        rng.normal(size=(b, DIMS[0])).astype(np.float32)),
        "rois": torch.from_numpy(
            rng.normal(size=(b, DIMS[1])).astype(np.float32))}
    scores = torch.from_numpy(
        rng.normal(size=(n_samples, b, DIMS[0])).astype(np.float32))
    mesh = data_mesh(4, [torch.device("cpu")] * 4)
    assert (n_samples * DIMS[0]) % 4 != 0
    for sample in (True, False):
        want = daa.avatar_sweep(model, data, scores, sample,
                                torch.Generator().manual_seed(5), cfg)
        got = daa.avatar_sweep_sharded(model, data, scores, sample,
                                       torch.Generator().manual_seed(5),
                                       mesh, cfg)
        assert got.shape == want.shape == (b, DIMS[0], n_samples, DIMS[1])
        assert torch.equal(got, want)


# ------------------------------------------------ deep-architecture configs
DEEP_CASES = {
    "deep-A": dict(num_hidden_layer_decoder=1,
                   learn_output_sample_scale=True),
    "deep-B": dict(num_hidden_layer_encoder=2, num_hidden_layer_decoder=1,
                   dropout_rate=0.2, method="poe"),
}


@pytest.mark.parametrize("case", list(DEEP_CASES))
def test_deep_config_routes(cohort, monkeypatch, case):
    """An architecture outside the split layout sends its full complete
    batches to the layer-stack step (one epoch call) and every other batch
    (the partial complete batch, the clinical-only batches) to the general
    autograd step, with the kernel route's masks; on the CPU no kernel is
    launched."""
    from multivae_tpu_torch.ops import (adam, fused_generic, fused_methods,
                                        fused_presence, fused_step)

    exp = make_exp(cohort, **DEEP_CASES[case])
    cfg, model = exp.cfg, exp.models[0]
    example = {m: None for m in exp.mod_names}
    assert not fused_methods.supports_method_fused(cfg, model, example)
    assert fused_generic.supports_generic_fused(cfg, model, example)
    assert isinstance(bridge.dims_from(cfg, BATCH), bridge.GenericDims)
    assert trainer.make_generic_epoch(cfg, model) is not None
    assert trainer.make_generic_epoch(make_cfg(cohort),
                                      make_exp(cohort).models[0]) is None

    calls = {"generic": [], "general": []}
    step_fn, general_fn = (fused_generic.generic_step_flat,
                           trainer.general_step)

    def generic_step(method, p, xs, noise, dims, consts, learn_scale,
                     masks=None, **kw):
        calls["generic"].append((len(xs[0]), None if masks is None
                                 else tuple(masks.shape)))
        return step_fn(method, p, xs, noise, dims, consts, learn_scale,
                       masks, **kw)

    def general_step(cfg_, model_, p, opt, batch, noise, dims, hyper,
                     masks=None):
        calls["general"].append((tuple(sorted(batch)), rows(batch),
                                 None if masks is None else len(masks)))
        return general_fn(cfg_, model_, p, opt, batch, noise, dims, hyper,
                          masks)

    monkeypatch.setattr(fused_generic, "generic_step_flat", generic_step)
    monkeypatch.setattr(trainer, "general_step", general_step)
    counters = (adam.KERNEL_LAUNCHES, fused_generic.KERNEL_LAUNCHES,
                fused_methods.KERNEL_LAUNCHES,
                fused_presence.KERNEL_LAUNCHES, fused_step.KERNEL_LAUNCHES)
    launches = [dict(c) for c in counters]
    p0 = exp.params[0].clone()
    steps = trainer.train_one_epoch(exp, 0, None,
                                    trainer.epoch_generator(cfg, 0, 0), 0)
    assert [dict(c) for c in counters] == launches
    n_enc, n_dec = cfg.num_hidden_layer_encoder, cfg.num_hidden_layer_decoder
    passes = 2 if cfg.method == "poe" else 1
    per_net = (n_enc + n_dec) * passes if cfg.dropout_rate else None
    full_masks = None if per_net is None else (2 * per_net, BATCH, HIDDEN)
    # 64 complete train subjects: 5 full batches of 12 on the kernel route
    assert calls["generic"] == [(BATCH, full_masks)] * 5
    # the partial complete batch and the two clinical-only batches
    assert sorted(calls["general"]) == sorted([
        (("clinical", "rois"), 4, None if per_net is None else 2 * per_net),
        (("clinical",), BATCH, per_net), (("clinical",), 8, per_net)])
    assert steps == 8 and exp.opt_states[0].count == 8
    assert torch.isfinite(exp.params[0]).all()
    assert not torch.equal(exp.params[0], p0)
    # fused_training=False: every batch takes the general step, same update
    calls["generic"].clear(), calls["general"].clear()
    general = make_exp(cohort, fused_training=False, **DEEP_CASES[case])
    trainer.train_one_epoch(general, 0, None,
                            trainer.epoch_generator(general.cfg, 0, 0), 0)
    assert not calls["generic"] and len(calls["general"]) == 8
    np.testing.assert_allclose(general.params[0].numpy(),
                               exp.params[0].numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method", ["joint_elbo", "poe"])
def test_general_path_with_dropout_matches_the_fused_path(cohort, method):
    """Dropout in the general step: ``fused_training=False`` takes the
    kernel routes' masks, so the two paths make the same updates."""
    kw = dict(method=method, dropout_rate=0.2)
    fused, general = make_exp(cohort, **kw), make_exp(
        cohort, fused_training=False, **kw)
    for exp in (fused, general):
        trainer.train_one_epoch(exp, 0, None,
                                trainer.epoch_generator(exp.cfg, 0, 0), 0)
    np.testing.assert_allclose(general.params[0].numpy(),
                               fused.params[0].numpy(), rtol=1e-4,
                               atol=1e-5)
    # and the masks matter: the run without dropout ends elsewhere
    plain = make_exp(cohort, method=method, fused_training=False)
    trainer.train_one_epoch(plain, 0, None,
                            trainer.epoch_generator(plain.cfg, 0, 0), 0)
    assert not np.allclose(plain.params[0].numpy(),
                           general.params[0].numpy(), atol=1e-4)


DEEP_TRAIN = {
    "deep-A": dict(num_hidden_layer_decoder=1, out_scale_per_subject=True),
    "deep-B": dict(num_hidden_layer_encoder=2, num_hidden_layer_decoder=1,
                   dropout_rate=0.2, method="poe"),
}


@pytest.mark.parametrize("case", list(DEEP_TRAIN))
def test_train_exp_trains_and_resumes_a_deep_config(cohort, tmp_path, case):
    """``train_exp`` of a deep config on the CPU: a falling loss, the metric
    families of both routes, checkpoints of the deep tree (``opt_state.npz``
    in the JAX package's ravel order), and a resumed run that ends where the
    uninterrupted one does."""
    import pandas as pd

    from multivae_tpu_torch.ops.fused_generic import generic_metric_names
    from multivae_tpu_torch.ops.fused_presence import presence_metric_names

    kw = DEEP_TRAIN[case]
    straight = train(cohort, tmp_path / "a", 4, **kw)
    rundir = tmp_path / "a" / straight
    flags = json.loads((rundir / "flags.json").read_text())
    assert flags["num_hidden_layer_decoder"] == 1
    csv = pd.read_csv(rundir / "logs" / "metrics.csv")
    assert np.isfinite(csv.value).all()
    tr = csv[csv.phase == "train"]
    losses = tr[tr.metric == "loss"].sort_values("step").value.to_numpy()
    assert len(losses) == 32 and losses[-8:].mean() < losses[:8].mean()
    cfg = Config.load(str(rundir / "flags.json"))
    model = MultimodalExperiment(cfg, "cpu").models[0]
    per_step = tr.groupby("step").metric.apply(frozenset)
    complete = frozenset(generic_metric_names(model, cfg.method))
    clinical = frozenset(presence_metric_names(model, cfg.method, 0))
    assert ("log_prob_uni/rois" in complete) == (cfg.method == "poe")
    assert sum(s == complete for s in per_step) == 24
    assert sum(s == clinical for s in per_step) == 8
    n_params = sum(p.numel() for p in model.parameters())
    with np.load(rundir / "checkpoints" / "0003" / "opt_state.npz") as fh:
        assert int(fh["count"]) == 32
        assert fh["mu"].shape == fh["nu"].shape == (n_params,)
    tree = checkpoint.load_tree(str(rundir / "checkpoints" / "0003"
                                    / "model.npz"))
    out = "out_heads" if case == "deep-A" else "out_mu"
    assert set(tree["dec_rois"]) >= {"hidden_0", out}

    split = train(cohort, tmp_path / "b", 2, **kw)
    workflows.resume_exp("synthetic", cohort, str(tmp_path / "b"), split, 4,
                         use_tensorboard=False, device="cpu")
    for f in ("model.npz", "opt_state.npz"):
        with np.load(rundir / "checkpoints" / "0003" / f) as a, \
                np.load(tmp_path / "b" / split / "checkpoints" / "0003"
                        / f) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_resolve_ensemble_counts_the_generic_route(cohort, monkeypatch):
    """``ensemble_parallel="auto"`` on one card keeps the sequential loop
    for a config the layer-stack step serves, as the JAX package does."""
    monkeypatch.setattr(trainer, "visible_cards", lambda: ["cuda:0"])
    for kw, want in ((dict(num_hidden_layer_decoder=1), False),
                     (dict(num_hidden_layer_decoder=1,
                           fused_training=False), True)):
        cfg = make_cfg(cohort, num_models=2, **kw)
        model = MultimodalExperiment(cfg, "cpu").models[0]
        assert trainer.resolve_ensemble(cfg, model) is want
