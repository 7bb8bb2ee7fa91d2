"""The route table (``multivae_tpu_torch/train/routes.py``): which step, in
which precision, takes an epoch's full complete batches, a partial
complete group and each single-present group, for every route the trainer
has; and that a run builds its routes once."""

import numpy as np
import pytest

from multivae_tpu_torch import workflows
from multivae_tpu_torch.data import make_synthetic_cohort
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.ops import fused_generic
from multivae_tpu_torch.train import routes, trainer
from multivae_tpu_torch.train.config import Config
from multivae_tpu_torch.train.routes import (
    AUTOGRAD,
    DP_AUTOGRAD,
    LAYER_STACK,
    METHOD,
    MOPOE,
    PRESENCE,
    ROW_SLICE,
    TENSOR,
)

DIMS, STYLE, BATCH = (3, 12), (2, 3), 12
BF, F32 = "bfloat16", "float32"
N_FULL, BF16_FULL = 5, 2   # an epoch's full batches; the ensemble's prefix
# (rows of the partial complete group, of each single-present group): the
# data-parallel general step shards 12 rows over 2 entries, not 7 or 5
PARTIAL, SINGLE = 7, {"clinical": 12, "rois": 5}


def make_cfg(**kw):
    base = dict(input_dim=list(DIMS), style_dim=list(STYLE), class_dim=4,
                hidden_dim=16, batch_size=BATCH, seed=7)
    base.update(kw)
    return Config(**base).derive()


def make_model(cfg):
    return build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                            cfg.likelihood), "cpu")


def kernels(full, partial, single, parts=None):
    """A case's table: ``full`` the full batches' ``(step, precision)``, or
    ``parts`` their ``(lo, hi, step, precision)`` runs."""
    return dict(parts=parts or [(0, N_FULL) + full], partial=partial,
                single=single)


def same(step, precision=None):
    return kernels((step, precision), (step, precision),
                   (step, precision))


CASES = {
    # kw, ensemble (None: the sequential loop), the table
    "flagship": (dict(), None, kernels(
        (MOPOE, F32), (MOPOE, F32), (PRESENCE, F32))),
    "flagship-bf16": (dict(precision=BF), None, kernels(
        (MOPOE, BF), (METHOD, BF), (PRESENCE, BF))),
    "moe": (dict(method="moe"), None, kernels(
        (METHOD, F32), (METHOD, F32), (PRESENCE, F32))),
    "jsd": (dict(method="jsd"), None, kernels(
        (METHOD, F32), (METHOD, F32), (PRESENCE, F32))),
    "poe": (dict(method="poe"), None, kernels(
        (METHOD, F32), (METHOD, F32), (PRESENCE, F32))),
    "poe-dropout": (dict(method="poe", dropout_rate=0.2), None, kernels(
        (METHOD, F32), (METHOD, F32), (PRESENCE, F32))),
    "deep": (dict(num_hidden_layer_decoder=1), None, kernels(
        (LAYER_STACK, None), (AUTOGRAD, None), (AUTOGRAD, None))),
    "four-blocks": (dict(input_dim=[3, 4, 4, 4], style_dim=[2, 3, 3, 3]),
                    None, kernels((LAYER_STACK, None), (AUTOGRAD, None),
                                  (AUTOGRAD, None))),
    "unfused": (dict(fused_training=False), None, same(AUTOGRAD)),
    "data-parallel-bf16": (dict(method="moe", data_parallel=2,
                                precision=BF), None, kernels(
        (ROW_SLICE, BF), (METHOD, F32), (PRESENCE, F32))),
    "data-parallel-deep": (dict(num_hidden_layer_decoder=1, data_parallel=2),
                           None, kernels(
        (DP_AUTOGRAD, None), (AUTOGRAD, None),
        {"clinical": (DP_AUTOGRAD, None), "rois": (AUTOGRAD, None)})),
    "tensor-parallel": (dict(tensor_parallel=2), None, same(TENSOR)),
    "ensemble-spread-bf16": (dict(precision=BF, data_parallel=2), True,
                             kernels(None, (MOPOE, F32), (PRESENCE, F32),
                                     [(0, BF16_FULL, MOPOE, BF),
                                      (BF16_FULL, N_FULL, MOPOE, F32)])),
    "ensemble-one-card-bf16": (dict(precision=BF), False, kernels(
        (MOPOE, F32), (MOPOE, F32), (PRESENCE, F32))),
    "past-the-caps": (dict(num_hidden_layer_decoder=fused_generic.MAX_DEPTH
                           + 1), None, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_route_table(case):
    kw, ensemble, want = CASES[case]
    cfg = make_cfg(**kw)
    model = make_model(cfg)
    if want is None:
        gaps = routes.Routes(cfg, model).gaps
        assert len(gaps) == 1 and "ROADMAP Queue 2 item 2" in gaps[0]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            routes.Routes(cfg, model, "cpu")
        return
    table = routes.Routes(cfg, model, "cpu", ensemble)
    assert table.gaps == []
    bf16_full = None if ensemble is None else BF16_FULL
    parts = table.full_parts(N_FULL, bf16_full)
    assert [(lo, hi, s.name, s.precision) for lo, hi, s in parts] == \
        want["parts"]
    steps = {"partial": table.group((table.full_key[0], PARTIAL),
                                    bf16_full)}
    for mod in model.mod_names:
        steps[mod] = table.group(((mod,), SINGLE.get(mod, 5)), bf16_full)
    single = want["single"]
    assert (steps["partial"].name, steps["partial"].precision) == \
        want["partial"]
    for mod in model.mod_names:
        got = (steps[mod].name, steps[mod].precision)
        assert got == (single[mod] if isinstance(single, dict) else single)
    for step in [s for _, _, s in parts] + list(steps.values()):
        # a kernel group is one epoch call; a general step one per batch
        assert (step.epoch is None) == (step.name in (AUTOGRAD, DP_AUTOGRAD,
                                                      TENSOR))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cohort"))
    make_synthetic_cohort(d, n_subjects=100, n_scores=DIMS[0],
                          n_rois=DIMS[1], missing_rate=0.2, seed=1)
    return d


@pytest.mark.parametrize("kw,meshes", [
    (dict(), 0),
    (dict(num_hidden_layer_decoder=1, data_parallel=2), 1),
    (dict(tensor_parallel=2), 1)],
    ids=["flagship", "data-parallel-general", "tensor-parallel"])
def test_a_run_builds_its_routes_once(cohort, tmp_path, monkeypatch, kw,
                                      meshes):
    """Over 3 epochs each group's kernel epoch is built at its first use
    alone, and the step mesh and its model replicas once."""
    built, made = {}, {"mesh": 0, "replicas": 0}
    make = trainer.make_group_fused_epoch

    def counted_make(cfg, model, key):
        built[key] = built.get(key, 0) + 1
        return make(cfg, model, key)

    def counted(name, fn):
        def call(*args, **kwargs):
            made[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(trainer, "make_group_fused_epoch", counted_make)
    for name in ("data_mesh", "tp_mesh"):
        monkeypatch.setattr(routes, name, counted("mesh",
                                                  getattr(routes, name)))
    monkeypatch.setattr(routes, "model_replicas",
                        counted("replicas", routes.model_replicas))
    run = workflows.train_exp(
        "synthetic", cohort, str(tmp_path), list(DIMS), latent_dim=4,
        style_dim=list(STYLE), batch_size=BATCH, num_epochs=3,
        use_tensorboard=False, device="cpu", **kw)
    assert (tmp_path / run / "checkpoints" / "0002" / "model.npz").is_file()
    if meshes:
        assert built == {}
    else:
        # the full and the partial complete batches, two clinical-only
        assert len(built) == 4 and set(built.values()) == {1}
    assert made == {"mesh": meshes, "replicas": meshes}
    assert np.isfinite(np.load(tmp_path / run / "checkpoints" / "0002"
                               / "model.npz")["enc_rois/heads/kernel"]).all()
