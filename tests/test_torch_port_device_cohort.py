"""The trainer's batches from the device-resident cohort
(``train/device_cohort.py``) against ``MultimodalDataset.gather``, on the
CPU: every batch of an epoch, train and test, of one model and of each of
two ensemble members (each scaled by its own fold's scalers), holds the
gather's modalities with the gather's bits. A group's batches are slabs of
one gather, which the group's kernel epoch takes without a copy."""

import numpy as np
import pytest
import torch

from multivae_tpu_torch.data import (MissingModalitySampler,
                                     make_synthetic_cohort, simple_batches)
from multivae_tpu_torch.ops import fusion
from multivae_tpu_torch.train import profiling, trainer
from multivae_tpu_torch.train.config import Config
from multivae_tpu_torch.train.experiment import MultimodalExperiment

DIMS, CD, STYLE, HIDDEN, BATCH = (3, 12), 4, (2, 3), 16, 12


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cohort"))
    # 20 subjects without ROIs: clinical-only training batches
    make_synthetic_cohort(d, n_subjects=100, n_scores=DIMS[0],
                          n_rois=DIMS[1], missing_rate=0.2, seed=1)
    return d


def make_exp(datasetdir, **kw):
    cfg = Config(dataset="synthetic", datasetdir=datasetdir,
                 input_dim=list(DIMS), class_dim=CD, style_dim=list(STYLE),
                 hidden_dim=HIDDEN, batch_size=BATCH, end_epoch=1, seed=7,
                 **kw).derive()
    exp = MultimodalExperiment(cfg, "cpu")
    exp.set_datasets()
    exp.set_optimizers()
    return exp


def same_bits(got, want):
    """``got`` (device batch) holds ``want``'s (a gather's) modalities in
    its order, float32, bit for bit."""
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and v.dtype == np.float32
        assert torch.equal(got[k].view(torch.int32),
                           torch.from_numpy(v).view(torch.int32)), k


def train_gathers(exp, model_idx, epoch):
    """``(full complete, the others)``: the gathers of the epoch's sampler
    batches, as the trainer split them before the device cohort."""
    train, _ = exp.member_datasets(model_idx)
    sampler = MissingModalitySampler(
        train, batch_size=BATCH,
        indices=train.indices if exp.cfg.num_models > 1 else None,
        seed=exp.cfg.seed + epoch)
    full, general = [], []
    for idxs in sampler:
        data = train.gather(idxs)[0]
        (full if len(idxs) == BATCH and len(data) == len(DIMS)
         else general).append(data)
    return full, general


def gathers_of_the_test_pass(exp, model_idx, epoch):
    """The test pass's emitted batches as gathers, empty ones skipped."""
    _, test = exp.member_datasets(model_idx)
    out = [test.gather(idxs)[0] for idxs in simple_batches(
        len(test), BATCH, np.random.default_rng(exp.cfg.seed + epoch))]
    out = [d for d in out if d]
    return ([d for d in out if len(next(iter(d.values()))) == BATCH
             and len(d) == len(DIMS)]
            + [d for d in out if not (len(next(iter(d.values()))) == BATCH
                                      and len(d) == len(DIMS))])


@pytest.mark.parametrize("epoch", [0, 3])
@pytest.mark.parametrize("num_models", [1, 2])
def test_device_batches_are_the_gathers_bit_for_bit(cohort, num_models,
                                                    epoch):
    exp = make_exp(cohort, num_models=num_models)
    for m in range(num_models):
        full, general = trainer.epoch_batches(exp, m, epoch)
        want_full, want_general = train_gathers(exp, m, epoch)
        assert len(full) == len(want_full) > 0
        assert len(general) == len(want_general) > 0
        for got, want in zip(full + general, want_full + want_general):
            same_bits(got, want)
        assert any(list(d) == ["clinical"] for d in general)
        order, emitted = trainer.test_batches(exp, m, epoch)
        want = gathers_of_the_test_pass(exp, m, epoch)
        assert len(emitted) == len(want) > 1
        for got, w in zip(emitted, want):
            same_bits(got, w)
        assert sorted(i for _, i in order) == list(range(len(emitted)))
    if num_models > 1:
        # each member scaled by its own fold's scalers
        a, b = (exp.scalers[m]["rois"].mean_ for m in range(2))
        assert not np.array_equal(a, b)


def test_the_cohort_is_built_once_and_dropped_with_the_datasets(cohort):
    exp = make_exp(cohort)
    trainer.epoch_batches(exp, 0, 0)
    trainer.test_batches(exp, 0, 0)
    built = dict(exp.device_cohorts)
    assert set(built) == {(0, "train"), (0, "test")}
    before = profiling.COUNTS.get("h2d_bytes", 0)
    full, general = trainer.epoch_batches(exp, 0, 1)
    trainer.test_batches(exp, 0, 1)
    assert all(exp.device_cohorts[k] is built[k] for k in built)
    # a later epoch copies its row indices alone (int64, training and test)
    train, test = exp.member_datasets(0)
    assert profiling.COUNTS["h2d_bytes"] - before == 8 * (len(train)
                                                          + len(test))
    exp.set_datasets()
    assert exp.device_cohorts == {}
    trainer.epoch_batches(exp, 0, 1)
    assert exp.device_cohorts[(0, "train")] is not built[(0, "train")]


def test_a_groups_batches_stack_without_a_copy(cohort):
    exp = make_exp(cohort)
    full, general = trainer.epoch_batches(exp, 0, 0)
    for mod in ("clinical", "rois"):
        block = trainer._stack(full, mod)
        assert block.shape == (len(full), BATCH, full[0][mod].shape[1])
        assert block.data_ptr() == full[0][mod].data_ptr()
        assert torch.equal(block, torch.stack([d[mod] for d in full]))
    # batches that are not one gather's consecutive slabs are stacked
    picked = [full[1], full[0]]
    block = trainer._stack(picked, "rois")
    assert block.data_ptr() != full[1]["rois"].data_ptr()
    assert torch.equal(block, torch.stack([d["rois"] for d in picked]))
    halves = [{"rois": d["rois"][:BATCH // 2]} for d in full]
    assert torch.equal(trainer._stack(halves, "rois"),
                       torch.stack([d["rois"] for d in halves]))


def test_a_static_array_is_copied_to_a_device_once():
    like = torch.zeros(2)
    a = fusion.device_constant(np.array([0.5, 0.25], np.float32), like)
    assert fusion.device_constant(np.array([0.5, 0.25], np.float32),
                                  like) is a
    assert fusion.device_constant([0, 1], like, torch.int64).dtype == \
        torch.int64
    assert fusion.device_constant([0, 1], like) is not \
        fusion.device_constant([0, 1], like, torch.int64)
    b = fusion.device_constant(np.array([0.5, 0.75], np.float32), like)
    assert b is not a and b.tolist() == [0.5, 0.75]
    # the tensor is a copy: the array it came from may change
    src = np.array([1.0, 2.0], np.float32)
    c = fusion.device_constant(src, like)
    src[0] = 9.0
    assert c.tolist() == [1.0, 2.0]
