"""The test pass on a card: each test batch is the replay of a CUDA graph
of ``eval_step`` (``train.trainer.EvalGraph``), held here to eager
``eval_step`` on the same batch and noise, bit for bit, over two epochs
with a training epoch between them (a graph that read stale weights would
differ in the second), and each ``(member, presence pattern, rows)``
captured once. Card only: without CUDA the tests skip (the CPU runs
``eval_step`` eagerly). This file imports no JAX; on a card's machine,
which has none, run it without the tests' conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_eval_graph.py
"""

import pytest
import torch

from multivae_tpu_torch.data import make_synthetic_cohort
from multivae_tpu_torch.train import profiling, trainer
from multivae_tpu_torch.train.config import Config
from multivae_tpu_torch.train.experiment import MultimodalExperiment
from multivae_tpu_torch.train.train_step import batch_noise_width, eval_step
from multivae_tpu_torch.utils.filehandling import create_dir_structure

pytestmark = pytest.mark.card

# the flagship's widths; 700 subjects: 113 complete test subjects, two
# test batches of 64 and 49 rows
DIMS, STYLE, CD, BATCH = (7, 444), (3, 20), 20, 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the test pass takes CUDA graphs only on "
                    "one")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cohort"))
    make_synthetic_cohort(d, n_subjects=700, n_scores=DIMS[0],
                          n_rois=DIMS[1], missing_rate=0.2, seed=3)
    return d


def make_exp(datasetdir, outdir, device, **kw):
    cfg = Config(dataset="synthetic", datasetdir=datasetdir,
                 dir_experiment=outdir, input_dim=list(DIMS), class_dim=CD,
                 style_dim=list(STYLE), batch_size=BATCH,
                 learn_output_scale=True, end_epoch=1, seed=11,
                 **kw).derive()
    create_dir_structure(cfg)
    exp = MultimodalExperiment(cfg, device)
    exp.set_datasets()
    exp.set_optimizers()
    return exp


def held_to_eager(exp, model_idx, epoch, device):
    """The member's graphed test pass of ``epoch`` against eager
    ``eval_step`` on each batch with the same noise; returns the batches'
    ``(presence pattern, rows)`` keys."""
    cfg, model = exp.cfg, exp.models[model_idx]
    got = trainer.test_one_epoch(exp, model_idx, None,
                                 trainer.epoch_generator(cfg, model_idx,
                                                         epoch), epoch)
    order, emitted = trainer.test_batches(exp, model_idx, epoch)
    noise = trainer.draw_noise(
        trainer.epoch_generator(cfg, model_idx, epoch),
        [(len(next(iter(d.values()))), batch_noise_width(cfg, model, d))
         for d in emitted], device)
    assert len(got) == len(order)
    keys = set()
    for metrics, (data, i) in zip(got, order):
        _, want = eval_step(cfg, model, data, noise[i])
        assert list(metrics) == list(want)
        for k, v in want.items():
            assert torch.equal(metrics[k], v), (epoch, k)
        keys.add((tuple(data), len(next(iter(data.values())))))
    return keys


def captures():
    return profiling.COUNTS.get("test_graph_captures", 0)


@pytest.mark.parametrize("method,kw", [
    ("joint_elbo", {}), ("moe", {}), ("jsd", {}), ("poe", {}),
    ("joint_elbo", {"num_models": 2, "ensemble_parallel": True}),
    ("joint_elbo", {"profiled": True})],
    ids=["joint_elbo", "moe", "jsd", "poe", "ensemble", "profiled"])
def test_the_graphed_test_pass_is_eager_eval_step(card, cohort, tmp_path,
                                                  method, kw):
    kw = dict(kw)
    profile_dir = str(tmp_path / "trace") if kw.pop("profiled", False) \
        else None
    exp = make_exp(cohort, str(tmp_path / "runs"), card, method=method,
                   **kw)
    start = captures()
    # epoch 0 captures each member's keys (under a profiler session for
    # "profiled")
    trainer.run_epochs(exp, use_tensorboard=False, progress=False,
                       profile_dir=profile_dir)
    n_members = exp.cfg.num_models
    assert captures() - start == len(exp.test_graphs) >= 2 * n_members
    for m in range(n_members):
        keys = held_to_eager(exp, m, 1, card)
        assert {k[1:] for k in exp.test_graphs if k[0] == m} == keys
        before = [p.clone() for p in exp.models[m].parameters()]
        trainer.train_one_epoch(exp, m, None,
                                trainer.epoch_generator(exp.cfg, m, 2), 2)
        assert not all(torch.equal(a, p) for a, p in
                       zip(before, exp.models[m].parameters()))
        assert held_to_eager(exp, m, 3, card) == keys
    # one capture per member and key across the epochs
    assert captures() - start == len(exp.test_graphs)
