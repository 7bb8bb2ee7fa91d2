"""The port's spans and counters inside the trainer and the DAA, on the
CPU: a traced ``run_epochs`` epoch and a traced ``stats-only`` ``run_daa``
write every span (``train/profiling.py``) into the Chrome trace, nested in
their parents, and the window's counts equal the bytes reckoned here from
the shapes."""

import json
import os

import numpy as np
import pytest
import torch

from multivae_tpu_torch import workflows
from multivae_tpu_torch.analysis.daa import (SAMPLED_AVATARS_FILE,
                                             DaaCohort, run_daa)
from multivae_tpu_torch.data import make_synthetic_cohort
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.train import profiling, trainer
from multivae_tpu_torch.train.config import Config
from multivae_tpu_torch.train.experiment import MultimodalExperiment
from multivae_tpu_torch.train.train_step import batch_noise_width
from multivae_tpu_torch.utils.filehandling import create_dir_structure

DIMS, CD, STYLE, HIDDEN, BATCH = (3, 12), 4, (2, 3), 16, 12
F32, I64 = 4, 8  # bytes


def spans_of(trace_dir):
    with open(profiling.trace_path(trace_dir, 0)) as fh:
        events = json.load(fh)["traceEvents"]
    return [(ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
            for ev in events if ev.get("cat") == "user_annotation"]


def inside(span, parents):
    _, a, b = span
    return any(pa <= a and b <= pb for _, pa, pb in parents)


@pytest.fixture(scope="module")
def traced_epoch(tmp_path_factory):
    """One traced ``run_epochs`` epoch (training, test pass, checkpoint) of
    a tiny cohort, its spans, its counts and the experiment."""
    root = tmp_path_factory.mktemp("epoch")
    make_synthetic_cohort(str(root / "data"), n_subjects=100,
                          n_scores=DIMS[0], n_rois=DIMS[1], missing_rate=0.2,
                          seed=1)
    cfg = Config(dataset="synthetic", datasetdir=str(root / "data"),
                 dir_experiment=str(root / "runs"), input_dim=list(DIMS),
                 class_dim=CD, style_dim=list(STYLE), hidden_dim=HIDDEN,
                 batch_size=BATCH, end_epoch=1, seed=7).derive()
    create_dir_structure(cfg)
    exp = MultimodalExperiment(cfg, "cpu")
    exp.set_datasets()
    exp.set_optimizers()
    with profiling.trace(str(root / "trace"), "cpu"):
        trainer.run_epochs(exp, use_tensorboard=False, progress=False)
    return spans_of(str(root / "trace")), profiling.last_counts(), exp


TRAINER_PARENTS = ("trainer.steps", "trainer.test", "trainer.checkpoint")


def test_an_epoch_writes_every_trainer_span_in_its_parent(traced_epoch):
    spans, _, _ = traced_epoch
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    assert set(by) == {
        "trainer.batches", "trainer.gather", "trainer.steps",
        "trainer.noise", "trainer.launch", "trainer.test",
        "trainer.test.forward", "trainer.fetch", "trainer.log_rows",
        "trainer.checkpoint", "trainer.checkpoint.serialize",
        "trainer.checkpoint.fetch", "trainer.checkpoint.write"}
    parents = [s for s in spans if s[0] in TRAINER_PARENTS]
    for name in ("trainer.batches", "trainer.gather", "trainer.noise",
                 "trainer.launch", "trainer.test.forward",
                 "trainer.checkpoint.serialize", "trainer.checkpoint.write"):
        assert all(inside(s, parents) for s in by[name]), name
    assert all(inside(s, by["trainer.steps"]) for s in by["trainer.launch"])
    assert all(inside(s, by["trainer.steps"] + by["trainer.test"])
               for s in by["trainer.batches"] + by["trainer.gather"])
    assert all(inside(s, by["trainer.test"])
               for s in by["trainer.test.forward"])
    assert all(inside(s, by["trainer.checkpoint"])
               for s in by["trainer.checkpoint.serialize"]
               + by["trainer.checkpoint.write"])
    # the train metrics' fetch and rows follow trainer.steps; the test
    # pass's are inside it; a checkpoint fetches the state while it
    # serializes it, in a span of its own
    for name in ("trainer.fetch", "trainer.log_rows"):
        assert not all(inside(s, parents) for s in by[name]), name
        assert any(inside(s, by["trainer.test"]) for s in by[name]), name
        assert not any(inside(s, by["trainer.checkpoint"])
                       for s in by[name]), name
    assert all(inside(s, by["trainer.checkpoint.serialize"])
               for s in by["trainer.checkpoint.fetch"])
    # six files (Adam's state, the model, enc_/dec_ of each modality)
    assert len(by["trainer.checkpoint.write"]) == 6


def epoch_copies(exp, epoch):
    """The bytes an epoch's batches copy to the device: per batch its row
    indices (int64) and its noise draw, training and test."""
    cfg, model = exp.cfg, exp.models[0]
    full, general = trainer.epoch_batches(exp, 0, epoch)
    _, emitted = trainer.test_batches(exp, 0, epoch)
    h2d = 0
    for d in full + general + emitted:
        rows = len(next(iter(d.values())))
        h2d += rows * I64 + rows * batch_noise_width(cfg, model, d) * F32
    return h2d


def test_an_epoch_counts_the_bytes_it_copies_to_the_device(traced_epoch,
                                                            tmp_path):
    _, counts, exp = traced_epoch
    # the epoch that builds them copies the train and test splits whole,
    # every row of every modality, once (train/device_cohort.py)
    cohorts = sum(len(ds) * sum(DIMS) * F32
                  for ds in (exp.dataset_train, exp.dataset_test))
    assert epoch_copies(exp, 0) > 0
    assert counts["h2d_bytes"] == cohorts + epoch_copies(exp, 0)
    # a later epoch copies its indices and noise alone
    exp.cfg.start_epoch, exp.cfg.end_epoch = 1, 2
    with profiling.trace(str(tmp_path / "trace"), "cpu", 1):
        trainer.run_epochs(exp, use_tensorboard=False, progress=False)
    assert profiling.last_counts()["h2d_bytes"] == epoch_copies(exp, 1)


def test_an_epoch_counts_the_launches_the_kernels_counted(traced_epoch):
    _, counts, _ = traced_epoch
    launches = {k: v for k, v in counts.items() if k.startswith("launches.")}
    assert set(launches) == {f"launches.{k}" for k in
                             profiling.kernel_counters("launches")}
    # on the CPU the plain versions run: no kernel launch counted
    assert set(launches.values()) == {0}


def test_train_exp_prints_the_traced_epochs_counts(tmp_path, capsys):
    make_synthetic_cohort(str(tmp_path / "data"), n_subjects=100,
                          n_scores=DIMS[0], n_rois=DIMS[1], missing_rate=0.2,
                          seed=1)
    kw = dict(dataset="synthetic", datasetdir=str(tmp_path / "data"),
              input_dims=DIMS, latent_dim=CD, style_dim=STYLE,
              num_epochs=2, batch_size=BATCH, use_tensorboard=False,
              device="cpu")
    workflows.train_exp(outdir=str(tmp_path / "plain"), **kw)
    assert "counts" not in capsys.readouterr().out
    workflows.train_exp(outdir=str(tmp_path / "traced"),
                        profile_dir=str(tmp_path / "trace"), **kw)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if "traced epoch's counts:" in ln]
    assert len(line) == 1
    counts = dict(kv.split("=") for kv in line[0].split(": ")[1].split())
    assert counts == {k: str(v) for k, v in profiling.last_counts().items()
                      if v}
    assert int(counts["h2d_bytes"]) > 0 and int(counts["d2h_bytes"]) > 0


N_SCORES, N_ROIS, N_TEST = 3, 12, 30
B, P, ROUNDS = 8, 10, 2


def daa_inputs():
    """``(cfg, model, cohort)``: a tiny model and cohort for ``run_daa``."""
    rng = np.random.default_rng(3)
    cohort = DaaCohort(
        clinical_names=np.array([f"score_{i}" for i in range(N_SCORES)],
                                dtype=object),
        rois_names=np.array([f"roi{i:03d}_thickness" for i in range(N_ROIS)],
                            dtype=object),
        train_clinical=rng.standard_normal((40, N_SCORES)).astype(
            np.float32),
        test_data={"clinical": rng.standard_normal(
            (N_TEST, N_SCORES)).astype(np.float32),
            "rois": rng.standard_normal((N_TEST, N_ROIS)).astype(np.float32)},
        metadata_columns=["participant_id", "site"],
        test_metadata=np.array([[f"sub-{i}", f"site{i % 3}"]
                                for i in range(N_TEST)], dtype=object))
    cfg = Config(dataset="synthetic", input_dim=[N_SCORES, N_ROIS],
                 class_dim=CD, style_dim=list(STYLE),
                 hidden_dim=HIDDEN).derive()
    torch.manual_seed(0)
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu")
    return cfg, model, cohort


DAA_KW = dict(n_validation=ROUNDS, n_samples=P, n_subjects=B, M=4,
              trust_level=0.5, seed=11)


@pytest.fixture(scope="module")
def traced_daa(tmp_path_factory):
    root = tmp_path_factory.mktemp("daa")
    cfg, model, cohort = daa_inputs()
    with profiling.trace(str(root / "trace"), "cpu"):
        run_daa(cfg, [model], [cohort], str(root / "out"),
                artifact="stats-only", fetch_dtype="float32", **DAA_KW)
    return spans_of(str(root / "trace")), profiling.last_counts()


def test_a_daa_call_writes_every_daa_span(traced_daa):
    spans, _ = traced_daa
    names = {s[0] for s in spans}
    assert names == {"daa.sweep", "daa.fetch", "daa.significance",
                     "daa.regress", "daa.records", "daa.files.save",
                     "daa.files.load"}
    sig = [s for s in spans if s[0] == "daa.significance"]
    assert len(sig) == 1
    for s in spans:
        if s[0] in ("daa.regress", "daa.records", "daa.files.load"):
            assert inside(s, sig), s
        if s[0] in ("daa.sweep", "daa.fetch"):
            assert not inside(s, sig), s
    # a regression and a record (its betas into the records' array) per
    # round and score
    assert sum(s[0] == "daa.regress" for s in spans) == ROUNDS * N_SCORES
    assert sum(s[0] == "daa.records" for s in spans) == ROUNDS * N_SCORES
    assert sum(s[0] == "daa.sweep" for s in spans) == ROUNDS


def test_a_daa_call_counts_its_fetches_and_copies(traced_daa):
    _, counts = traced_daa
    per_round_d2h = (B * N_ROIS                       # reconstruction
                     + 3 * B * N_SCORES * N_ROIS      # sufficient statistics
                     + P * B * N_SCORES) * F32        # sampled scores
    assert counts["d2h_bytes"] == ROUNDS * per_round_d2h
    # each round's subjects, both modalities
    assert counts["h2d_bytes"] == ROUNDS * B * (N_SCORES + N_ROIS) * F32
    assert counts["launches.avatar_sweep"] == 0
    # one record per round and score, written from the betas array
    assert counts["daa.coef_records"] == ROUNDS * N_SCORES


@pytest.mark.parametrize("artifact, avatars_file", [
    ("full", "rois_digital_avatars.npy"),
    ("sampled", SAMPLED_AVATARS_FILE)])
def test_a_bfloat16_wire_writes_the_avatars_rounded_to_it(
        tmp_path, artifact, avatars_file):
    """The avatars cross the wire as bfloat16 and are widened on the host:
    the artifact holds the float32 wire's avatars rounded to bfloat16."""
    cfg, model, cohort = daa_inputs()
    got = {}
    for wire in ("float32", "bfloat16"):
        resdir = run_daa(cfg, [model], [cohort], str(tmp_path / wire),
                         artifact=artifact, fetch_dtype=wire, sampled_rois=5,
                         **DAA_KW)
        got[wire] = np.load(os.path.join(resdir, avatars_file))
    assert got["bfloat16"].dtype == np.float32
    rounded = torch.from_numpy(got["float32"]).to(torch.bfloat16).float()
    assert not np.array_equal(rounded.numpy(), got["float32"])
    np.testing.assert_array_equal(got["bfloat16"], rounded.numpy())
