"""The port's spans and counters inside the trainer and the DAA, on the
CPU: a traced ``run_epochs`` epoch and a traced ``stats-only`` ``run_daa``
(the flagship's routes and deep-A's) write every span
(``train/profiling.py``) into the Chrome trace, nested in their parents,
the window's counts equal the bytes, passes and cells reckoned here from
the shapes, and a profiler session changes no file a call writes."""

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


def tiny_experiment(root, end_epoch=1, **arch):
    """A tiny cohort under ``root`` and its experiment (the flagship's
    architecture, or ``arch``'s), ready to train."""
    make_synthetic_cohort(str(root / "data"), n_subjects=100,
                          n_scores=DIMS[0], n_rois=DIMS[1], missing_rate=0.2,
                          seed=1)
    cfg = Config(dataset="synthetic", datasetdir=str(root / "data"),
                 dir_experiment=str(root / "runs"), input_dim=list(DIMS),
                 class_dim=CD, style_dim=list(STYLE), hidden_dim=HIDDEN,
                 batch_size=BATCH, end_epoch=end_epoch, seed=7,
                 **arch).derive()
    create_dir_structure(cfg)
    exp = MultimodalExperiment(cfg, "cpu")
    exp.set_datasets()
    exp.set_optimizers()
    return exp


def traced_run_epochs(root, **arch):
    """One traced ``run_epochs`` epoch (training, test pass, checkpoint) of
    a tiny cohort, its spans, its counts and the experiment."""
    exp = tiny_experiment(root, **arch)
    with profiling.trace(str(root / "trace"), "cpu"):
        trainer.run_epochs(exp, use_tensorboard=False, progress=False)
    return spans_of(str(root / "trace")), profiling.last_counts(), exp


@pytest.fixture(scope="module")
def traced_epoch(tmp_path_factory):
    return traced_run_epochs(tmp_path_factory.mktemp("epoch"))


# deep-A: a decoder hidden layer and a per-sample output scale, so that the
# full complete batches take the layer-stack step and the others the
# autograd general step (run_daa: the Monte-Carlo reconstruction and the
# general sweep)
DEEP_A = dict(num_hidden_layer_decoder=1, learn_output_sample_scale=True)


@pytest.fixture(scope="module")
def traced_deep_epoch(tmp_path_factory):
    return traced_run_epochs(tmp_path_factory.mktemp("deep_epoch"), **DEEP_A)


TRAINER_PARENTS = ("trainer.steps", "trainer.test", "trainer.checkpoint")


def test_an_epoch_writes_every_trainer_span_in_its_parent(traced_epoch):
    spans, counts, _ = traced_epoch
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
    # trainer.checkpoint.write is the trainer's wait for the writer thread:
    # one in the checkpoint's submit, one as run_epochs ends; the writer
    # thread writes six files (Adam's state, the model, enc_/dec_ of each
    # modality)
    assert len(by["trainer.checkpoint.write"]) == 2
    assert counts["checkpoint_files_deferred"] == 6


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


def test_a_deep_epoch_spans_and_counts_each_general_step(traced_deep_epoch):
    """Deep-A: every batch outside the full complete ones takes the
    autograd general step, each in a ``trainer.general_step`` span inside
    its ``trainer.launch`` and counted once; the full complete batches take
    the layer-stack step's group, which opens no such span. (On a card the
    group is one ``generic_step`` launch and each general step one
    ``flat_adam``; here the plain versions count no launch.)"""
    spans, counts, exp = traced_deep_epoch
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    full, general = trainer.epoch_batches(exp, 0, 0)
    assert full and general
    assert len(by["trainer.general_step"]) == len(general)
    assert all(inside(s, by["trainer.launch"])
               for s in by["trainer.general_step"])
    # one launch span per general step and one for the full batches' group
    assert len(by["trainer.launch"]) == len(general) + 1
    assert counts["trainer.general_steps"] == len(general)
    assert set(by) - {"trainer.general_step"} == {
        "trainer.batches", "trainer.gather", "trainer.steps",
        "trainer.noise", "trainer.launch", "trainer.test",
        "trainer.test.forward", "trainer.fetch", "trainer.log_rows",
        "trainer.checkpoint", "trainer.checkpoint.serialize",
        "trainer.checkpoint.fetch", "trainer.checkpoint.write"}


def test_a_flagship_epoch_takes_no_general_step(traced_epoch):
    _, counts, _ = traced_epoch
    assert counts.get("trainer.general_steps", 0) == 0


def run_files(root):
    """``metrics.csv``'s bytes and every checkpoint's arrays of the run
    under ``root``."""
    runs = root / "runs"
    (run,) = [d for d in runs.iterdir() if d.is_dir()]
    with open(run / "logs" / "metrics.csv", "rb") as fh:
        csv = fh.read()
    arrays = {}
    for path in sorted((run / "checkpoints").rglob("*.npz")):
        with np.load(path) as fh:
            for k in fh.files:
                arrays[f"{path.relative_to(run)}:{k}"] = fh[k]
    return csv, arrays


@pytest.mark.parametrize("arch", [{}, DEEP_A], ids=["flagship", "deep-A"])
def test_training_writes_the_same_files_traced_and_not(tmp_path, arch):
    """The spans and counters change no number: two epochs, the first in a
    profiler session, write ``metrics.csv`` byte for byte as two epochs
    outside one, and checkpoints whose every array is equal."""
    got = {}
    for traced in (False, True):
        root = tmp_path / f"run{int(traced)}"
        root.mkdir()
        exp = tiny_experiment(root, end_epoch=2, **arch)
        trainer.run_epochs(exp, use_tensorboard=False, progress=False,
                           profile_dir=str(root / "trace") if traced
                           else None)
        got[traced] = run_files(root)
    assert (tmp_path / "run1" / "trace" / "epoch_0000.pt.trace.json"
            ).is_file()
    (csv0, arrays0), (csv1, arrays1) = got[False], got[True]
    assert csv0.count(b"\n") > 10 and csv1 == csv0
    assert len(arrays0) >= 6 and set(arrays1) == set(arrays0)
    for k, v in arrays0.items():
        np.testing.assert_array_equal(arrays1[k], v, err_msg=k)


N_SCORES, N_ROIS, N_TEST = 3, 12, 30
B, P, ROUNDS = 8, 10, 2


def daa_inputs(**arch):
    """``(cfg, model, cohort)``: a tiny model (the flagship's architecture,
    or ``arch``'s) and cohort for ``run_daa``."""
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
                 hidden_dim=HIDDEN, **arch).derive()
    torch.manual_seed(0)
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu")
    return cfg, model, cohort


M_PASSES = 4
DAA_KW = dict(n_validation=ROUNDS, n_samples=P, n_subjects=B, M=M_PASSES,
              trust_level=0.5, seed=11)


def traced_daa_call(root, **arch):
    cfg, model, cohort = daa_inputs(**arch)
    with profiling.trace(str(root / "trace"), "cpu"):
        run_daa(cfg, [model], [cohort], str(root / "out"),
                artifact="stats-only", fetch_dtype="float32", **DAA_KW)
    return spans_of(str(root / "trace")), profiling.last_counts()


@pytest.fixture(scope="module")
def traced_daa(tmp_path_factory):
    return traced_daa_call(tmp_path_factory.mktemp("daa"))


@pytest.fixture(scope="module")
def traced_deep_daa(tmp_path_factory):
    return traced_daa_call(tmp_path_factory.mktemp("deep_daa"), **DEEP_A)


def test_a_daa_call_writes_every_daa_span(traced_daa):
    spans, _ = traced_daa
    names = {s[0] for s in spans}
    # no daa.files.load: the regression stage is handed what run_daa wrote
    assert names == {"daa.reconstruction", "daa.sweep", "daa.fetch",
                     "daa.significance", "daa.regress", "daa.records",
                     "daa.files.save"}
    sig = [s for s in spans if s[0] == "daa.significance"]
    assert len(sig) == 1
    for s in spans:
        if s[0] in ("daa.regress", "daa.records"):
            assert inside(s, sig), s
        if s[0] in ("daa.reconstruction", "daa.sweep", "daa.fetch"):
            assert not inside(s, sig), s
    # a regression and a record (its betas into the records' array) per
    # round and score
    assert sum(s[0] == "daa.regress" for s in spans) == ROUNDS * N_SCORES
    assert sum(s[0] == "daa.records" for s in spans) == ROUNDS * N_SCORES
    assert sum(s[0] == "daa.sweep" for s in spans) == ROUNDS
    assert sum(s[0] == "daa.reconstruction" for s in spans) == ROUNDS


def test_a_deep_daa_call_spans_both_deep_routes(traced_deep_daa):
    """Deep-A: each round's reconstruction span holds the Monte-Carlo
    passes, and the general sweep's span lies inside the round's sweep."""
    spans, _ = traced_deep_daa
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    assert len(by["daa.reconstruction"]) == ROUNDS
    assert len(by["daa.sweep.general"]) == ROUNDS
    assert all(inside(s, by["daa.sweep"]) for s in by["daa.sweep.general"])
    assert not any(inside(s, by["daa.sweep"])
                   for s in by["daa.reconstruction"])


def test_each_daa_route_counts_its_passes_and_cells(traced_daa,
                                                    traced_deep_daa):
    """Deep-A counts ``M`` passes, decoded in one block, and ``P x S``
    general cells a round; the flagship's closed form and sweep kernel
    count none of them."""
    _, deep = traced_deep_daa
    assert deep["daa.reconstruction_passes"] == ROUNDS * M_PASSES
    assert deep["daa.reconstruction_blocks"] == ROUNDS
    assert deep["daa.general_sweep_cells"] == ROUNDS * P * N_SCORES
    _, flagship = traced_daa
    assert flagship.get("daa.reconstruction_passes", 0) == 0
    assert flagship.get("daa.reconstruction_blocks", 0) == 0
    assert flagship.get("daa.general_sweep_cells", 0) == 0


def test_each_general_slice_of_a_sharded_sweep_is_spanned_and_counted(
        tmp_path):
    """Over a 4-entry CPU mesh, 30 cells and 2 pad cells: one span and
    8 cells a slice."""
    from multivae_tpu_torch.analysis import daa
    from multivae_tpu_torch.parallel import data_mesh

    cfg, model, cohort = daa_inputs(**DEEP_A)
    data = {k: torch.from_numpy(v[:B]) for k, v in cohort.test_data.items()}
    scores = torch.randn(P, B, N_SCORES,
                         generator=torch.Generator().manual_seed(2))
    mesh = data_mesh(4, [torch.device("cpu")] * 4)
    with profiling.trace(str(tmp_path / "trace"), "cpu"):
        daa.avatar_sweep_sharded(model, data, scores, True,
                                 torch.Generator().manual_seed(3), mesh, cfg)
    spans = spans_of(str(tmp_path / "trace"))
    assert sum(s[0] == "daa.sweep.general" for s in spans) == 4
    assert profiling.last_counts()["daa.general_sweep_cells"] == 32


@pytest.mark.parametrize("arch", [{}, DEEP_A], ids=["flagship", "deep-A"])
def test_a_daa_call_writes_the_same_bytes_traced_and_not(tmp_path, arch):
    """The spans and counters change no output: every file of a call
    inside a profiler session equals, byte for byte, that of the same call
    outside one."""
    cfg, model, cohort = daa_inputs(**arch)
    files = {}
    for traced in (False, True):
        out = str(tmp_path / f"out{int(traced)}")
        if traced:
            with profiling.trace(str(tmp_path / "trace"), "cpu"):
                resdir = run_daa(cfg, [model], [cohort], out,
                                 artifact="stats-only", **DAA_KW)
        else:
            resdir = run_daa(cfg, [model], [cohort], out,
                             artifact="stats-only", **DAA_KW)
        files[traced] = {}
        for name in sorted(os.listdir(resdir)):
            with open(os.path.join(resdir, name), "rb") as fh:
                files[traced][name] = fh.read()
    assert "regression_suffstats.npz" in files[False]
    assert files[True] == files[False]


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
