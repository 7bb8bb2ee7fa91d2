"""The trainer's checkpoints through the writer thread, on the CPU
(``train/checkpoint.py`` ``CheckpointWriter``): the same files in the same
order and with the same bytes as the synchronous ``save_checkpoint`` and
``save_networks``, each checkpoint complete before the next one starts,
the bytes the writer's own while the state changes in place, the writer's
errors raised on the training thread, and its counters."""

import os
import stat
import sys
import threading
import time
import types
import zipfile

import numpy as np
import pytest
import torch

from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.data import make_synthetic_cohort
from multivae_tpu_torch.train import checkpoint, profiling, trainer
from multivae_tpu_torch.train.config import Config
from multivae_tpu_torch.train.experiment import MultimodalExperiment
from multivae_tpu_torch.utils.filehandling import create_dir_structure

DIMS, CD, STYLE, HIDDEN, BATCH = (3, 12), 4, (2, 3), 16, 12
NETWORKS = ("enc_clinical", "dec_clinical", "enc_rois", "dec_rois")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cohort"))
    make_synthetic_cohort(d, n_subjects=100, n_scores=DIMS[0],
                          n_rois=DIMS[1], missing_rate=0.2, seed=1)
    return d


def make_exp(cohort, outdir, end_epoch, **kw):
    cfg = Config(dataset="synthetic", datasetdir=cohort,
                 dir_experiment=str(outdir), input_dim=list(DIMS),
                 class_dim=CD, style_dim=list(STYLE), hidden_dim=HIDDEN,
                 batch_size=BATCH, end_epoch=end_epoch, seed=7,
                 **kw).derive()
    create_dir_structure(cfg)
    exp = MultimodalExperiment(cfg, "cpu")
    exp.set_datasets()
    exp.set_optimizers()
    return exp


def run(exp):
    return trainer.run_epochs(exp, use_tensorboard=False, progress=False)


def record_file_events(monkeypatch, root_of):
    """Patch ``os.fsync`` / ``os.replace`` (as
    ``test_checkpoint_fsyncs_the_directory`` does) to log each call, a
    rename by its target's path under ``root_of(path)``."""
    events = []
    real_fsync, real_replace = os.fsync, os.replace

    def fsync(fd):
        kind = "dir" if stat.S_ISDIR(os.fstat(fd).st_mode) else "file"
        events.append(("fsync", kind))
        real_fsync(fd)

    def replace(src, dst):
        events.append(("replace", os.path.relpath(dst, root_of(dst))))
        real_replace(src, dst)

    monkeypatch.setattr(checkpoint.os, "fsync", fsync)
    monkeypatch.setattr(checkpoint.os, "replace", replace)
    return events


def write_synchronously(exp, ckpt_root, epoch):
    """What the synchronous functions write for the state as it is: the
    checkpoint of ``epoch`` under ``ckpt_root`` and the network dumps at
    its root."""
    cfg = exp.cfg
    checkpoint.save_checkpoint(
        os.path.join(ckpt_root, str(epoch).zfill(4)), exp.models[0],
        exp.opt_states[0], cfg.model_save,
        dims=bridge.dims_from(cfg, cfg.batch_size))
    checkpoint.save_networks(ckpt_root, exp.models[0])


def checkpoint_paths(ckpt_root, epoch):
    """The six files of a flagship-shaped checkpoint, in writing order."""
    ckpt = os.path.join(ckpt_root, str(epoch).zfill(4))
    return ([os.path.join(ckpt, "opt_state.npz"),
             os.path.join(ckpt, "model.npz")]
            + [os.path.join(ckpt_root, n + ".npz") for n in NETWORKS])


def frozen_zip_clock(monkeypatch):
    """An npz member's header holds the time it was written: pin the
    clock ``zipfile`` reads, so that equal arrays give equal bytes."""
    fixed = time.mktime((2026, 1, 2, 3, 4, 6, 0, 0, -1))
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: fixed, localtime=time.localtime))


def test_two_checkpoints_write_in_the_synchronous_order(cohort, tmp_path,
                                                        monkeypatch):
    exp = make_exp(cohort, tmp_path / "runs", 10)
    ckpt_root = exp.cfg.dir_checkpoints
    sync_root = str(tmp_path / "sync" / "checkpoints")
    roots = (ckpt_root, sync_root)
    events = record_file_events(
        monkeypatch, lambda p: next(r for r in roots if p.startswith(r)))
    run(exp)
    written = list(events)
    # the networks' order in the tree is the order the dumps are written
    tree = bridge.state_dict_to_tree(exp.models[0].state_dict())
    assert [k for k in tree if k[:4] in ("enc_", "dec_")] == list(NETWORKS)
    expected = []
    for epoch in (4, 9):
        for path in checkpoint_paths(ckpt_root, epoch):
            expected += [("fsync", "file"),
                         ("replace", os.path.relpath(path, ckpt_root)),
                         ("fsync", "dir")]
    assert written == expected
    # the synchronous functions make the same calls, file for file
    del events[:]
    for epoch in (4, 9):
        write_synchronously(exp, sync_root, epoch)
    assert events == expected
    # every event of checkpoint 0004 comes before every event of 0009
    renamed = [e[1] for e in written if e[0] == "replace"]
    assert all(r.startswith("0009") for r in renamed[6:8])
    assert not any(r.startswith("0009") for r in renamed[:6])


def test_the_writers_files_equal_the_synchronous_files(cohort, tmp_path,
                                                       monkeypatch):
    frozen_zip_clock(monkeypatch)
    exp = make_exp(cohort, tmp_path / "runs", 5)
    run(exp)  # its last checkpoint, 0004, holds the state as it is now
    sync_root = str(tmp_path / "sync" / "checkpoints")
    write_synchronously(exp, sync_root, 4)
    for got, want in zip(checkpoint_paths(exp.cfg.dir_checkpoints, 4),
                         checkpoint_paths(sync_root, 4)):
        with open(got, "rb") as fh, open(want, "rb") as fw:
            assert fh.read() == fw.read(), os.path.basename(got)


def test_the_writer_owns_the_bytes_while_the_state_changes(cohort, tmp_path,
                                                           monkeypatch):
    exp = make_exp(cohort, tmp_path / "runs", 1)
    run(exp)
    model, opt = exp.models[0], exp.opt_states[0]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mu, nu = opt.mu.clone(), opt.nu.clone()
    entered, release = threading.Event(), threading.Event()
    real_fsync = os.fsync

    def held_fsync(fd):
        entered.set()
        release.wait(60)
        real_fsync(fd)

    monkeypatch.setattr(checkpoint.os, "fsync", held_fsync)
    try:
        trainer._checkpoint_member(exp, 0, 4)
        assert entered.wait(60)
        # the next epoch's kernels update params and moments in place
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
        opt.mu.add_(1.0)
        opt.nu.add_(1.0)
        assert not torch.equal(model.state_dict()["enc_rois.heads.weight"],
                               before["enc_rois.heads.weight"])
    finally:
        release.set()
    checkpoint.WRITER.wait()
    ckpt_root = exp.cfg.dir_checkpoints
    ckpt = os.path.join(ckpt_root, "0004")
    tree = bridge.state_dict_to_tree(before)
    saved = checkpoint.load_tree(os.path.join(ckpt, "model.npz"))
    assert bridge.flatten_tree(saved).keys() == bridge.flatten_tree(
        tree).keys()
    for k, v in bridge.flatten_tree(tree).items():
        np.testing.assert_array_equal(bridge.flatten_tree(saved)[k], v)
    for name in NETWORKS:
        dump = checkpoint.load_tree(os.path.join(ckpt_root, name + ".npz"))
        for k, v in bridge.flatten_tree(tree[name]).items():
            np.testing.assert_array_equal(bridge.flatten_tree(dump)[k], v)
    cfg = exp.cfg
    restored = checkpoint.restore_opt_state(
        ckpt, bridge.dims_from(cfg, cfg.batch_size), model.mod_names, "cpu")
    assert torch.equal(restored.mu, mu) and torch.equal(restored.nu, nu)


def test_an_error_of_the_writer_resurfaces_from_run_epochs(cohort, tmp_path,
                                                           monkeypatch):
    real_write = checkpoint._atomic_write

    def failing_write(path, data, dir_fd):
        if path.endswith("model.npz"):
            raise OSError(f"no space left for {path}")
        real_write(path, data, dir_fd)

    monkeypatch.setattr(checkpoint, "_atomic_write", failing_write)
    exp = make_exp(cohort, tmp_path / "runs", 10)
    with pytest.raises(OSError, match="no space left"):
        run(exp)
    ckpt_root = exp.cfg.dir_checkpoints
    # raised at the next checkpoint's submit: the job stopped at the file
    # that failed, and the second checkpoint was never handed over (its
    # directory made, nothing written in it)
    assert os.path.isfile(os.path.join(ckpt_root, "0004", "opt_state.npz"))
    assert not os.path.exists(os.path.join(ckpt_root, "0004", "model.npz"))
    assert os.listdir(os.path.join(ckpt_root, "0009")) == []
    # raised once: the writer takes the next job
    checkpoint.WRITER.wait()
    monkeypatch.setattr(checkpoint, "_atomic_write", real_write)
    trainer._checkpoint_member(exp, 0, 9)
    checkpoint.WRITER.wait()
    assert os.path.isfile(os.path.join(ckpt_root, "0009", "model.npz"))


def test_an_error_of_the_last_checkpoint_resurfaces_as_the_run_ends(
        cohort, tmp_path, monkeypatch):
    def failing_write(path, data, dir_fd):
        raise OSError("the disk went away")

    monkeypatch.setattr(checkpoint, "_atomic_write", failing_write)
    exp = make_exp(cohort, tmp_path / "runs", 5)
    with pytest.raises(OSError, match="went away"):
        run(exp)
    checkpoint.WRITER.wait()


def test_a_flagship_shaped_checkpoint_hands_six_files_to_the_writer(
        cohort, tmp_path):
    exp = make_exp(cohort, tmp_path / "runs", 10)
    before = dict(profiling.COUNTS)
    run(exp)
    grown = {k: v - before.get(k, 0) for k, v in profiling.COUNTS.items()}
    assert grown["checkpoint_files_deferred"] == 2 * 6
    # the run's final wait at most, and the second submit if the disk is
    # slower than five epochs
    assert grown.get("checkpoint_writer_waits", 0) <= 2
    for path in (checkpoint_paths(exp.cfg.dir_checkpoints, 4)[:2]
                 + checkpoint_paths(exp.cfg.dir_checkpoints, 9)):
        assert os.path.isfile(path)
    assert not any(f.endswith(".tmp") for _, _, files in
                   os.walk(exp.cfg.dir_checkpoints) for f in files)


def test_an_ensemble_epochs_checkpoint_is_one_writer_job(cohort, tmp_path,
                                                         monkeypatch):
    exp = make_exp(cohort, tmp_path / "runs", 5, num_models=2,
                   ensemble_parallel=True)
    jobs = []
    real_submit = checkpoint.WRITER.submit

    def submit(files):
        jobs.append([os.path.relpath(p, exp.cfg.dir_checkpoints)
                     for p, _ in files])
        real_submit(files)

    monkeypatch.setattr(checkpoint.WRITER, "submit", submit)
    run(exp)
    assert jobs == [[os.path.join(f"model_{m}", name) for m in range(2)
                     for name in ("0004/opt_state.npz", "0004/model.npz")
                     + tuple(n + ".npz" for n in NETWORKS)]]
    for m in range(2):
        assert os.path.isfile(os.path.join(
            exp.cfg.dir_checkpoints, f"model_{m}", "0004", "model.npz"))


def test_a_resume_finds_the_checkpoint_the_writer_is_writing(cohort,
                                                             tmp_path,
                                                             monkeypatch):
    exp = make_exp(cohort, tmp_path / "runs", 1)
    run(exp)
    release = threading.Event()
    real_fsync = os.fsync

    def held_fsync(fd):
        release.wait(60)
        real_fsync(fd)

    monkeypatch.setattr(checkpoint.os, "fsync", held_fsync)
    trainer._checkpoint_member(exp, 0, 4)
    threading.Timer(0.2, release.set).start()
    path, epoch = checkpoint.find_checkpoint(exp.cfg.dir_checkpoints)
    assert epoch == 4 and os.path.isfile(path)


def test_the_writer_keeps_the_order_of_many_small_jobs(tmp_path,
                                                       monkeypatch):
    """Jobs submitted back to back under a short switch interval are
    written once each, file after file in the order submitted, and the
    last job's bytes are what the files hold."""
    written = []
    real_write = checkpoint._atomic_write

    def write(path, data, dir_fd):
        written.append((path, data))
        real_write(path, data, dir_fd)

    monkeypatch.setattr(checkpoint, "_atomic_write", write)
    before = profiling.COUNTS.get("checkpoint_files_deferred", 0)
    submitted = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for job in range(100):
            files = [(str(tmp_path / f"f{k}.bin"), f"{job}/{k}".encode())
                     for k in range(2)]
            checkpoint.WRITER.submit(files)
            submitted += files
        checkpoint.WRITER.wait()
    finally:
        sys.setswitchinterval(interval)
    assert written == submitted
    assert (profiling.COUNTS["checkpoint_files_deferred"] - before
            == len(submitted))
    for k in range(2):
        assert (tmp_path / f"f{k}.bin").read_bytes() == f"99/{k}".encode()


def test_a_checkpoints_fetch_is_one_copy_per_dtype():
    tensors = {"w": torch.randn(3, 4), "b": torch.randn(4),
               "n": torch.arange(5), "s": torch.tensor(2.5)}
    before = profiling.COUNTS.get("d2h_bytes", 0)
    with torch.profiler.profile() as prof:
        host = checkpoint._fetched(tensors)
    assert list(host) == list(tensors)
    for k, v in tensors.items():
        assert host[k].dtype == v.dtype and torch.equal(host[k], v)
    assert (profiling.COUNTS["d2h_bytes"] - before
            == sum(v.nbytes for v in tensors.values()))
    fetches = [e for e in prof.events()
               if e.name == "trainer.checkpoint.fetch"]
    assert len(fetches) == 2  # float32, int64
