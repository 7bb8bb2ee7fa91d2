"""The hierarchical records, ``all_coefs.npy``, written from the betas array
(``analysis.daa.save_coef_records``) on the CPU:

- ``np.load`` of the file equals the array that ``np.save`` of the object
  records wrote (the writer ``compute_significativity`` had before): the
  same header bytes, shape and dtype, equal elements of the same Python
  types, for one model and two, string and integer metadata.
- The JAX package's ``run_anova`` reads the file into the same
  ``anova_pvalues.npy`` as the port's.
- ``run_daa`` writes every other file byte for byte as it does with the
  old writer in the records' place, and the old writer's ``all_coefs.npy``
  loads equal to the new one.
"""

import dataclasses
import os
import pickletools

import numpy as np
import pytest
import torch

from multivae_tpu.analysis import anova as jax_anova
from multivae_tpu_torch.analysis import anova, daa
from multivae_tpu_torch.analysis.daa import run_daa
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.train import profiling
from test_torch_port_spans import DAA_KW, N_ROIS, N_SCORES, daa_inputs

pytestmark = pytest.mark.driver  # cross-framework parity pins

N_VAL, S, B, R = 3, 4, 9, 6


def old_writer(path, meta, betas):
    """``all_coefs.npy`` as ``compute_significativity`` wrote it before:
    one object record ``[B, 2 + R]`` per (round, score), a Python float
    per beta, stacked by ``np.asarray(..., dtype=object)`` and pickled by
    ``np.save``."""
    def records(idx):
        """The round ``idx``'s list of score records."""
        return [np.concatenate([meta[idx], betas[idx][s].astype(object)],
                               axis=1) for s in range(betas.shape[-3])]

    def nest(idx):
        if len(idx) == betas.ndim - 3:
            return records(idx)
        return [nest(idx + (i,)) for i in range(betas.shape[len(idx)])]

    out = nest(())
    np.save(path, np.asarray(out, dtype=object))


def make_records(n_models, ids, seed=0):
    """``(meta [(n_models,) N_VAL, B, 2], betas [(n_models,) N_VAL, S, B,
    R])``: participant ids as ``str`` objects or as an int64 array with
    integer sites, the betas float64."""
    rng = np.random.default_rng(seed)
    lead = (n_models, N_VAL) if n_models > 1 else (N_VAL,)
    pid = rng.integers(0, 10_000, size=lead + (B,))
    site = rng.integers(0, 3, size=lead + (B,))
    if ids == "str":
        meta = np.stack([np.vectorize(lambda i: f"sub-{i:05d}",
                                      otypes=[object])(pid),
                         np.vectorize(lambda i: f"site{i}",
                                      otypes=[object])(site)], -1)
    else:
        meta = np.stack([pid, site], -1)
    betas = rng.normal(size=lead + (S, B, R))
    betas[..., 0, 0, 0] = 0.0
    betas[..., 0, 0, 1] = -0.0
    return meta, betas


def header(path):
    with open(path, "rb") as fh:
        version = np.lib.format.read_magic(fh)
        np.lib.format.read_array_header_1_0(fh)
        n = fh.tell()
        fh.seek(0)
        return version, fh.read(n)


def pickle_globals(path):
    with open(path, "rb") as fh:
        np.lib.format.read_magic(fh)
        np.lib.format.read_array_header_1_0(fh)
        return {arg for op, arg, _ in pickletools.genops(fh)
                if op.name in ("GLOBAL", "STACK_GLOBAL")}


def assert_same_records(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == object
    np.testing.assert_array_equal(got, want)
    assert all(type(a) is type(b) for a, b in zip(got.flat, want.flat))


@pytest.mark.parametrize("ids", ["str", "int"])
@pytest.mark.parametrize("n_models", [1, 2], ids=["one", "two"])
def test_records_load_equal_to_the_object_writers(tmp_path, n_models, ids):
    meta, betas = make_records(n_models, ids)
    new, old = str(tmp_path / "new.npy"), str(tmp_path / "old.npy")
    before = profiling.COUNTS.get("daa.coef_records", 0)
    daa.save_coef_records(new, meta, betas)
    assert (profiling.COUNTS["daa.coef_records"] - before
            == n_models * N_VAL * S)
    old_writer(old, meta, betas)
    assert header(new) == header(old)
    assert header(new)[0] == (1, 0)
    got = np.load(new, allow_pickle=True)
    want = np.load(old, allow_pickle=True)
    assert got.shape == ((n_models,) if n_models > 1 else ()) + (
        N_VAL, S, B, 2 + R)
    assert_same_records(got, want)
    kinds = {type(x) for x in got[..., :2].flat}
    assert kinds == ({str} if ids == "str" else {int})
    assert {type(x) for x in got[..., 2:].flat} == {float}
    np.testing.assert_array_equal(got[..., 2:].astype(np.float64), betas)
    # betas' signs survive: -0.0 stays -0.0
    assert np.signbit(got[..., 0, 0, 3].astype(np.float64)).all()
    # the stream names numpy alone: nothing of either package is imported
    # to read it
    names = pickle_globals(new)
    assert "numpy concatenate" in names
    assert all(n.split(".")[0].split()[0] == "numpy" for n in names), names


@pytest.mark.parametrize("n_models", [1, 2], ids=["one", "two"])
def test_both_packages_anova_read_the_records_alike(tmp_path, n_models):
    meta, betas = make_records(n_models, "str", seed=5)
    # score 1's betas carry a site effect
    betas[..., 1, :, :] += 10.0 * (meta[..., 1] == "site1")[..., None]
    lead = betas.shape[:-3]
    pvalues = np.random.default_rng(1).uniform(size=lead + (S, R))
    pvalues[..., 1, :] = 1e-9
    clinical = np.array([f"score_{i}" for i in range(S)], dtype=object)
    rois = np.array([f"roi{i:03d}_thickness" for i in range(R)],
                    dtype=object)
    got = {}
    for name, run_anova in (("port", anova.run_anova),
                            ("jax", jax_anova.run_anova)):
        resdir = str(tmp_path / name)
        os.makedirs(resdir)
        np.save(os.path.join(resdir, "pvalues.npy"), pvalues)
        daa.save_coef_records(os.path.join(resdir, "all_coefs.npy"), meta,
                              betas)
        run_anova(resdir, clinical, rois, n_models, N_VAL)
        with open(os.path.join(resdir, "anova_pvalues.npy"), "rb") as fh:
            got[name] = fh.read()
    assert got["port"] == got["jax"]
    pv = np.load(str(tmp_path / "port" / "anova_pvalues.npy"))
    assert np.median(pv[:, :, 1]) < 1e-2 < np.median(pv[:, :, 0])


def daa_outputs(root, monkeypatch, writer, artifact, n_models, reg_method):
    """Every file ``run_daa`` writes, by name, with ``writer`` in
    ``save_coef_records``' place."""
    cfg, model, cohort = daa_inputs()
    models, cohorts = [model], [cohort]
    if n_models == 2:
        cfg = dataclasses.replace(cfg, num_models=2)
        torch.manual_seed(1)
        models.append(build_model(cfg, make_modalities(
            cfg.input_dim, cfg.style_dim, cfg.likelihood), "cpu"))
        cohorts.append(cohort)
    with monkeypatch.context() as mp:
        mp.setattr(daa, "save_coef_records", writer)
        resdir = run_daa(cfg, models, cohorts, root, artifact=artifact,
                         fetch_dtype="float32", reg_method=reg_method,
                         **DAA_KW)
    out = {}
    for name in sorted(os.listdir(resdir)):
        with open(os.path.join(resdir, name), "rb") as fh:
            out[name] = fh.read()
    return resdir, out


@pytest.mark.parametrize("artifact, n_models, reg_method", [
    ("stats-only", 1, "hierarchical"), ("full", 1, "hierarchical"),
    ("stats-only", 2, "hierarchical"), ("stats-only", 1, "fixed")])
def test_run_daa_writes_the_other_files_as_the_object_writer(
        tmp_path, monkeypatch, artifact, n_models, reg_method):
    before = profiling.COUNTS.get("daa.coef_records", 0)
    new_dir, new = daa_outputs(str(tmp_path / "new"), monkeypatch,
                               daa.save_coef_records, artifact, n_models,
                               reg_method)
    hierarchical = reg_method == "hierarchical"
    assert (profiling.COUNTS.get("daa.coef_records", 0) - before
            == hierarchical * n_models * DAA_KW["n_validation"] * N_SCORES)
    old_dir, old = daa_outputs(str(tmp_path / "old"), monkeypatch,
                               old_writer, artifact, n_models, reg_method)
    assert set(new) == set(old)
    assert ("all_coefs.npy" in new) == hierarchical
    for name in new:
        if name != "all_coefs.npy":
            assert new[name] == old[name], name
    if hierarchical:
        got = np.load(os.path.join(new_dir, "all_coefs.npy"),
                      allow_pickle=True)
        want = np.load(os.path.join(old_dir, "all_coefs.npy"),
                       allow_pickle=True)
        assert got.shape == ((n_models,) if n_models > 1 else ()) + (
            DAA_KW["n_validation"], N_SCORES, DAA_KW["n_subjects"],
            2 + N_ROIS)
        assert_same_records(got, want)
        assert header(os.path.join(new_dir, "all_coefs.npy")) == header(
            os.path.join(old_dir, "all_coefs.npy"))
