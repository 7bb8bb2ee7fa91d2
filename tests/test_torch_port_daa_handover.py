"""The DAA's regression stage takes what ``run_daa`` just wrote from memory.

``run_daa`` hands ``compute_significativity`` the arrays it wrote
(``RegressionInputs``: the sufficient statistics, fetched round by round
into one host array each, or the full artifact's memmap; the sampled
scores, the metadata and the reconstructions), so the call reads no file
back and counts ``daa.inputs_in_memory``. A standalone
``compute_significativity`` on a copy of the result directory reads the
files and must write the same bytes: ``pvalues.npy``, ``coefs.npy``,
``all_coefs.npy`` and ``significant_rois.tsv``. The files ``run_daa``
wrote hold the arrays it handed over.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from multivae_tpu_torch.analysis import daa
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.train import profiling
from multivae_tpu_torch.train.config import Config

N_SCORES, N_ROIS, N_TEST = 3, 12, 30
B, P, ROUNDS = 8, 10, 3
F32 = 4  # bytes
DAA_KW = dict(n_validation=ROUNDS, n_samples=P, n_subjects=B, M=4,
              trust_level=0.3, seed=11, fetch_dtype="float16",
              sampled_rois=5)
OUTPUTS = ("pvalues.npy", "coefs.npy", "all_coefs.npy",
           "significant_rois.tsv")
INPUT_FILES = {"sampled_scores.npy": "sampled_scores",
               "metadatas.npy": "metadatas",
               "rois_reconstructions.npy": "rois_reconstructions"}


def daa_inputs(num_models):
    """``(cfg, models, cohorts)``: tiny models and cohorts for ``run_daa``."""
    rng = np.random.default_rng(3)
    cfg = Config(dataset="synthetic", input_dim=[N_SCORES, N_ROIS],
                 class_dim=4, style_dim=[2, 3], hidden_dim=16,
                 num_models=num_models).derive()
    models, cohorts = [], []
    for idx in range(num_models):
        cohorts.append(daa.DaaCohort(
            clinical_names=np.array([f"score_{i}" for i in range(N_SCORES)],
                                    dtype=object),
            rois_names=np.array([f"roi{i:03d}_thickness"
                                 for i in range(N_ROIS)], dtype=object),
            train_clinical=rng.standard_normal((40, N_SCORES)).astype(
                np.float32),
            test_data={"clinical": rng.standard_normal(
                (N_TEST, N_SCORES)).astype(np.float32),
                "rois": rng.standard_normal(
                    (N_TEST, N_ROIS)).astype(np.float32)},
            metadata_columns=["participant_id", "site"],
            test_metadata=np.array([[f"sub-{i}", f"site{i % 3}"]
                                    for i in range(N_TEST)], dtype=object)))
        torch.manual_seed(idx)
        models.append(build_model(cfg, make_modalities(
            cfg.input_dim, cfg.style_dim, cfg.likelihood), "cpu"))
    return cfg, models, cohorts


def run_handing_over(monkeypatch, root, artifact, reg_method, num_models):
    """``run_daa`` with ``compute_significativity`` spied on through the
    module global that ``run_daa`` calls; returns ``(resdir, the call's
    arguments, its keyword arguments)``."""
    cfg, models, cohorts = daa_inputs(num_models)
    seen = []
    real = daa.compute_significativity

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(daa, "compute_significativity", spy)
    resdir = daa.run_daa(cfg, models, cohorts, str(root),
                         artifact=artifact, reg_method=reg_method, **DAA_KW)
    monkeypatch.setattr(daa, "compute_significativity", real)
    assert len(seen) == 1
    args, kwargs = seen[0]
    return resdir, args, kwargs


def read_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("artifact, reg_method, num_models", [
    ("stats-only", "hierarchical", 1),
    ("stats-only", "fixed", 1),
    ("stats-only", "mixed", 1),
    ("sampled", "hierarchical", 1),
    ("sampled", "fixed", 1),
    ("sampled", "mixed", 1),
    ("full", "hierarchical", 1),
    ("full", "fixed", 1),
    ("full", "mixed", 1),
    ("stats-only", "hierarchical", 2),
    ("sampled", "fixed", 2),
    ("full", "mixed", 2),
])
def test_the_stage_writes_the_same_bytes_by_both_ways_in(
        tmp_path, monkeypatch, artifact, reg_method, num_models):
    resdir, args, kwargs = run_handing_over(
        monkeypatch, tmp_path / "daa", artifact, reg_method, num_models)
    handed = kwargs["inputs"]
    assert isinstance(handed, daa.RegressionInputs)

    # the files run_daa wrote hold the arrays it handed over
    for name, field in INPUT_FILES.items():
        on_disk = np.load(os.path.join(resdir, name), allow_pickle=True)
        held = getattr(handed, field)
        assert on_disk.dtype == held.dtype and on_disk.shape == held.shape
        assert on_disk.tolist() == held.tolist()
    if artifact == "full":
        assert handed.suffstats is None
        np.testing.assert_array_equal(
            np.load(os.path.join(resdir, daa.AVATARS_FILE)), handed.avatars)
    else:
        assert handed.avatars is None
        with np.load(os.path.join(resdir, daa.SUFFSTATS_FILE)) as fh:
            assert sorted(fh.files) == sorted(daa.SUFFSTATS_KEYS)
            for k in daa.SUFFSTATS_KEYS:
                held = handed.suffstats[k]
                lead = (num_models,) if num_models > 1 else ()
                assert held.shape == lead + (ROUNDS, B, N_SCORES, N_ROIS)
                assert fh[k].dtype == held.dtype == np.float32
                assert fh[k].tobytes() == held.tobytes()

    # the stage re-run standalone on a copy of the directory reads the
    # files and writes the same bytes
    copy = str(tmp_path / "standalone")
    shutil.copytree(resdir, copy)
    for name in OUTPUTS:
        if os.path.exists(os.path.join(copy, name)):
            os.remove(os.path.join(copy, name))
    daa.compute_significativity(copy, *args[1:])
    written = [n for n in OUTPUTS if os.path.exists(os.path.join(resdir, n))]
    assert written == (list(OUTPUTS) if reg_method == "hierarchical"
                       else [n for n in OUTPUTS if n != "all_coefs.npy"])
    for name in written:
        assert read_bytes(os.path.join(copy, name)) == \
            read_bytes(os.path.join(resdir, name)), name


@pytest.fixture
def loads(monkeypatch):
    """Every path ``numpy.load`` is called on, as an absolute path."""
    paths = []
    real = np.load

    def spy(file, *args, **kwargs):
        paths.append(os.path.abspath(os.fspath(file)))
        return real(file, *args, **kwargs)

    monkeypatch.setattr(np, "load", spy)
    return paths


def test_a_call_reads_nothing_back_and_counts_it(tmp_path, monkeypatch,
                                                 loads):
    daadir = str(tmp_path / "daa")
    before = dict(profiling.COUNTS)
    resdir, args, _ = run_handing_over(
        monkeypatch, daadir, "stats-only", "hierarchical", 1)
    grown = {k: v - before.get(k, 0) for k, v in profiling.COUNTS.items()}
    assert not [p for p in loads if p.startswith(os.path.abspath(daadir))]
    assert grown["daa.inputs_in_memory"] == 1
    # the fetch into each statistic's slot counts the bytes it copied
    per_round_d2h = (B * N_ROIS                       # reconstruction
                     + 3 * B * N_SCORES * N_ROIS      # sufficient statistics
                     + P * B * N_SCORES) * F32        # sampled scores
    assert grown["d2h_bytes"] == ROUNDS * per_round_d2h

    # standalone: the stage reads its four files and counts nothing
    loads.clear()
    before = dict(profiling.COUNTS)
    daa.compute_significativity(resdir, *args[1:])
    assert sorted(os.path.relpath(p, os.path.abspath(resdir))
                  for p in loads) == sorted(
        [daa.SUFFSTATS_FILE] + list(INPUT_FILES))
    assert profiling.COUNTS.get("daa.inputs_in_memory", 0) == \
        before.get("daa.inputs_in_memory", 0)


def test_the_standalone_stage_still_asks_for_a_daa_run(tmp_path):
    cfg, _, cohorts = daa_inputs(1)
    params_ns = daa.params_namespace(ROUNDS, B, 4, P, "hierarchical",
                                     "likelihood", True, 11)
    with pytest.raises(FileNotFoundError, match="re-run the daa workflow"):
        daa.compute_significativity(
            str(tmp_path), cfg, cohorts[0].clinical_names,
            cohorts[0].rois_names, params_ns, ["participant_id", "site"],
            0.3, 1.0, "hierarchical")


def test_fetch_into_fills_the_slot_and_counts_its_bytes():
    out = np.zeros((2, 3, 4), np.float32)
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    before = profiling.COUNTS.get("d2h_bytes", 0)
    profiling.fetch_into(t, out[1], "daa.fetch")
    np.testing.assert_array_equal(out[1], t.numpy())
    assert not out[0].any()
    assert profiling.COUNTS["d2h_bytes"] - before == t.nbytes
    with pytest.raises(ValueError, match="cannot fetch"):
        profiling.fetch_into(t, out[1, :2], "daa.fetch")
    with pytest.raises(ValueError, match="cannot fetch"):
        profiling.fetch_into(t.double(), out[1], "daa.fetch")
