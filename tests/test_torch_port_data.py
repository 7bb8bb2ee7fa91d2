"""The port's data layer against the JAX package's.

The data modules are numpy and pandas in both packages; the port's copy
must give the same cohorts, splits, batches and scaled arrays for the same
seeds, bit for bit. Its ``StandardScaler`` is numpy and must equal
scikit-learn's (which the JAX package uses) to 1e-12.
"""

import os

import numpy as np
import pytest
from sklearn.preprocessing import StandardScaler as SkScaler

from multivae_tpu import data as jdata
from multivae_tpu_torch import data as tdata

N_SUBJECTS, N_SCORES, N_ROIS = 160, 4, 15


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohorts")
    out = {}
    for name, pkg in (("jax", jdata), ("torch", tdata)):
        d = str(root / name)
        truth = pkg.make_synthetic_cohort(d, n_subjects=N_SUBJECTS,
                                          n_scores=N_SCORES, n_rois=N_ROIS,
                                          missing_rate=0.2, seed=3)
        out[name] = (d, truth)
    return out


def test_synthetic_cohort_is_identical(cohorts):
    (jd, jt), (td, tt) = cohorts["jax"], cohorts["torch"]
    for key in jt:
        np.testing.assert_array_equal(jt[key], tt[key])
    files = sorted(os.listdir(jd))
    assert files == sorted(os.listdir(td))
    for f in files:
        if f.endswith(".npy"):
            np.testing.assert_array_equal(
                np.load(os.path.join(jd, f), allow_pickle=True),
                np.load(os.path.join(td, f), allow_pickle=True))
        else:
            with open(os.path.join(jd, f)) as a, \
                    open(os.path.join(td, f)) as b:
                assert a.read() == b.read()


def managers(cohorts, **kw):
    return [pkg.DataManager("synthetic", cohorts[name][0],
                            ["clinical", "rois"], overwrite=True,
                            allow_missing_blocks=True, **kw)
            for name, pkg in (("jax", jdata), ("torch", tdata))]


def assert_same_dataset(a, b):
    assert len(a) == len(b)
    assert a.modality_subsets == b.modality_subsets
    assert a.idx_per_modality_subset == b.idx_per_modality_subset
    idxs = list(range(0, len(a), 3))
    for sub in a.idx_per_modality_subset:
        if sub:
            da, la, ma = a.gather(sub)
            db, lb, mb = b.gather(sub)
            assert sorted(da) == sorted(db)
            for k in da:
                np.testing.assert_array_equal(da[k], db[k])
            np.testing.assert_array_equal(la, lb)
            assert ma.equals(mb)
    assert [sorted(a[i][0]) for i in idxs] == [sorted(b[i][0]) for i in idxs]


def test_data_manager_train_test_split(cohorts):
    jm, tm = managers(cohorts)
    assert_same_dataset(jm.train_dataset, tm.train_dataset)
    assert_same_dataset(jm.test_dataset, tm.test_dataset)


def test_data_manager_validation_folds(cohorts):
    jm, tm = managers(cohorts, validation=3, test_size=0)
    for fold in range(3):
        for key in ("train_idx", "valid_idx"):
            np.testing.assert_array_equal(jm.train_dataset[fold][key],
                                          tm.train_dataset[fold][key])
        assert_same_dataset(jm.train_dataset[fold]["train"],
                            tm.train_dataset[fold]["train"])


@pytest.mark.parametrize("seed", [0, 42, 1234])
def test_sampler_emits_the_same_batches(cohorts, seed):
    jm, tm = managers(cohorts)
    for bs in (16, 50):
        js = jdata.MissingModalitySampler(jm.train_dataset, batch_size=bs,
                                          seed=seed)
        ts = tdata.MissingModalitySampler(tm.train_dataset, batch_size=bs,
                                          seed=seed)
        assert len(js) == len(ts)
        for _ in range(2):  # the sampler's epoch counter advances
            assert list(js) == list(ts)


def test_stratified_sampler_and_simple_batches(cohorts):
    jm, tm = managers(cohorts)
    kw = dict(batch_size=16, stratify=["age", "sex"], discretize=["age"],
              seed=5)
    assert (list(jdata.MissingModalitySampler(jm.train_dataset, **kw))
            == list(tdata.MissingModalitySampler(tm.train_dataset, **kw)))
    for shuffle in (True, False):
        assert (jdata.simple_batches(37, 8, np.random.default_rng(4),
                                     shuffle=shuffle)
                == tdata.simple_batches(37, 8, np.random.default_rng(4),
                                        shuffle=shuffle))


def test_scaled_gather_matches(cohorts):
    jm, tm = managers(cohorts)
    out = []
    for pkg, m in ((jdata, jm), (tdata, tm)):
        ds = m.train_dataset
        scalers = {}
        for mod in ("clinical", "rois"):
            rows = ds._row_idx[mod][ds._present[mod]]
            scalers[mod] = pkg.StandardScaler().fit(
                np.asarray(ds.data[mod][rows], dtype=np.float64))
        scaled = pkg.MultimodalDataset(m.fetcher.train_input_path,
                                       m.fetcher.train_metadata_path,
                                       on_the_fly_transform=scalers)
        out.append(scaled.gather(scaled.idx_per_modality_subset[-1])[0])
    for k in out[0]:
        assert out[1][k].dtype == np.float32
        np.testing.assert_array_equal(out[0][k], out[1][k])


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_standard_scaler_matches_sklearn(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(50, 6)) * [1, 10, 0.1, 3, 1, 1] + 5).astype(dtype)
    x[:, 4] = 2  # a constant column is left unscaled
    sk, ours = SkScaler().fit(x), tdata.StandardScaler().fit(x)
    for attr in ("mean_", "var_", "scale_"):
        np.testing.assert_allclose(getattr(ours, attr), getattr(sk, attr),
                                   rtol=1e-12, atol=1e-12)
    assert ours.n_samples_seen_ == sk.n_samples_seen_
    y = (rng.normal(size=(9, 6)) * 3).astype(dtype)
    for a, b in ((ours.transform(y), sk.transform(y)),
                 (ours.inverse_transform(y), sk.inverse_transform(y)),
                 (tdata.StandardScaler().fit_transform(x),
                  SkScaler().fit_transform(x))):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_standard_scaler_needs_fit():
    with pytest.raises(ValueError, match="not fitted"):
        tdata.StandardScaler().transform(np.zeros((2, 2)))
