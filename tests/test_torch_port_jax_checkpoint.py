"""The port reads the JAX package's checkpoints and run directories.

The JAX package writes ``checkpoints/[model_i/]<epoch:04d>/model`` and
``opt_state`` with ``flax.serialization.to_bytes``; the port decodes them
in plain Python (``multivae_tpu_torch.train.flax_msgpack``, no flax and no
msgpack) and turns them into its own state through the weights bridge.
Here:

* trees written by ``to_bytes`` (a model's params, a ``FlatAdamState``,
  and plain values) decode to the same tree bit for bit, and
  ``chip_smoke.py``'s own writer gives ``to_bytes``' bytes;
* a run directory trained by the JAX package's ``train_exp`` (CPU, 5
  epochs) loads in the port: the same params bit for bit, the same forward
  (injected noise; rtol 1e-5 / atol 1e-6, float32 in another order), its
  Adam count and moments bit for bit; ``resume_exp`` continues it with a
  warning that the noise changes there; ``daa_exp`` serves it;
* ensemble members in ``model_<i>/``; the format told by a file's first
  bytes, not its name;
* a truncated file, an unknown ext type, flax's chunked-array marker and
  trailing bytes raise.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from multivae_tpu.data import make_synthetic_cohort as jax_cohort
from multivae_tpu.models import build_model as jax_build_model
from multivae_tpu.models import make_modalities as jax_make_modalities
from multivae_tpu.train import Config as JaxConfig
from multivae_tpu.train.train_step import FlatAdamState, init_train_state
from multivae_tpu.workflows import train_exp as jax_train_exp
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch import workflows
from multivae_tpu_torch.train import checkpoint, flax_msgpack
from multivae_tpu_torch.train.experiment import load_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.driver  # cross-framework parity pins

EPOCHS = 5


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A run directory of the JAX package's ``train_exp`` (the XLA step,
    one epoch per dispatch), trained for 5 epochs on a tiny cohort."""
    root = tmp_path_factory.mktemp("jax_run")
    datadir = str(root / "data")
    jax_cohort(datadir, n_subjects=90, n_scores=3, n_rois=12,
               missing_rate=0.2, seed=0)
    outdir = str(root / "out")
    run = jax_train_exp(
        dataset="synthetic", datasetdir=datadir, outdir=outdir,
        input_dims=[3, 12], latent_dim=4, style_dim=[2, 3],
        num_epochs=EPOCHS, batch_size=16, use_tensorboard=False,
        fused_training=False, epoch_chunk=1)
    return datadir, outdir, run


def copy_run(jax_run, tmp_path):
    datadir, outdir, run = jax_run
    shutil.copytree(os.path.join(outdir, run), tmp_path / run)
    return datadir, str(tmp_path), run


def jax_params(flags_file, ckpt):
    """The JAX package's own restore of a checkpoint: its config, model
    and params."""
    jcfg = JaxConfig.load(flags_file)
    jmodel = jax_build_model(jcfg, jax_make_modalities(
        jcfg.input_dim, jcfg.style_dim, jcfg.likelihood))
    example = {m.name: jnp.zeros((2, m.dim)) for m in jmodel.modalities}
    template, opt_template = init_train_state(jcfg, jmodel, example)
    with open(os.path.join(ckpt, "model"), "rb") as fh:
        params = serialization.from_bytes(template, fh.read())
    with open(os.path.join(ckpt, "opt_state"), "rb") as fh:
        opt = serialization.from_bytes(opt_template, fh.read())
    return jcfg, jmodel, params, opt


def assert_same_tree(got, want):
    got, want = bridge.flatten_tree(got), bridge.flatten_tree(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_to_bytes_reads_back_bit_for_bit():
    jcfg = JaxConfig(input_dim=[7, 44], style_dim=[3, 20]).derive()
    jmodel = jax_build_model(jcfg, jax_make_modalities(
        jcfg.input_dim, jcfg.style_dim, jcfg.likelihood))
    example = {m.name: jnp.zeros((2, m.dim)) for m in jmodel.modalities}
    params, opt = init_train_state(jcfg, jmodel, example, seed=3)
    host = jax.device_get(params)
    assert_same_tree(flax_msgpack.decode(serialization.to_bytes(host)),
                     host)
    opt = jax.device_get(opt._replace(
        count=jnp.asarray(1234, jnp.int32), mu=opt.mu + 0.5,
        nu=opt.nu + 1e-3))
    state = flax_msgpack.decode(serialization.to_bytes(opt))
    assert sorted(state) == ["count", "mu", "nu"]
    for field in FlatAdamState._fields:
        want = np.asarray(getattr(opt, field))
        assert state[field].dtype == want.dtype
        np.testing.assert_array_equal(state[field], want)
    plain = {"a": None, "b": True, "c": -70000, "d": 2.5, "e": "x" * 40,
             "f": np.float32(0.25), "g": np.arange(3, dtype=np.int64)}
    got = flax_msgpack.decode(serialization.to_bytes(plain))
    assert got["a"] is None and got["b"] is True and got["c"] == -70000
    assert got["d"] == 2.5 and got["e"] == "x" * 40
    assert got["f"] == np.float32(0.25) and got["f"].dtype == np.float32
    np.testing.assert_array_equal(got["g"], plain["g"])


def test_chip_smoke_writer_is_to_bytes():
    rng = np.random.default_rng(0)
    tree = {"enc_rois": {"hidden_0": {
        "kernel": rng.normal(size=(444, 256)).astype(np.float32),
        "bias": np.zeros(256, np.float32)}},
        "dec_rois": {"out_logvar": np.full((1, 444), -3.0, np.float32)},
        "odd": {"s": np.float32(1.5), "i": np.arange(3), "n": None,
                "t": False, "k": -3, "m": 70000, "q": 2 ** 40,
                "name": "y" * 300, "e": np.zeros((0, 2), np.float32)}}
    assert chip_smoke.flax_msgpack_bytes(tree) == serialization.to_bytes(
        tree)
    opt = jax.device_get(FlatAdamState(
        count=jnp.asarray(7, jnp.int32), mu=jnp.ones(10), nu=jnp.zeros(10)))
    assert chip_smoke.flax_msgpack_bytes(
        {f: np.asarray(getattr(opt, f)) for f in FlatAdamState._fields}
    ) == serialization.to_bytes(opt)


def test_jax_run_loads_with_the_same_params_and_forward(jax_run):
    datadir, outdir, run = jax_run
    rundir = os.path.join(outdir, run)
    ckpt = os.path.join(rundir, "checkpoints", f"{EPOCHS - 1:04d}")
    path, epoch = checkpoint.find_checkpoint(
        os.path.join(rundir, "checkpoints"))
    assert (path, epoch) == (os.path.join(ckpt, "model"), EPOCHS - 1)
    assert checkpoint.checkpoint_format(path) == "msgpack"
    exp, cfg = load_run(outdir, run, "cpu")
    assert (cfg.epoch_chunk, cfg.input_dim) == (1, [3, 12])
    jcfg, jmodel, params, _ = jax_params(os.path.join(rundir, "flags.json"),
                                         ckpt)
    model = exp.models[0]
    assert_same_tree(bridge.state_dict_to_tree(model.state_dict()),
                     jax.device_get(params))
    rng = np.random.default_rng(1)
    data = {"clinical": rng.normal(size=(9, 3)).astype(np.float32),
            "rois": rng.normal(size=(9, 12)).astype(np.float32)}
    noise = rng.normal(size=(9, model.noise_width(data))).astype(np.float32)
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in data.items()},
                    noise=torch.from_numpy(noise))
    jout = jmodel.apply({"params": params},
                        {k: jnp.asarray(v) for k, v in data.items()},
                        noise=jnp.asarray(noise))
    for name in ("clinical", "rois"):
        for got, want in zip(out["rec"][name], jout["rec"][name]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)


def test_resume_jax_run_takes_its_adam_state(jax_run, tmp_path):
    datadir, outdir, run = copy_run(jax_run, tmp_path)
    rundir = os.path.join(outdir, run)
    ckpt = os.path.join(rundir, "checkpoints", f"{EPOCHS - 1:04d}")
    jcfg, _, _, jopt = jax_params(os.path.join(rundir, "flags.json"), ckpt)
    exp, cfg = load_run(outdir, run, "cpu")
    dims = bridge.dims_from(cfg, cfg.batch_size)
    names = exp.models[0].mod_names
    opt = checkpoint.restore_opt_state(ckpt, dims, names, "cpu")
    assert opt.count == int(jopt.count) > 0
    np.testing.assert_array_equal(
        bridge.split_flat_to_ravel(opt.mu, dims, names), np.asarray(jopt.mu))
    np.testing.assert_array_equal(
        bridge.split_flat_to_ravel(opt.nu, dims, names), np.asarray(jopt.nu))
    with pytest.warns(UserWarning, match="threefry"):
        workflows.resume_exp("synthetic", datadir, outdir, run, EPOCHS + 1,
                             use_tensorboard=False, device="cpu")
    new = os.path.join(rundir, "checkpoints", f"{EPOCHS:04d}")
    with np.load(os.path.join(new, "opt_state.npz")) as fh:
        assert int(fh["count"]) > int(jopt.count)
    flags = json.loads(open(os.path.join(rundir, "flags.json")).read())
    assert flags["end_epoch"] == EPOCHS + 1 and "rng" not in flags
    # the latest checkpoint is now the port's, read back as npz
    path, epoch = checkpoint.find_checkpoint(
        os.path.join(rundir, "checkpoints"))
    assert epoch == EPOCHS and checkpoint.checkpoint_format(path) == "npz"


def test_daa_of_a_jax_run(jax_run, tmp_path):
    datadir, outdir, run = copy_run(jax_run, tmp_path)
    workflows.daa_exp("synthetic", datadir, outdir, run, n_validation=1,
                      n_samples=6, n_subjects=8, M=4, device="cpu")
    assert list((tmp_path / run / "daa").glob("*/significant_rois.tsv"))


def test_ensemble_members_and_format_by_bytes(tmp_path):
    """Members in ``model_<i>/`` (JAX files), a port ``.npz`` renamed to
    the JAX name read as npz, and a file of neither format refused."""
    from multivae_tpu_torch.models import build_model, make_modalities
    from multivae_tpu_torch.train.config import Config

    cfg = Config(input_dim=[3, 12], class_dim=4, style_dim=[2, 3]).derive()
    base = tmp_path / "checkpoints"
    trees = []
    for m in range(2):
        model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                                 cfg.likelihood), "cpu",
                            seed=m)
        tree = bridge.state_dict_to_tree(model.state_dict())
        trees.append(tree)
        for epoch in (0, 4):
            d = base / f"model_{m}" / f"{epoch:04d}"
            d.mkdir(parents=True)
            (d / "model").write_bytes(serialization.to_bytes(tree))
    for m in range(2):
        path, epoch = checkpoint.find_checkpoint(str(base), m, 2)
        assert epoch == 4 and path.endswith(f"model_{m}/0004/model")
        target = build_model(cfg, make_modalities(
            cfg.input_dim, cfg.style_dim, cfg.likelihood), "cpu", seed=9)
        checkpoint.restore_checkpoint(path, target)
        assert_same_tree(bridge.state_dict_to_tree(target.state_dict()),
                         trees[m])
    npz = checkpoint.save_tree(str(tmp_path / "p"), trees[0])
    renamed = tmp_path / "p" / "model"
    os.replace(npz, renamed)
    assert checkpoint.checkpoint_format(str(renamed)) == "npz"
    assert_same_tree(checkpoint.load_tree(str(renamed)), trees[0])
    (tmp_path / "junk").write_bytes(b"\x00\x01\x02\x03")
    with pytest.raises(ValueError, match="neither"):
        checkpoint.load_tree(str(tmp_path / "junk"))


@pytest.mark.parametrize("data,match", [
    (None, "truncated"),
    (b"\x81\xa1a\xd4\x05\x00", "ext type 5"),
    (b"\x81\xa1a\xc7\x02\x02\x00\x00", "ext type 2"),
    (b"\x81\xb9__msgpack_chunked_array__\xc3", "chunked"),
    (b"\x80\x00", "bytes after"),
    (b"\x81\xa1a\xc1", "0xc1"),
], ids=["truncated", "ext-5", "complex-ext", "chunked", "trailing",
        "reserved-byte"])
def test_malformed_msgpack_raises(data, match):
    if data is None:
        full = serialization.to_bytes({"k": np.ones((4, 4), np.float32)})
        data = full[:-5]
    with pytest.raises(ValueError, match=match):
        flax_msgpack.decode(data)
