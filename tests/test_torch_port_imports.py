"""The PyTorch port stands alone: importing it loads no JAX stack, no JAX
package and no Triton; no module of it imports the JAX stack or the JAX
package anywhere; and its `train` and `daa` paths load none of them at
call time."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "multivae_tpu_torch"
BANNED = ("jax", "flax", "optax", "multivae_tpu")
# Triton, where a kernel needs it, is imported inside the launching function
NOT_AT_IMPORT = BANNED + ("triton",)


def port_modules():
    mods = []
    for path in sorted(PACKAGE.rglob("*.py")):
        if path.name == "__main__.py":
            continue
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_slice_modules_exist():
    mods = set(port_modules())
    for name in ("multivae_tpu_torch.ops.gaussian",
                 "multivae_tpu_torch.ops.fusion",
                 "multivae_tpu_torch.ops.fused_daa",
                 "multivae_tpu_torch.models.networks",
                 "multivae_tpu_torch.models.mmvae",
                 "multivae_tpu_torch.params",
                 "multivae_tpu_torch.analysis.stats",
                 "multivae_tpu_torch.analysis.daa",
                 "multivae_tpu_torch.train.checkpoint",
                 "multivae_tpu_torch.train.experiment",
                 "multivae_tpu_torch.workflows",
                 "multivae_tpu_torch.cli",
                 # the train slice
                 "multivae_tpu_torch.data",
                 "multivae_tpu_torch.data.preprocess",
                 "multivae_tpu_torch.data.stratify",
                 "multivae_tpu_torch.data.fetchers",
                 "multivae_tpu_torch.data.dataset",
                 "multivae_tpu_torch.data.sampler",
                 "multivae_tpu_torch.data.synthetic",
                 "multivae_tpu_torch.ops.adam",
                 "multivae_tpu_torch.ops.fused_step",
                 "multivae_tpu_torch.ops.fused_presence",
                 "multivae_tpu_torch.ops.fused_methods",
                 "multivae_tpu_torch.ops.likelihoods",
                 "multivae_tpu_torch.train.losses",
                 "multivae_tpu_torch.train.train_step",
                 "multivae_tpu_torch.train.logging",
                 "multivae_tpu_torch.train.trainer",
                 "multivae_tpu_torch.utils.filehandling",
                 # the data-parallel and ensemble slice
                 "multivae_tpu_torch.ops.fused_sharded",
                 "multivae_tpu_torch.parallel",
                 "multivae_tpu_torch.parallel.mesh",
                 # the deep-architecture slice
                 "multivae_tpu_torch.ops.fused_generic"):
        assert name in mods


def test_import_loads_no_jax_stack_or_triton():
    code = (
        "import importlib, json, sys\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"print(json.dumps(sorted(m for m in {list(NOT_AT_IMPORT)!r} "
        "if m in sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_train_and_daa_load_no_jax_at_call_time(tmp_path):
    """A tiny ``train`` then ``daa`` through the CLI on the CPU."""
    code = (
        "import json, sys\n"
        "from multivae_tpu_torch.cli import main\n"
        "from multivae_tpu_torch.data import make_synthetic_cohort\n"
        "import multivae_tpu_torch.workflows as wf\n"
        "d, o = sys.argv[1], sys.argv[2]\n"
        "make_synthetic_cohort(d, n_subjects=90, n_scores=3, n_rois=12,\n"
        "                      missing_rate=0.2, seed=0)\n"
        "common = ['--dataset', 'synthetic', '--datasetdir', d,\n"
        "          '--outdir', o, '--device', 'cpu']\n"
        "main(['train', *common, '--input-dims', '3', '12',\n"
        "      '--latent-dim', '4', '--style-dim', '2', '3',\n"
        "      '--batch-size', '16', '--num-epochs', '1',\n"
        "      '--use-tensorboard', 'false'])\n"
        "run = [r for r in __import__('os').listdir(o)\n"
        "       if r.startswith('synthetic')][0]\n"
        "main(['daa', *common, '--run', run, '--n-validation', '1',\n"
        "      '--n-samples', '6', '--n-subjects', '8', '--M', '4'])\n"
        f"print(json.dumps(sorted(m for m in {list(NOT_AT_IMPORT)!r} "
        "if m in sys.modules)))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "data"),
         str(tmp_path / "out")], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert list((tmp_path / "out").glob("*/daa/*/significant_rois.tsv"))


def test_dp_and_ensemble_train_load_no_jax_at_call_time(tmp_path):
    """``train --data-parallel 4`` and ``train --num-models 2
    --ensemble-parallel true`` through the CLI on the CPU."""
    code = (
        "import json, sys\n"
        "from multivae_tpu_torch.cli import main\n"
        "from multivae_tpu_torch.data import make_synthetic_cohort\n"
        "d, o = sys.argv[1], sys.argv[2]\n"
        "make_synthetic_cohort(d, n_subjects=90, n_scores=3, n_rois=12,\n"
        "                      missing_rate=0.2, seed=0)\n"
        "common = ['--dataset', 'synthetic', '--datasetdir', d,\n"
        "          '--device', 'cpu', '--input-dims', '3', '12',\n"
        "          '--latent-dim', '4', '--style-dim', '2', '3',\n"
        "          '--batch-size', '16', '--num-epochs', '1',\n"
        "          '--use-tensorboard', 'false']\n"
        "main(['train', *common, '--outdir', o + '/dp',\n"
        "      '--data-parallel', '4'])\n"
        "main(['train', *common, '--outdir', o + '/ens',\n"
        "      '--num-models', '2', '--ensemble-parallel', 'true'])\n"
        f"print(json.dumps(sorted(m for m in {list(NOT_AT_IMPORT)!r} "
        "if m in sys.modules)))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "data"),
         str(tmp_path / "out")], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    flags = [json.loads(p.read_text())
             for p in sorted((tmp_path / "out").glob("*/*/flags.json"))]
    assert [(f["data_parallel"], f["ensemble_parallel"], f["num_models"])
            for f in flags] == [(4, "auto", 1), (1, True, 2)]
    assert "training epochs progress (ensemble of 2" in proc.stdout


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_level_banned_import(path):
    """No module imports the JAX stack or the JAX package, at any level;
    Triton, where a later kernel needs it, only inside the function that
    launches it."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in BANNED, (path, name)
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert all(n.split(".")[0] != "triton" for n in names), path
