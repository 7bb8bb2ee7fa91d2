"""The PyTorch port stands alone: importing it loads no JAX stack, no JAX
package, no scikit-learn, no Triton and no matplotlib; no module of it,
nor `chip_smoke.py`, imports the JAX stack, the JAX package or
scikit-learn anywhere; and its `train` (with the eval cadence), `eval`,
`daa` and the ten analysis and plot commands load none of them at call
time (the card's machine has neither)."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "multivae_tpu_torch"
BANNED = ("jax", "flax", "optax", "multivae_tpu", "sklearn")
# Triton, where a kernel needs it, is imported inside the launching function,
# matplotlib inside the functions that draw
NOT_AT_IMPORT = BANNED + ("triton", "matplotlib")


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
                 "multivae_tpu_torch.ops.fused_generic",
                 # the eval slice
                 "multivae_tpu_torch.eval",
                 "multivae_tpu_torch.eval.estimators",
                 "multivae_tpu_torch.eval.prd",
                 "multivae_tpu_torch.eval.likelihood",
                 "multivae_tpu_torch.eval.sample_quality",
                 "multivae_tpu_torch.eval.representation",
                 "multivae_tpu_torch.eval.coherence",
                 # the analysis slice
                 "multivae_tpu_torch.analysis.anova",
                 "multivae_tpu_torch.analysis.rsa",
                 "multivae_tpu_torch.analysis.avatars",
                 "multivae_tpu_torch.data.cohorts",
                 "multivae_tpu_torch.constants",
                 "multivae_tpu_torch.viz",
                 "multivae_tpu_torch.viz.plotting",
                 "multivae_tpu_torch.viz.surface",
                 "multivae_tpu_torch.viz.video",
                 # the parallel layer's last parts, the tracer, the JAX
                 # checkpoints, the auxiliary divergences
                 "multivae_tpu_torch.parallel.tensor",
                 "multivae_tpu_torch.parallel.pipeline",
                 "multivae_tpu_torch.train.profiling",
                 "multivae_tpu_torch.train.flax_msgpack",
                 "multivae_tpu_torch.ops.divergences_extra"):
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


def test_eval_paths_load_no_jax_or_sklearn_at_call_time(tmp_path):
    """``train`` with every eval flag and ``--save-samples``, then ``eval``
    and ``daa --artifact sampled``, through the CLI on the CPU."""
    code = (
        "import json, os, sys\n"
        "from multivae_tpu_torch.cli import main\n"
        "from multivae_tpu_torch.data import make_synthetic_cohort\n"
        "d, o = sys.argv[1], sys.argv[2]\n"
        "make_synthetic_cohort(d, n_subjects=90, n_scores=3, n_rois=12,\n"
        "                      missing_rate=0.2, seed=0)\n"
        "common = ['--dataset', 'synthetic', '--datasetdir', d,\n"
        "          '--outdir', o, '--device', 'cpu']\n"
        "main(['train', *common, '--input-dims', '3', '12',\n"
        "      '--latent-dim', '4', '--style-dim', '2', '3',\n"
        "      '--batch-size', '16', '--num-epochs', '2',\n"
        "      '--eval-freq', '1', '--eval-freq-fid', '1',\n"
        "      '--calc-nll', 'true', '--calc-prd', 'true',\n"
        "      '--calc-clf', 'true', '--calc-coherence', 'true',\n"
        "      '--save-samples', 'true', '--use-tensorboard', 'false'])\n"
        "run = [r for r in os.listdir(o) if r.startswith('synthetic')][0]\n"
        "main(['eval', *common, '--run', run])\n"
        "main(['daa', *common, '--run', run, '--n-validation', '1',\n"
        "      '--n-samples', '6', '--n-subjects', '8', '--M', '4',\n"
        "      '--artifact', 'sampled', '--sampled-rois', '4'])\n"
        f"print(json.dumps(sorted(m for m in {list(NOT_AT_IMPORT)!r} "
        "if m in sys.modules)))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "data"),
         str(tmp_path / "out")], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    out = tmp_path / "out"
    assert list(out.glob("*/eval/eval_latest.tsv"))
    assert list(out.glob("*/fid/random/rois/000000.npy"))
    assert list(out.glob("*/daa/*/rois_digital_avatars_sampled.npy"))


def test_analysis_commands_load_no_jax_or_sklearn_at_call_time(tmp_path):
    """A tiny ``train`` and ``daa``, then the ten analysis and plot
    commands, through the CLI on the CPU."""
    code = (
        "import json, os, sys\n"
        "from multivae_tpu_torch.cli import main\n"
        "from multivae_tpu_torch.data import make_synthetic_cohort\n"
        "from multivae_tpu_torch.viz.surface import SurfaceAtlas\n"
        "d, o = sys.argv[1], sys.argv[2]\n"
        "make_synthetic_cohort(d, n_subjects=90, n_scores=3, n_rois=12,\n"
        "                      missing_rate=0.2, seed=0)\n"
        "atlas = SurfaceAtlas.synthetic(roi_names=[f'roi{i:03d}' for i in\n"
        "                               range(4)], subdiv=1).save(o + '.npz')\n"
        "common = ['--dataset', 'synthetic', '--datasetdir', d,\n"
        "          '--outdir', o]\n"
        "cpu = ['--device', 'cpu']\n"
        "main(['train', *common, *cpu, '--input-dims', '3', '12',\n"
        "      '--latent-dim', '4', '--style-dim', '2', '3',\n"
        "      '--batch-size', '16', '--num-epochs', '1',\n"
        "      '--use-tensorboard', 'false'])\n"
        "run = [r for r in os.listdir(o) if r.startswith('synthetic')][0]\n"
        "grid = ['--n-validation', '2', '--n-samples', '6',\n"
        "        '--n-subjects', '8', '--M', '4']\n"
        "main(['daa', *common, *cpu, '--run', run, *grid])\n"
        "main(['anova', *common, '--run', run, *grid])\n"
        "main(['daa-robustness', *common, '--run', run, *grid])\n"
        "main(['daa-analysis', *common, '--run', run, *grid,\n"
        "      '--n-subjects-to-plot', '2'])\n"
        "main(['rsa', *common, *cpu, '--run', run, '--n-subjects', '12'])\n"
        "main(['rsa-plot', *common, '--run', run])\n"
        "main(['daa-plot-most-connected', *common, '--run', run,\n"
        "      '--trust-level', '0', '--plot-associations', 'true'])\n"
        "main(['daa-plot-score-metric', *common, *cpu, '--run', run,\n"
        "      '--score', 'score_0', '--metric', 'area', '--trust-level',\n"
        "      '0', '--surface-atlas', o + '.npz'])\n"
        "main(['hist-plot', '--datasets', 'synthetic', '--datasetdirs', d,\n"
        "      '--scores', 'score_1', '--outdir', o])\n"
        "main(['avatar-plot', *common, *cpu, '--run', run, '--n-frames',\n"
        "      '3', '--n-subjects', '2'])\n"
        "main(['univariate-tests', '--dataset', 'synthetic',\n"
        "      '--datasetdir', d, '--categorical-covs', 'sex', 'site',\n"
        "      '--outdir', o])\n"
        f"print(json.dumps(sorted(m for m in {list(BANNED)!r} "
        "if m in sys.modules)))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "data"),
         str(tmp_path / "out")], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    out = tmp_path / "out"
    res = list(out.glob("*/daa/*/"))
    assert len(res) == 1
    for name in ("anova_pvalues.npy", "figures/robustness_model_0.png",
                 "figures/avatars_vs_scores.png",
                 "associated_rois_for_score_0_in_area.png"):
        assert (res[0] / name).is_file(), name
    for pattern in ("*/rsa/kendalltau_stats.npy", "*/rsa/dissimilarity.png",
                    "hist.png", "*/avatar_traverse_score_0.avi",
                    "univariate/univariate_pvalues.npy"):
        assert list(out.glob(pattern)), pattern


def banned_imports(path):
    """``(module, line)`` of every import of a banned package in ``path``,
    at any level."""
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        found += [(n, node.lineno) for n in names
                  if n.split(".")[0] in BANNED]
    return found


def test_chip_smoke_imports_nothing_banned_and_needs_a_card(tmp_path):
    """``chip_smoke.py`` imports none of the banned packages anywhere, and
    without a card, or alone in a directory, it exits non-zero before
    printing any result."""
    script = REPO / "chip_smoke.py"
    assert banned_imports(script) == []
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "chip_smoke.py").write_text(script.read_text())
    for where in (REPO, alone):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


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


def test_tp_profile_and_jax_run_load_no_jax_at_call_time(tmp_path):
    """``train --tensor-parallel 4 --data-parallel 2``, ``train
    --profile-dir`` and ``daa`` of a run directory in the JAX package's
    layout (msgpack files written by ``chip_smoke.py``'s own writer)
    through the CLI on the CPU, with no flax and no msgpack."""
    banned = list(NOT_AT_IMPORT) + ["msgpack"]
    code = (
        "import json, os, sys\n"
        "sys.path.insert(0, os.getcwd())\n"
        "import chip_smoke\n"
        "from multivae_tpu_torch.cli import main\n"
        "from multivae_tpu_torch.data import make_synthetic_cohort\n"
        "from multivae_tpu_torch.train.config import Config\n"
        "d, o = sys.argv[1], sys.argv[2]\n"
        "make_synthetic_cohort(d, n_subjects=90, n_scores=3, n_rois=12,\n"
        "                      missing_rate=0.2, seed=0)\n"
        "common = ['--dataset', 'synthetic', '--datasetdir', d,\n"
        "          '--device', 'cpu', '--input-dims', '3', '12',\n"
        "          '--latent-dim', '4', '--style-dim', '2', '3',\n"
        "          '--batch-size', '16', '--num-epochs', '1',\n"
        "          '--use-tensorboard', 'false']\n"
        "main(['train', *common, '--outdir', o + '/tp',\n"
        "      '--tensor-parallel', '4', '--data-parallel', '2'])\n"
        "main(['train', *common, '--outdir', o + '/prof',\n"
        "      '--profile-dir', o + '/trace'])\n"
        "cfg = Config(dataset='synthetic', datasetdir=d, input_dim=[3, 12],\n"
        "             class_dim=4, style_dim=[2, 3], batch_size=16).derive()\n"
        "run = chip_smoke.write_jax_layout_run(o + '/jx', cfg, 'jax')\n"
        "main(['daa', '--dataset', 'synthetic', '--datasetdir', d,\n"
        "      '--outdir', o + '/jx/jax', '--run', run, '--device', 'cpu',\n"
        "      '--n-validation', '1', '--n-samples', '6',\n"
        "      '--n-subjects', '8', '--M', '4'])\n"
        f"print(json.dumps(sorted(m for m in {banned!r} "
        "if m in sys.modules)))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "data"),
         str(tmp_path / "out")], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    flags = json.loads(next((tmp_path / "out" / "tp").glob(
        "*/flags.json")).read_text())
    assert (flags["tensor_parallel"], flags["data_parallel"]) == (4, 2)
    assert (tmp_path / "out" / "trace" / "epoch_0000.pt.trace.json").is_file()
    assert list((tmp_path / "out" / "jx" / "jax").glob(
        "*/daa/*/significant_rois.tsv"))
