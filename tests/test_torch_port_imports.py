"""The PyTorch port stands alone: importing it loads no JAX stack and no
Triton, and no module of it imports one at module level."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "multivae_tpu_torch"
BANNED = ("jax", "flax", "optax", "triton")
# the JAX package itself: only the CLI's data layer loads it, inside a call
NOT_AT_IMPORT = BANNED + ("multivae_tpu",)


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
                 "multivae_tpu_torch.cli"):
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


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_level_banned_import(path):
    """Triton, where a later kernel needs it, is imported inside the
    function that launches it; the JAX stack never."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in BANNED, (path, name)
