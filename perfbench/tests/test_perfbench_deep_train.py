"""The cell ``hbn-mopoe-deep.train`` on the CPU: a whole run at a small
size, untraced and traced (the port's autograd general steps spanned and
counted); ``correct`` false with each training fault planted underneath,
on the routes deep-A takes; the five readers the cell adds."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, TINY, run_tiny
from test_perfbench_runs import (
    RUN_TINY, _moments_dropped_between_calls, _stale_batches)

WORKLOAD = "hbn-mopoe-deep.train"
READERS = ("trainer.general_step_ms.deep", "trainer.general_steps.deep",
           "generic_step_roofline", "train.mfu.deep",
           "device.idle_share.train-deep")


def test_a_deep_train_run_prints_a_well_formed_line_and_loads_no_jax():
    code = RUN_TINY.format(root=str(ROOT), workload=WORKLOAD, trace=False,
                           tiny=TINY)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_epoch_s", "setup_s"}
    assert list(result)[-1] == "compared"
    last = out.stderr.strip().splitlines()[-len(result["compared"]):]
    assert all(line.startswith("compared ") and " limit " in line
               for line in last)


def test_a_traced_deep_train_run_reads_the_general_steps():
    """On the CPU the trace holds no device work, so only the host span
    and the counter read; the counter is the batches outside the full
    complete ones, the same every epoch."""
    result, _, _ = run_tiny(WORKLOAD, trace=True)
    assert result["correct"] is True
    metrics = result["metrics"]
    assert metrics["trainer.general_step_ms.deep"]["value"] > 0
    steps = metrics["trainer.general_steps.deep"]["value"]
    assert steps >= 1 and steps == int(steps)


def _wrap_general_step(monkeypatch, after):
    from multivae_tpu_torch.train import trainer

    orig = trainer.general_step

    def broken(cfg, model, p, opt, *a, **k):
        saved = [t.clone() for t in (p, opt.mu, opt.nu)]
        opt2, loss, metrics = orig(cfg, model, p, opt, *a, **k)
        return after(saved, p, opt2, loss, metrics)
    monkeypatch.setattr(trainer, "general_step", broken)


def _general_state_unchanged(monkeypatch):
    def unchanged(saved, p, opt, loss, metrics):
        for t, s in zip((p, opt.mu, opt.nu), saved):
            t.copy_(s)
        return opt, loss, metrics
    _wrap_general_step(monkeypatch, unchanged)


def _general_loss_altered(monkeypatch):
    _wrap_general_step(monkeypatch, lambda saved, p, opt, loss, metrics: (
        opt, loss, {k: v * 1.01 for k, v in metrics.items()}))


def _half_batches(monkeypatch):
    from multivae_tpu_torch.train import trainer

    orig = trainer.epoch_batches

    def halves(exp, model_idx, epoch):
        full, general = orig(exp, model_idx, epoch)
        return [], [{m: x[:len(x) // 2] for m, x in d.items()}
                    for d in full + general]
    monkeypatch.setattr(trainer, "epoch_batches", halves)


@pytest.mark.parametrize("plant", [
    _general_state_unchanged, _general_loss_altered, _half_batches,
    _stale_batches, _moments_dropped_between_calls])
def test_deep_train_faults_are_caught(monkeypatch, plant):
    plant(monkeypatch)
    result, _, _ = run_tiny(WORKLOAD)
    assert result["correct"] is False


@pytest.mark.parametrize("name", READERS)
def test_each_new_reader_reads_nothing_without_a_trace(name):
    from perfbench import harness

    reader = harness.load_module(
        harness.HERE / "metrics" / f"{name}.py",
        "perfbench.metrics." + harness._ident(name))
    counts = {"epochs": 3, "model_flops_per_epoch": 1e9,
              "step_kernel_bound_s_per_epoch": 1e-4}
    for view in (harness.LayerView(None, {}),
                 harness.LayerView(None, counts)):
        assert reader.read(view) is None
