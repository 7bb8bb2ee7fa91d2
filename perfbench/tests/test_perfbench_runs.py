"""Whole runs of each traffic on the CPU at a small size: a well-formed
result line and no module of JAX or the JAX package loaded; ``correct``
false with the timed path broken underneath, once for each fault a cell
can have; the reference put in the program's place at a lower precision
reading above the limits. The card test runs a cell on the card."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, TINY, run_tiny

RUN_TINY = """
import json, sys, time
sys.path.insert(0, {root!r})
from pathlib import Path
from perfbench import harness
res, comp, host = harness.run_cell(Path({root!r}), {workload!r}, 2718281828,
                                   0.5, {trace}, "cpu", time.perf_counter(),
                                   1, {tiny!r})
sys.exit(harness.emit(res, comp, host))
"""


@pytest.mark.parametrize("workload,trace", [
    ("hbn-mopoe.train", False), ("hbn-mopoe.daa", True)])
def test_a_run_prints_a_well_formed_line_and_loads_no_jax(workload, trace):
    code = RUN_TINY.format(root=str(ROOT), workload=workload, trace=trace,
                           tiny=TINY)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    host, result = json.loads(lines[-2]), json.loads(lines[-1])
    assert {"affinity", "loadavg", "setup_split_s", "write_bytes"} <= set(
        host["host"])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        result)
    assert list(result)[-1] == "compared"
    assert result["correct"] is True and result["attempted"] >= 1
    want = {"hbn-mopoe.train": {"train_epoch_s", "setup_s"}}.get(workload)
    if not trace:
        assert set(result["metrics"]) == want
    else:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert "breakdown" in result
    last = out.stderr.strip().splitlines()[-len(result["compared"]):]
    assert all(line.startswith("compared ") and " limit " in line
               for line in last)


def _wrap_group_epoch(monkeypatch, after):
    from multivae_tpu_torch.train import trainer

    orig = trainer.make_group_fused_epoch

    def make(cfg, model, key):
        fn = orig(cfg, model, key)

        def broken(p, opt, xs, noise, masks=None):
            saved = [t.clone() for t in (p, opt.mu, opt.nu)]
            opt2, metrics, names = fn(p, opt, xs, noise, masks)
            return after(saved, p, opt2, metrics, names)
        return broken
    monkeypatch.setattr(trainer, "make_group_fused_epoch", make)


def test_train_state_left_unchanged_is_caught(monkeypatch):
    def unchanged(saved, p, opt, metrics, names):
        for t, s in zip((p, opt.mu, opt.nu), saved):
            t.copy_(s)
        return opt, metrics, names
    _wrap_group_epoch(monkeypatch, unchanged)
    result, compared, _ = run_tiny("hbn-mopoe.train")
    assert result["correct"] is False
    assert dict((n, v) for n, v, _ in compared)["param_change"] >= 0.5


def test_train_loss_altered_is_caught(monkeypatch):
    _wrap_group_epoch(monkeypatch, lambda saved, p, opt, metrics, names: (
        opt, metrics * 1.01, names))
    result, _, _ = run_tiny("hbn-mopoe.train")
    assert result["correct"] is False


def test_train_half_batches_are_caught(monkeypatch):
    from multivae_tpu_torch.train import trainer

    orig = trainer.epoch_batches

    def halves(exp, model_idx, epoch):
        full, general = orig(exp, model_idx, epoch)
        return [], [{m: x[:len(x) // 2] for m, x in d.items()}
                    for d in full + general]
    monkeypatch.setattr(trainer, "epoch_batches", halves)
    result, _, _ = run_tiny("hbn-mopoe.train")
    assert result["correct"] is False


def _stale_batches(monkeypatch):
    from multivae_tpu_torch.train import trainer

    orig = trainer.epoch_batches
    monkeypatch.setattr(trainer, "epoch_batches",
                        lambda exp, model_idx, epoch: orig(exp, model_idx, 0))


def _moments_dropped_between_calls(monkeypatch):
    from multivae_tpu_torch.train import trainer

    orig, calls = trainer.run_epochs, []

    def run_epochs(exp, *a, **k):
        calls.append(1)
        if len(calls) == 3:  # set-up made two calls; this is the window's
            exp.opt_states[0].mu.zero_()
            exp.opt_states[0].nu.zero_()
        return orig(exp, *a, **k)
    monkeypatch.setattr(trainer, "run_epochs", run_epochs)


@pytest.mark.parametrize("plant", [_stale_batches,
                                   _moments_dropped_between_calls])
def test_train_faults_from_epoch_one_on_are_caught(monkeypatch, plant):
    """Faults that leave epoch 0 sound: the epoch-0 batches kept for every
    epoch, Adam's moments lost between the set-up's calls and the
    window's. The window's epochs are held to the reference too."""
    plant(monkeypatch)
    result, compared, _ = run_tiny("hbn-mopoe.train")
    assert result["correct"] is False
    over = {n for n, v, lim in compared if v > lim}
    assert over and all(n.startswith("window_") for n in over), over


def test_daa_half_of_the_subjects_is_caught(monkeypatch):
    from multivae_tpu_torch.analysis import daa

    orig = daa.hierarchical_regression_from_stats

    def half(x, ysum, xysum):
        g = len(x) // 2
        pvals, coefs, _ = orig(x[:g], ysum[:g], xysum[:g])
        return pvals, coefs, orig(x, ysum, xysum)[2]
    monkeypatch.setattr(daa, "hierarchical_regression_from_stats", half)
    result, _, _ = run_tiny("hbn-mopoe.daa")
    assert result["correct"] is False


def test_daa_answer_altered_is_caught(monkeypatch):
    from multivae_tpu_torch.analysis import daa

    orig = daa._device_suffstats

    def altered(avatars, scores, roundtrip_dtype=None):
        ysum, xysum, yysum = orig(avatars, scores, roundtrip_dtype)
        ysum = ysum.clone()
        ysum[0, 0, 0] *= 1.01
        return ysum, xysum, yysum
    monkeypatch.setattr(daa, "_device_suffstats", altered)
    result, _, _ = run_tiny("hbn-mopoe.daa")
    assert result["correct"] is False


@pytest.mark.parametrize("workload", ["hbn-mopoe.train",
                                      "hbn-mopoe.daa"])
def test_the_lower_precision_control_reads_above_a_limit(workload):
    """The reference in TF32 put in the program's place, at the
    configurations' widths with a small cohort."""
    import time

    from perfbench import harness

    with open(ROOT / "BENCHMARK.json") as fh:
        manifest = json.load(fh)
    cell, config = harness.manifest_cell(manifest, workload)
    cfg = harness.load_json(ROOT / config["file"])
    cfg.update(n_subjects=600, daa_n_samples=20, daa_M=50,
               daa_n_validation=2, train_warmup_epochs=1,
               daa_warmup_rounds=1)
    limits = harness.load_json(harness.HERE / "limits" / f"{workload}.json")
    traffic = harness.load_module(
        harness.HERE / "traffic" / f"{cell['traffic']}.py",
        "perfbench.traffic." + harness._ident(cell["traffic"]))
    import tempfile
    with tempfile.TemporaryDirectory() as workdir:
        ctx = harness.Ctx(workload, cfg, limits, 31415, 0.0, False,
                          torch.device("cpu"), workdir, time.perf_counter())
        state = traffic.setup(ctx)
        traffic.window(state, ctx)
        readings = traffic.control_readings(ctx, traffic.outputs(state))
    assert all(v <= limits[k] for k, v in readings["program"].items())
    assert any(v > limits[k] for k, v in readings["tf32"].items())


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--threads", "1", "--workload",
         "hbn-mopoe.daa", "--seed", "2147483999", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
