"""The cell ``hbn-mopoe-deep.daa`` on the CPU: the port's Monte-Carlo
reconstruction, the route deep-A takes, against the plain reference's
M-pass average; a whole run at a small size; ``correct`` false with each
DAA fault planted underneath; the reference in TF32 put in the program's
place reading above a limit."""

import json

import pytest
import torch

from conftest import ROOT, run_tiny
from perfbench.reference import daa as ref_daa
from perfbench.weights import make_weights
from test_perfbench_reference import port_model
from test_perfbench_runs import (
    test_a_run_prints_a_well_formed_line_and_loads_no_jax as _run_line,
    test_the_lower_precision_control_reads_above_a_limit as _tf32_control)


def test_reconstruction_matches_the_port_monte_carlo():
    """Deep-A at its published widths, 6 subjects and 40 passes, both
    drawing from a generator of the same seed. The port sums the passes in
    float32 in order, the reference in float64: the means differ by the
    float32 sum's round-off, at most about M x 2^-24 = 2.4e-6 of the
    largest mean (2.4e-7 seen, means up to 1.07), while passes drawn from
    another seed move them by 0.05-0.15; hence rtol and atol 1e-5."""
    from multivae_tpu_torch.analysis.daa import reconstruction_stats
    from multivae_tpu_torch.train import profiling

    with open(ROOT / "perfbench/configs/hbn-mopoe-deep.json") as fh:
        cfg = json.load(fh)
    assert not ref_daa.sweep_architecture(cfg)
    w = make_weights(cfg, 13, "cpu")
    c, model = port_model(cfg, w)
    gen = torch.Generator().manual_seed(17)
    data = {m: torch.randn(6, d, generator=gen)
            for m, d in zip(("clinical", "rois"), cfg["input_dim"])}
    m_passes = 40
    before = profiling.COUNTS.get("daa.reconstruction_passes", 0)
    port = reconstruction_stats(model, data, m_passes,
                                torch.Generator().manual_seed(5), cfg=c,
                                exact="auto")
    # the route deep-A must take: the passes, not the closed form
    assert profiling.COUNTS["daa.reconstruction_passes"] - before == \
        m_passes
    mine = ref_daa.reconstruction(w, cfg, data,
                                  torch.Generator().manual_seed(5),
                                  m_passes, False)
    for got, want in zip(port, mine):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_a_deep_run_prints_a_well_formed_line_and_loads_no_jax():
    _run_line("hbn-mopoe-deep.daa", True)


def test_the_deep_lower_precision_control_reads_above_a_limit():
    _tf32_control("hbn-mopoe-deep.daa")


def _half_of_the_subjects(monkeypatch):
    from multivae_tpu_torch.analysis import daa

    orig = daa.hierarchical_regression_from_stats

    def half(x, ysum, xysum):
        g = len(x) // 2
        pvals, coefs, _ = orig(x[:g], ysum[:g], xysum[:g])
        return pvals, coefs, orig(x, ysum, xysum)[2]
    monkeypatch.setattr(daa, "hierarchical_regression_from_stats", half)


def _answer_altered(monkeypatch):
    from multivae_tpu_torch.analysis import daa

    orig = daa._device_suffstats

    def altered(avatars, scores, roundtrip_dtype=None):
        ysum, xysum, yysum = orig(avatars, scores, roundtrip_dtype)
        ysum = ysum.clone()
        ysum[0, 0, 0] *= 1.01
        return ysum, xysum, yysum
    monkeypatch.setattr(daa, "_device_suffstats", altered)


@pytest.mark.parametrize("plant", [_half_of_the_subjects, _answer_altered])
def test_deep_daa_faults_are_caught(monkeypatch, plant):
    plant(monkeypatch)
    result, _, _ = run_tiny("hbn-mopoe-deep.daa")
    assert result["correct"] is False
