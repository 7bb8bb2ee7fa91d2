"""``perfbench/counts.py`` against the hand counts."""

import json

import pytest

from conftest import ROOT
from perfbench import counts


def flagship():
    with open(ROOT / "perfbench/configs/hbn-mopoe.json") as fh:
        return json.load(fh)


def test_flagship_step_is_195_3_mflop():
    cfg = flagship()
    # per row: clinical encoder 4*7*256 + 6*256*2*23, ROI encoder
    # 4*444*256 + 6*256*2*40, decoders 6*23*7 + 6*40*444
    per_row = (4 * 7 * 256 + 6 * 256 * 46 + 4 * 444 * 256 + 6 * 256 * 80
               + 6 * 23 * 7 + 6 * 40 * 444)
    assert counts.step_flops(cfg, 256, ("clinical", "rois")) == \
        per_row * 256
    assert counts.step_flops(cfg, 256, ("clinical", "rois")) / 1e6 == \
        pytest.approx(195.3, abs=0.05)
    # a clinical-only step: its own encoder and decoder
    assert counts.step_flops(cfg, 164, ("clinical",)) == \
        (4 * 7 * 256 + 6 * 256 * 46 + 6 * 23 * 7) * 164


def test_deep_decoder_and_sample_scale_are_counted():
    cfg = dict(flagship(), num_hidden_layer_decoder=1,
               learn_output_sample_scale=True)
    dec = 6 * (23 * 256 + 256 * 14) + 6 * (40 * 256 + 256 * 888)
    enc = 4 * 7 * 256 + 6 * 256 * 46 + 4 * 444 * 256 + 6 * 256 * 80
    assert counts.step_flops(cfg, 10, ("clinical", "rois")) == \
        10 * (enc + dec)


def test_sweep_bound_is_the_kernel_table_s():
    # 1400 cells x 50 rows (P = 200): 0.06225 ms by operations (the
    # port's kernel table, row 1)
    cfg = dict(flagship(), daa_n_samples=200)
    assert counts.sweep_kernel_bound_s(cfg) * 1e3 == pytest.approx(
        0.06225, abs=5e-5)
    per_row = 2 * (7 * 256 + 256 * 40) + 2 * 40 * 444
    assert counts.sweep_cell_flops(cfg)[0] == per_row


def test_step_bytes_and_bound():
    cfg = flagship()
    n = counts.n_params(cfg)
    assert n == (7 * 256 + 256 + 256 * 46 + 46 + 444 * 256 + 256
                 + 256 * 80 + 80 + 23 * 7 + 7 + 7 + 40 * 444 + 444 + 444)
    b = counts.step_bytes(cfg, [(256, ("clinical", "rois"))])
    assert b == 24 * n + 4 * 256 * (451 + 43)
    assert counts.bound_s(67e12, 0.0) == 1.0
    assert counts.bound_s(0.0, 3.35e12) == 1.0
