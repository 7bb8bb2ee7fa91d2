"""The plain reference against the port at a small size on the CPU, its
statistics against scipy, and its independence from the program."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY
from perfbench.reference import daa as ref_daa
from perfbench.reference import model as ref
from perfbench.weights import make_weights


def config(name, **extra):
    with open(ROOT / f"perfbench/configs/{name}.json") as fh:
        cfg = json.load(fh)
    cfg.update(TINY, **extra)
    return cfg


def port_model(cfg, weights):
    from multivae_tpu_torch.models import build_model, make_modalities
    from multivae_tpu_torch.train.config import Config
    from perfbench.traffic.train import MODEL_KEYS

    c = Config(**{k: cfg[k] for k in MODEL_KEYS}).derive()
    model = build_model(c, make_modalities(c.input_dim, c.style_dim,
                                           c.likelihood), "cpu")
    leaves = dict(model.named_parameters())
    assert set(leaves) == set(weights)
    with torch.no_grad():
        for k, v in weights.items():
            leaves[k].copy_(v)
    return c, model


@pytest.mark.parametrize("name", ["hbn-mopoe", "hbn-mopoe-deep"])
@pytest.mark.parametrize("present", [("clinical", "rois"), ("clinical",)])
def test_loss_and_gradients_match_the_port(name, present):
    from multivae_tpu_torch.train.train_step import loss_and_metrics

    cfg = config(name)
    w = make_weights(cfg, 7, "cpu")
    c, model = port_model(cfg, w)
    gen = torch.Generator().manual_seed(3)
    dims = dict(zip(("clinical", "rois"), cfg["input_dim"]))
    batch = {m: torch.randn(37, dims[m], generator=gen) for m in present}
    eps = torch.randn(37, cfg["class_dim"] + sum(
        s for m, s in zip(("clinical", "rois"), cfg["style_dim"])
        if m in present), generator=gen)
    port_loss, _ = loss_and_metrics(c, model, batch, eps)
    port_loss.backward()
    p = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    mine = ref.loss(p, cfg, batch, eps)
    mine.backward()
    assert float(mine.detach()) == pytest.approx(float(port_loss.detach()),
                                                 rel=1e-5)
    for k, v in model.named_parameters():
        def grad(t):
            return t.grad if t.grad is not None else torch.zeros_like(t)
        torch.testing.assert_close(grad(p[k]), grad(v), rtol=1e-4,
                                   atol=1e-6)


def test_sweep_matches_the_port_general_sweep():
    from multivae_tpu_torch.analysis.daa import (general_sweep_cells,
                                                 general_sweep_inputs)
    from multivae_tpu_torch.ops.fused_daa import avatar_layout

    cfg = config("hbn-mopoe-deep")
    w = make_weights(cfg, 5, "cpu")
    _, model = port_model(cfg, w)
    gen = torch.Generator().manual_seed(9)
    data = {"clinical": torch.randn(8, 3, generator=gen),
            "rois": torch.randn(8, 12, generator=gen)}
    scores = torch.randn(4, 8, 3, generator=gen)
    g1 = torch.Generator().manual_seed(1)
    cdata, eps = general_sweep_inputs(model, data, scores, g1)
    port = general_sweep_cells(model, cdata, data["rois"], eps, True)
    g2 = torch.Generator().manual_seed(1)
    eps2 = torch.randn(eps.shape, generator=g2)
    mine = ref_daa.avatars(w, cfg, data, scores, eps2, False)
    torch.testing.assert_close(mine, port, rtol=1e-5, atol=1e-5)
    assert avatar_layout(port, 4, 3).shape == (8, 3, 4, 12)


def test_t_survival_matches_scipy():
    from scipy import stats

    t = np.array([0.0, 0.3, 1.0, 2.5, 7.0, 30.0, 200.0, np.inf])
    for nu in (4, 24, 49):
        want = stats.t.sf(t, nu)
        got = ref_daa.t_sf(t, nu)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-300)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159,
                      1e-20])
    r = ref.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0          # a tie to even
    assert r[2] == 1.0 + 2 ** -9
    assert abs(float(r[3]) + 3.14159) < 3.14159 * 2 ** -10
    m = r.view(torch.int32) & 0x1FFF
    assert bool((m == 0).all())


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.train, perfbench.reference.daa; "
            "bad = {n.split('.')[0] for n in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'multivae_tpu', 'multivae_tpu_torch'}; "
            "print(sorted(bad))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
