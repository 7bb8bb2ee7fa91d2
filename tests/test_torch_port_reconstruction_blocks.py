"""The DAA's Monte-Carlo reconstruction on the CPU: ``reconstruction_stats``
runs one inference and decodes its passes in blocks
(``MultimodalVAE.reconstruct`` on ``[k, B, noise_width]``). Held here to
the per-pass loop it replaced, kept as the oracle: the same means, the
generator left in the loop's state, the same result however the passes
fall into blocks; and ``forward``'s decodes are ``reconstruct``'s."""

import pytest
import torch

from multivae_tpu_torch.analysis.daa import (RECONSTRUCTION_BLOCK_ROWS,
                                             reconstruction_stats)
from multivae_tpu_torch.models import build_model, make_modalities
from multivae_tpu_torch.train import profiling
from multivae_tpu_torch.train.config import Config

DIMS, CD, STYLE, HIDDEN = (3, 12), 4, (2, 3), 16

ARCHS = {
    # a decoder hidden layer and a per-sample output scale
    "deep-A": dict(num_hidden_layer_decoder=1,
                   learn_output_sample_scale=True),
    "deep-B": dict(num_hidden_layer_encoder=2, num_hidden_layer_decoder=1,
                   dropout_rate=0.2),
    "laplace": dict(likelihood="laplace"),
    "unfactorized": dict(factorized_representation=False),
    # linear decoders: the closed form unless exact=False
    "flagship": {},
}
METHODS = ("joint_elbo", "moe", "jsd", "poe")
CASES = [(arch, method) for arch in ARCHS for method in METHODS]
IDS = [f"{arch}-{method}" for arch, method in CASES]


def model_and_data(arch, method, rows):
    cfg = Config(dataset="synthetic", input_dim=list(DIMS), class_dim=CD,
                 style_dim=list(STYLE), hidden_dim=HIDDEN, method=method,
                 **ARCHS[arch]).derive()
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), "cpu", seed=3)
    gen = torch.Generator().manual_seed(9)
    data = {m: torch.randn(rows, d, generator=gen)
            for m, d in zip(model.mod_names, DIMS)}
    return cfg, model, data


def blocked(arch, method, rows, M):
    """``(means, next draw, blocks counted)`` of ``reconstruction_stats``
    on the Monte-Carlo route."""
    cfg, model, data = model_and_data(arch, method, rows)
    gen = torch.Generator().manual_seed(5)
    before = profiling.COUNTS.get("daa.reconstruction_blocks", 0)
    out = reconstruction_stats(model, data, M, gen, cfg=cfg,
                               exact=False if arch == "flagship" else "auto")
    blocks = profiling.COUNTS["daa.reconstruction_blocks"] - before
    return out, torch.randn(16, generator=gen), blocks


def per_pass_loop(arch, method, rows, M):
    """The oracle: ``M`` whole forwards, each drawing its own noise, summed
    in float32 in pass order; ``(means, next draw)``."""
    _, model, data = model_and_data(arch, method, rows)
    gen = torch.Generator().manual_seed(5)
    names = model.mod_names
    sums = None
    with torch.no_grad():
        for _ in range(M):
            rec = model(data, sample_latents=True, generator=gen)["rec"]
            parts = (rec[names[0]][0], rec[names[0]][1], rec[names[1]][0])
            sums = parts if sums is None else tuple(
                s + p for s, p in zip(sums, parts))
    return tuple(s / M for s in sums), torch.randn(16, generator=gen)


def assert_means_close(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch, method", CASES, ids=IDS)
def test_blocked_passes_equal_the_per_pass_loop(arch, method):
    got, _, blocks = blocked(arch, method, 8, 24)
    want, _ = per_pass_loop(arch, method, 8, 24)
    assert blocks == 1
    assert_means_close(got, want)


@pytest.mark.parametrize("arch, method", CASES, ids=IDS)
def test_the_generator_ends_where_the_loop_leaves_it(arch, method):
    _, after, _ = blocked(arch, method, 8, 24)
    _, want = per_pass_loop(arch, method, 8, 24)
    assert torch.equal(after, want)


@pytest.mark.parametrize("arch, method", CASES, ids=IDS)
def test_the_result_does_not_depend_on_the_block_boundary(arch, method):
    """Rows enough for two passes a block, 5 passes: blocks of 2, 2 and 1,
    held to the loop, which has no block."""
    rows, M = 22000, 5
    assert RECONSTRUCTION_BLOCK_ROWS // rows == 2
    got, after, blocks = blocked(arch, method, rows, M)
    want, want_after = per_pass_loop(arch, method, rows, M)
    assert blocks == 3
    assert_means_close(got, want)
    assert torch.equal(after, want_after)


@pytest.mark.parametrize("sample", [True, False], ids=["sampled", "means"])
@pytest.mark.parametrize("arch", ["flagship", "deep-A"])
def test_forward_decodes_what_reconstruct_decodes(arch, sample):
    _, model, data = model_and_data(arch, "joint_elbo", 8)
    eps = torch.randn(8, model.noise_width(data),
                      generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(data, sample_latents=sample, noise=eps)["rec"]
        got = model.reconstruct(model.inference(data, sample=sample), data,
                                eps if sample else None)
    assert set(got) == set(want) == set(model.mod_names)
    for name in model.mod_names:
        for g, w in zip(got[name], want[name]):
            assert torch.equal(g, w)
