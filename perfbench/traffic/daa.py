"""Traffic ``daa``: back-to-back ``run_daa`` calls as users run them
(likelihood sampling, ``daa_n_subjects`` subjects, ``daa_n_samples``
samples, ``daa_M`` reconstructions, the hierarchical regression, the vote
at ``daa_trust_level``, the ``stats-only`` artifact), each call with a
seed of its own drawn from the run's seed: whole calls, as many as make
the window's length closest to ``--seconds`` at the window's own pace (a
call is added while the time so far plus half a call stays under it), so
that a window never holds a call that only began before its end.

Set-up makes the cohort arrays and the weights from the seed, builds the
model and warms the shapes up with a call of ``daa_warmup_rounds``
rounds. The comparison
(:mod:`perfbench.reference.daa`) follows the last call and one more drawn
from the seed, round by round, and judges every file the call wrote.
"""

from __future__ import annotations

import csv
import math
import os
import time

import numpy as np
import torch

from .. import compare, counts as cnt
from ..cohort import daa_cohort_arrays
from ..reference import daa as ref_daa
from ..weights import make_weights
from .train import MODEL_KEYS

SPANS = [
    "multivae_tpu_torch.analysis.daa:reconstruction_stats",
    "multivae_tpu_torch.analysis.daa:avatar_sweep",
    "multivae_tpu_torch.analysis.daa:_device_suffstats",
    "multivae_tpu_torch.analysis.daa:compute_significativity",
]


def call_seed(seed: int, i: int) -> int:
    """The seed of call ``i`` of the run (-1: the warm-up call)."""
    word = np.random.SeedSequence([int(seed), int(i) + 1]).generate_state(
        1, dtype=np.uint32)[0]
    return int(word) & 0x7FFFFFFF


def _call(state, ctx, seed: int, n_validation: int, where: str) -> str:
    from multivae_tpu_torch.analysis.daa import run_daa

    c = ctx.cfg
    return run_daa(state["cfg"], [state["model"]], [state["cohort"]],
                   os.path.join(ctx.workdir, where),
                   sampling_strategy="likelihood", n_validation=n_validation,
                   n_samples=c["daa_n_samples"],
                   n_subjects=c["daa_n_subjects"], M=c["daa_M"],
                   trust_level=c["daa_trust_level"], seed=seed,
                   reg_method="hierarchical", sample_latents=True,
                   fetch_dtype=c["daa_fetch_dtype"],
                   artifact=c["daa_artifact"])


def setup(ctx):
    c = ctx.cfg
    from multivae_tpu_torch.analysis.daa import DaaCohort
    from multivae_tpu_torch.models import build_model, make_modalities
    from multivae_tpu_torch.train.config import Config

    ctx.mark("import")
    torch.zeros(1, device=ctx.device)
    ctx.mark("cuda_context")
    arrays = daa_cohort_arrays(c, ctx.seed)
    cohort = DaaCohort(
        clinical_names=arrays["clinical_names"],
        rois_names=arrays["rois_names"],
        train_clinical=arrays["train_clinical"],
        test_data={"clinical": arrays["test_clinical"],
                   "rois": arrays["test_rois"]},
        metadata_columns=list(arrays["metadata_columns"]),
        test_metadata=arrays["test_metadata"])
    ctx.mark("cohort")
    cfg = Config(dataset="synthetic", seed=ctx.seed,
                 **{k: c[k] for k in MODEL_KEYS}).derive()
    model = build_model(cfg, make_modalities(cfg.input_dim, cfg.style_dim,
                                             cfg.likelihood), ctx.device)
    weights = make_weights(c, ctx.seed, ctx.device)
    leaves = dict(model.named_parameters())
    if set(leaves) != set(weights):
        raise RuntimeError(f"the model's leaves {sorted(leaves)} are not "
                           f"the config's {sorted(weights)}")
    with torch.no_grad():
        for k, v in weights.items():
            leaves[k].copy_(v)
    ctx.mark("model")
    state = {"cfg": cfg, "model": model, "cohort": cohort,
             "arrays": arrays, "weights": weights}
    _call(state, ctx, call_seed(ctx.seed, -1), c["daa_warmup_rounds"],
          "warm_up")
    ctx.mark("warm_up")
    return state


def window(state, ctx):
    n_val = ctx.cfg["daa_n_validation"]
    calls, walls = [], []
    t0 = time.perf_counter()
    while not calls or (time.perf_counter() - t0
                        + 0.5 * sum(walls) / len(walls) < ctx.seconds):
        seed = call_seed(ctx.seed, len(calls))
        t = time.perf_counter()
        calls.append((seed, _call(state, ctx, seed, n_val, "daa")))
        walls.append(time.perf_counter() - t)
    state["calls"] = calls
    ctx.notes["call_wall_s"] = walls
    return {"units": len(calls) * n_val, "attempted": len(calls),
            "failed": 0}


def end_to_end(state, done):
    return {"daa_round_s": done["wall_s"] / done["units"]}


def counts(ctx, state, done):
    closed = ref_daa.sweep_architecture(ctx.cfg)
    return {"rounds": done["units"],
            "round_flops": cnt.daa_round_flops(ctx.cfg, closed),
            "sweep_kernel_bound_s": cnt.sweep_kernel_bound_s(ctx.cfg)}


def read_call(resdir: str, rois_names) -> dict:
    """What a call wrote, as arrays."""
    def load(name):
        return np.load(os.path.join(resdir, name), allow_pickle=True)

    with np.load(os.path.join(resdir, "regression_suffstats.npz")) as fh:
        suff = {k: fh[k] for k in ("ysum", "xysum")}
    col = {str(n): j for j, n in enumerate(rois_names)}
    with open(os.path.join(resdir, "significant_rois.tsv")) as fh:
        rows = list(csv.DictReader(fh, delimiter="\t"))
    return {"scores": load("sampled_scores.npy"),
            "subjects": load("metadatas.npy")[..., 0],
            "recon": load("rois_reconstructions.npy"),
            "pvalues": load("pvalues.npy"), "coefs": load("coefs.npy"),
            "significant": [(int(r["score"].rsplit("_", 1)[1]),
                             col[f"{r['roi']}_{r['metric']}"])
                            for r in rows], **suff}


def outputs(state):
    calls = state["calls"]
    pick = {len(calls) - 1, int(np.random.default_rng(
        calls[0][0]).integers(len(calls)))}
    names = state["arrays"]["rois_names"]
    return {"calls": [(calls[i][0], read_call(calls[i][1], names))
                      for i in sorted(pick)],
            "arrays": state["arrays"], "weights": state["weights"]}


def numbers(prog: dict, ref: dict) -> dict:
    """The gaps between a call's outputs and the reference's."""
    vote = np.zeros_like(ref["vote"])
    for s, r in prog["significant"]:
        vote[s, r] = True
    thr = math.log10(ref["threshold"])
    near = (np.abs(np.log10(np.clip(ref["pvalues"], 1e-300, None)) - thr)
            < 0.05).any(axis=0)
    return {
        "subjects": float(np.sum(prog["subjects"] != ref["subjects"])),
        "scores": compare.scaled_max(prog["scores"], ref["scores"]),
        "reconstruction": compare.scaled_max(prog["recon"], ref["recon"]),
        "suffstats": max(compare.scaled_max(prog["ysum"], ref["ysum"]),
                         compare.scaled_max(prog["xysum"], ref["xysum"])),
        "coefs": compare.scaled_max(prog["coefs"], ref["coefs"]),
        "log_pvalues": compare.log_p_gap(prog["pvalues"], ref["pvalues"]),
        "vote": float(np.sum((vote != ref["vote"]) & ~near)),
    }


def reference(ctx, arrays, weights, seed: int, tf32: bool = False):
    if ctx.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return ref_daa.follow_call(ctx.cfg, arrays, weights, seed,
                               ctx.cfg["daa_n_validation"], ctx.device,
                               tf32, getattr(torch,
                                             ctx.cfg["daa_fetch_dtype"]))


def judge(ctx, out):
    worst = {}
    for seed, prog in out["calls"]:
        got = numbers(prog, reference(ctx, out["arrays"], out["weights"],
                                      seed))
        for k, v in got.items():
            v = v if not math.isnan(v) else math.inf
            worst[k] = max(worst.get(k, -math.inf), v)
    return [(k, v, float(ctx.limits[k])) for k, v in worst.items()]


def as_outputs(ref: dict) -> dict:
    """A reference call in the form of the program's outputs."""
    out = {k: np.array(ref[k], copy=True) for k in
           ("scores", "subjects", "recon", "pvalues", "coefs", "ysum",
            "xysum")}
    out["significant"] = [tuple(int(i) for i in sr)
                          for sr in np.argwhere(ref["vote"])]
    return out


def control_readings(ctx, out) -> dict:
    """The numbers of the program and of the reference put in its place
    with each fault the comparison has to catch: TF32 products, the
    regressions over half of each round's subjects, one avatar sum
    altered by 1 %."""
    seed, prog = out["calls"][-1]
    args = (ctx.cfg, out["arrays"], out["weights"], seed,
            ctx.cfg["daa_n_validation"], ctx.device)
    wire = getattr(torch, ctx.cfg["daa_fetch_dtype"])
    base = reference(ctx, out["arrays"], out["weights"], seed)
    altered = as_outputs(base)
    altered["ysum"][0, 0, 0, 0] *= 1.01
    return {"program": numbers(prog, base),
            "tf32": numbers(as_outputs(ref_daa.follow_call(
                *args, tf32=True, wire=wire)), base),
            "half_batch": numbers(as_outputs(ref_daa.follow_call(
                *args, wire=wire, half_batch=True)), base),
            "altered_sum": numbers(altered, base)}
