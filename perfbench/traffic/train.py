"""Traffic ``train``: one ``run_epochs`` call of the trainer as users run
it (batch ``batch_size`` over the whole cohort every epoch, the test pass,
``metrics.csv`` and a checkpoint every 5 epochs), for as many epochs as
fill the window at the set-up's pace.

Set-up builds the experiment (the cohort written from the seed, weights
from the seed copied into the model, datasets, Adam state), drives it
through epoch 0 with a ``run_epochs`` call, then ``train_warmup_epochs``
more with another, which size the window. The window carries the same
experiment on with a third call.

What the plain reference (:mod:`perfbench.reference.train`) is held to is
read from what the run wrote, once the window has closed: ``metrics.csv``
and the checkpoints. Epoch 0 is followed from the seed's weights. The
window's epochs up to its first checkpoint are followed from the
checkpoint that closed the warm-up (the program's state: params, Adam's
moments), with Adam's step count the reference's own.
"""

from __future__ import annotations

import csv
import math
import os
import time

import numpy as np
import torch

from .. import compare, counts as cnt
from ..cohort import make_synthetic_cohort
from ..reference import train as ref_train
from ..weights import make_weights

SPANS = [
    "multivae_tpu_torch.train.trainer:epoch_batches",
    "multivae_tpu_torch.train.trainer:enqueue_train_epoch",
    "multivae_tpu_torch.train.trainer:test_one_epoch",
    "multivae_tpu_torch.train.trainer:_checkpoint_member",
    "multivae_tpu_torch.train.trainer:_Logs.write",
]

MODEL_KEYS = (
    "method", "input_dim", "class_dim", "style_dim", "hidden_dim",
    "num_hidden_layer_encoder", "num_hidden_layer_decoder", "likelihood",
    "learn_output_scale", "learn_output_sample_scale", "initial_out_logvar",
    "factorized_representation", "dropout_rate", "precision", "batch_size",
    "initial_learning_rate", "beta_1", "beta_2", "beta", "beta_style",
    "beta_content")


def _csv_losses(log_dir: str):
    """The ``loss`` rows of ``metrics.csv``, train and test, in order."""
    out = {"train": [], "test": []}
    with open(os.path.join(log_dir, "metrics.csv")) as fh:
        for row in csv.DictReader(fh):
            if row["metric"] == "loss" and row["phase"] in out:
                out[row["phase"]].append(float(row["value"]))
    return out


def read_checkpoint(ckpt_dir: str) -> dict:
    """A checkpoint as written (``model.npz``: the param tree by path,
    kernels as ``[in, out]``; ``opt_state.npz``: Adam's count and moments
    raveled in the sorted order of those paths), by the model's leaf
    names: ``{"params", "mu", "nu", "count"}``."""
    with np.load(os.path.join(ckpt_dir, "model.npz")) as fh:
        tree = {k: fh[k] for k in fh.files}
    with np.load(os.path.join(ckpt_dir, "opt_state.npz")) as fh:
        opt = {k: fh[k] for k in ("count", "mu", "nu")}

    def leaf_name(path):
        *parents, last = path.split("/")
        return ".".join(parents + ["weight" if last == "kernel" else last])

    def as_leaf(path, arr):
        t = torch.from_numpy(np.array(arr, np.float32))
        return t.T.contiguous() if path.endswith("/kernel") else t

    out = {"params": {leaf_name(k): as_leaf(k, v) for k, v in tree.items()},
           "count": int(opt["count"])}
    for key in ("mu", "nu"):
        vec, off, leaves = opt[key], 0, {}
        for path in sorted(tree, key=lambda p: tuple(p.split("/"))):
            n = tree[path].size
            leaves[leaf_name(path)] = as_leaf(
                path, vec[off:off + n].reshape(tree[path].shape))
            off += n
        if off != vec.size:
            raise ValueError(f"{ckpt_dir}: {key} holds {vec.size} floats, "
                             f"the param tree {off}")
        out[key] = leaves
    return out


def first_checkpoint(start: int, end: int) -> int:
    """The first epoch from ``start`` on whose end ``run_epochs`` checkpoints
    in a call that ends at ``end``."""
    e = start
    while (e + 1) % 5 and e + 1 != end:
        e += 1
    return e


def setup(ctx):
    c = ctx.cfg
    from multivae_tpu_torch.train import trainer
    from multivae_tpu_torch.train.config import Config
    from multivae_tpu_torch.train.experiment import MultimodalExperiment
    from multivae_tpu_torch.utils.filehandling import create_dir_structure

    ctx.mark("import")
    torch.zeros(1, device=ctx.device)
    ctx.mark("cuda_context")
    datadir = os.path.join(ctx.workdir, "data")
    make_synthetic_cohort(datadir, c["n_subjects"], c["n_scores"],
                          c["n_rois"], c["missing_rate"], ctx.seed)
    ctx.mark("cohort")
    cfg = Config(dataset="synthetic", datasetdir=datadir,
                 dir_experiment=os.path.join(ctx.workdir, "runs"),
                 seed=ctx.seed, **{k: c[k] for k in MODEL_KEYS}).derive()
    create_dir_structure(cfg)
    exp = MultimodalExperiment(cfg, ctx.device)
    weights = make_weights(c, ctx.seed, ctx.device)
    leaves = dict(exp.models[0].named_parameters())
    if set(leaves) != set(weights):
        raise RuntimeError(f"the model's leaves {sorted(leaves)} are not "
                           f"the config's {sorted(weights)}")
    with torch.no_grad():
        for k, v in weights.items():
            leaves[k].copy_(v)
    exp.set_datasets()
    exp.set_optimizers()
    ctx.mark("model")

    cfg.start_epoch, cfg.end_epoch = 0, 1
    trainer.run_epochs(exp, use_tensorboard=False, progress=False)
    ctx.mark("first_epoch")

    warm = int(c["train_warmup_epochs"])
    cfg.start_epoch, cfg.end_epoch = 1, 1 + warm
    t0 = time.perf_counter()
    trainer.run_epochs(exp, use_tensorboard=False, progress=False)
    ctx.sync()
    per_epoch = (time.perf_counter() - t0) / warm
    ctx.mark("warm_up")
    epochs = max(1, int(round(ctx.seconds / per_epoch)))
    return {"exp": exp, "cfg": cfg, "weights": weights, "datadir": datadir,
            "epochs": epochs, "next": 1 + warm}


def window(state, ctx):
    from multivae_tpu_torch.train import trainer

    cfg = state["cfg"]
    cfg.start_epoch = state["next"]
    cfg.end_epoch = state["next"] + state["epochs"]
    walls = trainer.run_epochs(state["exp"], use_tensorboard=False,
                               progress=False)
    ctx.notes["epoch_wall_s"] = _quartiles(walls)
    n = state["epochs"]
    return {"units": n, "attempted": n, "failed": 0}


def _quartiles(values):
    """``[min, q1, median, q3, max]`` of ``values``."""
    return [float(x) for x in np.quantile(values, [0, .25, .5, .75, 1])]


def end_to_end(state, done):
    return {"train_epoch_s": done["wall_s"] / done["units"]}


def counts(ctx, state, done):
    """The window's epochs and, per epoch, the training steps' model FLOPs
    and the least time of the steps the hand-written step kernels take
    (every step on the split layout's architecture, the full complete
    batches elsewhere)."""
    c = ctx.cfg
    train = ref_train.epoch_plan(c, state["datadir"], ctx.seed)[0]
    batches = [(len(next(iter(d.values()))), tuple(d)) for d, _ in train]
    n_mods = len(c["input_dim"])
    split_layout = (n_mods == 2 and c["num_hidden_layer_encoder"] == 1
                    and c["num_hidden_layer_decoder"] == 0
                    and not c["learn_output_sample_scale"]
                    and c["likelihood"] == "normal")
    kernel = [(r, p) for r, p in batches
              if split_layout or (r == c["batch_size"] and len(p) == n_mods)]
    flops = sum(cnt.step_flops(c, r, p) for r, p in batches)
    kflops = sum(cnt.step_flops(c, r, p) for r, p in kernel)
    return {"epochs": done["units"], "model_flops_per_epoch": flops,
            "step_kernel_bound_s_per_epoch": cnt.bound_s(
                kflops, cnt.step_bytes(c, kernel))}


def outputs(state):
    """What the run wrote, read once the window has closed: every loss row
    of ``metrics.csv``, the checkpoints of epoch 0, of the warm-up's last
    epoch and of the window's first checkpointed epoch."""
    cfg, nxt = state["cfg"], state["next"]
    last = first_checkpoint(nxt, nxt + state["epochs"])
    ckpt = {e: read_checkpoint(os.path.join(cfg.dir_checkpoints,
                                            str(e).zfill(4)))
            for e in (0, nxt - 1, last)}
    return {"weights": {k: v.detach().cpu()
                        for k, v in state["weights"].items()},
            "datadir": state["datadir"], "rows": _csv_losses(cfg.dir_logs), "ckpt": ckpt,
            "window": list(range(nxt, last + 1)),
            "epochs_run": nxt + state["epochs"]}


def program_view(out: dict, steps: int, tests: int) -> dict:
    """The program's epoch 0 and window epochs, cut from its rows by the
    reference's steps and test batches an epoch (the same every epoch)."""
    rows, ckpt, win = out["rows"], out["ckpt"], out["window"]
    a, b = win[0], win[-1] + 1
    return {
        "first": {"train": rows["train"][:steps],
                  "test": rows["test"][:tests], **ckpt[0]},
        "start": ckpt[a - 1],
        "window": {"train": rows["train"][a * steps:b * steps],
                   "test": rows["test"][a * tests:b * tests], **ckpt[b - 1]},
        "logged": (len(rows["train"]), len(rows["test"])),
    }


def numbers(prog: dict, ref: dict, weights: dict, lr: float,
            epochs_run: int) -> dict:
    """The gaps between the program's epochs and the reference's: epoch 0
    from the seed's weights, and the window's epochs from the warm-up's
    last checkpoint."""
    first, win = ref["first"], ref["window"]
    steps, tests = len(first["losses"]), len(first["test_losses"])
    grad_ref = compare.leaf_norms(first["mu"])
    start = prog["start"]["params"]
    wgrad = compare.leaf_norms(win["mu"])
    p0, pw = prog["first"], prog["window"]
    return {
        "split_faults": float(len(first["faults"])),
        "first_loss": compare.rel_max(p0["train"][:1], first["losses"][:1]),
        "step_loss": compare.rel_max(p0["train"], first["losses"]),
        "test_loss": compare.rel_max(p0["test"], first["test_losses"]),
        "adam_moment": compare.worst_leaf(compare.leaf_norms(p0["mu"]),
                                          grad_ref, grad_ref),
        "param_change": compare.worst_leaf(
            compare.leaf_norms({k: v - weights[k]
                                for k, v in p0["params"].items()}),
            compare.leaf_norms({k: v - weights[k]
                                for k, v in first["params"].items()}),
            grad_ref),
        "moved_apart": compare.moved_apart(p0["params"], first["params"],
                                           weights, lr),
        "window_step_loss": compare.rel_max(pw["train"], win["losses"]),
        "window_test_loss": compare.rel_max(pw["test"], win["test_losses"]),
        "window_adam_moment": compare.worst_leaf(
            compare.leaf_norms(pw["mu"]), wgrad, wgrad),
        "window_param_change": compare.worst_leaf(
            compare.leaf_norms({k: v - start[k]
                                for k, v in pw["params"].items()}),
            compare.leaf_norms({k: v - start[k]
                                for k, v in win["params"].items()}),
            wgrad),
        "adam_count": float(abs(p0["count"] - first["t"])
                            + abs(pw["count"] - win["t"])),
        "logged_rows": float(abs(prog["logged"][0] - epochs_run * steps)
                             + abs(prog["logged"][1] - epochs_run * tests)),
    }


def reference(ctx, out, tf32: bool = False, half_batch: bool = False,
              stale: bool = False) -> dict:
    """The reference's epoch 0 from the seed's weights and its window
    epochs from the program's warm-up checkpoint, Adam's step count its
    own (every epoch takes the same number of steps)."""
    if ctx.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    c, d, seed, dev = ctx.cfg, out["datadir"], ctx.seed, ctx.device
    first = ref_train.follow_epoch(c, d, out["weights"], seed, dev, tf32,
                                   half_batch=half_batch)
    win = out["window"]
    start = out["ckpt"][win[0] - 1]
    window = ref_train.follow_epochs(
        c, d, start["params"], seed, dev, win,
        {"mu": start["mu"], "nu": start["nu"],
         "t": win[0] * len(first["losses"])},
        stale=stale, tf32=tf32, half_batch=half_batch)
    for run in (first, window):
        for key in ("params", "mu", "nu"):
            run[key] = {k: v.detach().cpu() for k, v in run[key].items()}
    return {"first": first, "window": window}


def _view(ctx, out, ref):
    return program_view(out, len(ref["first"]["losses"]),
                        len(ref["first"]["test_losses"]))


def judge(ctx, out):
    ref = reference(ctx, out)
    got = numbers(_view(ctx, out, ref), ref, out["weights"],
                  ctx.cfg["initial_learning_rate"], out["epochs_run"])
    return [(k, v if not math.isnan(v) else math.inf,
             float(ctx.limits[k])) for k, v in got.items()]


def as_outputs(ref: dict, prog: dict) -> dict:
    """A reference run in the form of the program's view (the warm-up
    checkpoint and the logged row counts are the program's)."""
    def part(r):
        return {"train": list(r["losses"]), "test": list(r["test_losses"]),
                "params": r["params"], "mu": r["mu"], "count": r["t"]}
    return {"first": part(ref["first"]), "start": prog["start"],
            "window": part(ref["window"]), "logged": prog["logged"]}


def control_readings(ctx, out) -> dict:
    """The numbers of the program and of the reference put in its place
    with each fault the comparison has to catch: TF32 products, every
    step on half its batch, a step's loss altered by 1 %, the state left
    unchanged, the window's epochs on the batches of the epoch before."""
    w, lr, n = out["weights"], ctx.cfg["initial_learning_rate"], \
        out["epochs_run"]
    base = reference(ctx, out)
    prog = _view(ctx, out, base)

    def read(ref_run):
        return numbers(as_outputs(ref_run, prog), base, w, lr, n)
    altered = as_outputs(base, prog)
    altered["first"]["train"][0] *= 1.01
    altered["window"]["train"][0] *= 1.01
    start = prog["start"]
    unchanged = as_outputs(base, prog)
    unchanged["first"].update(params=dict(w), count=0, mu={
        k: torch.zeros_like(v) for k, v in w.items()})
    unchanged["window"].update(params=start["params"], mu=start["mu"],
                               count=start["count"])
    return {"program": numbers(prog, base, w, lr, n),
            "tf32": read(reference(ctx, out, tf32=True)),
            "half_batch": read(reference(ctx, out, half_batch=True)),
            "altered_loss": numbers(altered, base, w, lr, n),
            "state_unchanged": numbers(unchanged, base, w, lr, n),
            "stale_batches": read(reference(ctx, out, stale=True))}
