"""The first training epoch in plain PyTorch and NumPy: data, batches,
noise, MoPoE steps by autograd, Adam, and the test pass.

What it works out again from the raw cohort files and the seed:

* each block standardized by the train split's rows where it is present
  (float64 mean and population standard deviation, applied in float32);
* the epoch's batches: the train subjects grouped by the blocks they have
  (subsets in combination order), each group permuted by
  ``default_rng(seed + epoch)`` and cut into ``batch_size`` rows; the full
  batches in a permuted order, then the partial ones in a permuted order;
* the noise: a CPU ``torch.Generator`` seeded with
  ``SeedSequence([seed, 0, epoch])``'s first 64-bit word (top bit
  cleared), one ``randn(rows * width)`` per batch in emission order (the
  full complete batches, then the others), then one per test batch;
* the steps in the trainer's order: the full complete batches first, then
  the other batches grouped by ``(blocks, rows)`` in sorted order, each
  group in emission order; every step is autograd of :func:`model.loss`
  and one Adam update (``1 - b ** t`` bias corrections);
* the test pass: the test subjects permuted by ``default_rng(seed +
  epoch)``, cut into ``batch_size`` rows, full complete batches first, the
  rest grouped by ``(blocks, rows)`` in sorted order; the loss of each at
  the epoch's final weights with its noise.

The train/test split is the one the data layer wrote
(``multiblock_idx_{train,test}.npz``): the reference follows it and checks
it by itself (:func:`check_split`), and does not redo its stratification.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import model as ref

SPLIT_FILES = ("multiblock_idx_train.npz", "multiblock_idx_test.npz")


def load_split(datadir: str, names):
    """``{split: {block: row index or -1 per subject}}`` of the data
    layer's split files."""
    out = {}
    for split, fname in zip(("train", "test"), SPLIT_FILES):
        with np.load(os.path.join(datadir, fname), allow_pickle=True) as fh:
            out[split] = {m: np.array([-1 if v is None else int(v)
                                       for v in fh[m]]) for m in names}
    return out


def check_split(split, n_subjects: int, n_complete: int) -> List[str]:
    """What is wrong with the split: every subject (its clinical row) in
    exactly one side; every test subject with every block; the test side
    a fifth of the complete subjects, to the iterative stratifier's
    rounding (two points of the share)."""
    faults = []
    names = list(split["train"])
    ids = np.concatenate([split["train"][names[0]],
                          split["test"][names[0]]])
    if sorted(ids.tolist()) != list(range(n_subjects)):
        faults.append("the split does not hold every subject once")
    if any((split["test"][m] < 0).any() for m in names):
        faults.append("a test subject lacks a block")
    n_test = len(split["test"][names[0]])
    if abs(n_test / n_complete - 0.2) > 0.02:
        faults.append(f"{n_test} test subjects of {n_complete} complete")
    return faults


def scaled_blocks(datadir: str, split, names):
    """Each block's rows standardized by the train rows that have it."""
    out = {}
    for m in names:
        raw = np.load(os.path.join(datadir, f"{m}_data.npy"))
        rows = split["train"][m]
        fit = raw[rows[rows >= 0]].astype(np.float64)
        mean = fit.mean(axis=0)
        scale = fit.std(axis=0)
        scale[scale == 0] = 1.0
        out[m] = (raw - mean.astype(np.float32)) / scale.astype(np.float32)
    return out


def gather(blocks, rows_of, idxs, names):
    """``{block: [len(idxs), d]}`` of the blocks every row has."""
    out = {}
    for m in names:
        r = rows_of[m][idxs]
        if (r >= 0).all():
            out[m] = blocks[m][r].astype(np.float32)
    return out


def epoch_batches(rows_of, names, batch_size: int, seed: int):
    """The sampler's batches (lists of train-split positions)."""
    rng = np.random.default_rng(seed)
    has = np.stack([rows_of[m] >= 0 for m in names], axis=1)
    groups = []
    for combo in ref.subsets(names, names):
        want = np.array([m in combo for m in names])
        groups.append(np.flatnonzero((has == want).all(axis=1)))
    batches, complete, incomplete = [], [], []
    for group in groups:
        if not len(group):
            continue
        perm = rng.permutation(group.tolist())
        for start in range(0, len(perm), batch_size):
            b = perm[start:start + batch_size]
            (complete if len(b) >= batch_size else incomplete).append(
                len(batches))
            batches.append(b)
    order = (list(rng.permutation(complete)) if complete else []) + \
        (list(rng.permutation(incomplete)) if incomplete else [])
    return [batches[i] for i in order]


def noise_generator(seed: int, epoch: int) -> torch.Generator:
    word = np.random.SeedSequence([int(seed), 0, int(epoch)]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator().manual_seed(int(word) & (2 ** 63 - 1))


def noise_width(cfg: dict, present) -> int:
    return cfg["class_dim"] + sum(
        s for m, s in zip(ref.mod_names(cfg), ref.style_dims(cfg))
        if m in present)


def adam(p, mu, nu, g, t: int, cfg: dict) -> None:
    lr, b1, b2 = (cfg["initial_learning_rate"], cfg["beta_1"],
                  cfg["beta_2"])
    mu.mul_(b1).add_((1.0 - b1) * g)
    nu.mul_(b2).add_((1.0 - b2) * g * g)
    p.sub_(lr * (mu / (1.0 - b1 ** t))
           / (torch.sqrt(nu / (1.0 - b2 ** t)) + 1e-8))


def epoch_plan(cfg: dict, datadir: str, seed: int, epoch: int = 0):
    """The epoch's data: ``(train batches in step order, test batches in
    evaluation order)``, each entry ``(blocks dict, noise index)``, with the
    noise shapes in emission order; and the split's faults."""
    names = ref.mod_names(cfg)
    split = load_split(datadir, names)
    blocks = scaled_blocks(datadir, split, names)
    n_subjects = len(blocks[names[0]])
    n_complete = int(np.sum(np.all(
        [np.concatenate([split[s][m] for s in split]) >= 0 for m in names],
        axis=0)))
    faults = check_split(split, n_subjects, n_complete)
    bs = cfg["batch_size"]
    emitted = [gather(blocks, split["train"], b, names)
               for b in epoch_batches(split["train"], names, bs,
                                      seed + epoch)]
    full = [d for d in emitted
            if len(d) == len(names) and len(next(iter(d.values()))) == bs]
    others = [d for d in emitted
              if not (len(d) == len(names)
                      and len(next(iter(d.values()))) == bs)]
    # noise is drawn for the full complete batches, then the others, each
    # in sampler order
    emitted = full + others
    steps = list(range(len(full)))
    groups: Dict[Tuple, List[int]] = {}
    for i in range(len(full), len(emitted)):
        key = (tuple(sorted(emitted[i])), len(next(iter(emitted[i].values()))))
        groups.setdefault(key, []).append(i)
    for key in sorted(groups):
        steps += groups[key]
    train = [(emitted[i], i) for i in steps]
    order = np.random.default_rng(seed + epoch).permutation(
        len(split["test"][names[0]]))
    tb = [gather(blocks, split["test"], order[s:s + bs], names)
          for s in range(0, len(order), bs)]
    tb = [d for d in tb if d]
    scan = [i for i, d in enumerate(tb)
            if len(d) == len(names) and len(next(iter(d.values()))) == bs]
    rest = [i for i in range(len(tb)) if i not in scan]
    tgroups: Dict[Tuple, List[int]] = {}
    for i in rest:
        key = (tuple(sorted(tb[i])), len(next(iter(tb[i].values()))))
        tgroups.setdefault(key, []).append(i)
    emitted_test = [tb[i] for i in scan] + [tb[i] for i in rest]
    test_order = [(tb[i], k) for k, i in enumerate(scan)]
    for key in sorted(tgroups):
        test_order += [(tb[i], len(scan) + rest.index(i))
                       for i in tgroups[key]]
    shapes = ([(len(next(iter(d.values()))), noise_width(cfg, d))
               for d in emitted]
              + [(len(next(iter(d.values()))), noise_width(cfg, d))
                 for d in emitted_test])
    return train, test_order, shapes, len(emitted), faults


def follow_epoch(cfg: dict, datadir: str, weights: Dict[str, torch.Tensor],
                 seed: int, device, tf32: bool = False, epoch: int = 0,
                 half_batch: bool = False, start=None,
                 plan_epoch=None):
    """The reference's epoch ``epoch`` from ``weights``: ``{"losses": per
    step, "test_losses": per test batch, "params", "mu", "nu" (per leaf,
    after the epoch), "t" (Adam's steps after it), "faults"}``. ``start``
    carries Adam on: ``{"mu", "nu"}`` per leaf and ``"t"``, the steps taken
    before (default: a fresh Adam). ``tf32``, ``half_batch`` (every
    training step on the first half of its rows, the mean over them) and
    ``plan_epoch`` (the batches of another epoch, the noise of this one)
    are the controls and faults the comparison has to fail."""
    train, test_order, shapes, n_train, faults = epoch_plan(
        cfg, datadir, seed, epoch if plan_epoch is None else plan_epoch)
    gen = noise_generator(seed, epoch)
    noise = [torch.randn(r * w, generator=gen).view(r, w) for r, w in shapes]
    p = {k: v.detach().clone().float().to(device).requires_grad_(True)
         for k, v in weights.items()}
    if start is None:
        mu = {k: torch.zeros_like(v) for k, v in p.items()}
        nu = {k: torch.zeros_like(v) for k, v in p.items()}
        t0 = 0
    else:
        mu = {k: start["mu"][k].detach().clone().float().to(device)
              for k in p}
        nu = {k: start["nu"][k].detach().clone().float().to(device)
              for k in p}
        t0 = int(start["t"])
    trained = {k for k in p if not k.endswith("out_logvar")
               or cfg["learn_output_scale"]}
    losses = []
    for t, (data, i) in enumerate(train, start=t0 + 1):
        batch = {m: torch.from_numpy(x).to(device) for m, x in data.items()}
        eps = noise[i].to(device)
        if half_batch:
            keep = len(eps) // 2
            batch = {m: x[:keep] for m, x in batch.items()}
            eps = eps[:keep]
        for v in p.values():
            v.grad = None
        value = ref.loss(p, cfg, batch, eps, tf32)
        value.backward()
        losses.append(float(value.detach()))
        with torch.no_grad():
            for k, v in p.items():
                g = v.grad if (k in trained and v.grad is not None) \
                    else torch.zeros_like(v)
                adam(v, mu[k], nu[k], g, t, cfg)
    test_losses = []
    with torch.no_grad():
        for data, i in test_order:
            batch = {m: torch.from_numpy(x).to(device)
                     for m, x in data.items()}
            test_losses.append(float(ref.loss(
                p, cfg, batch, noise[n_train + i].to(device), tf32)))
    return {"losses": losses, "test_losses": test_losses,
            "params": {k: v.detach() for k, v in p.items()},
            "mu": mu, "nu": nu, "t": t0 + len(train), "faults": faults,
            "rows": [len(next(iter(d.values()))) for d, _ in train],
            "present": [tuple(sorted(d)) for d, _ in train]}


def follow_epochs(cfg: dict, datadir: str, weights: Dict[str, torch.Tensor],
                  seed: int, device, epochs, start, stale: bool = False,
                  **kw):
    """:func:`follow_epoch` over ``epochs`` in turn from ``weights`` and
    Adam's ``start``: the losses and test losses of all, joined, and the
    state after the last. ``stale``: each epoch on the batches of the one
    before it (a sampler that keeps an old permutation)."""
    losses, test_losses = [], []
    res = None
    for e in epochs:
        res = follow_epoch(cfg, datadir, weights, seed, device, epoch=e,
                           start=start, plan_epoch=e - 1 if stale else None,
                           **kw)
        losses += res["losses"]
        test_losses += res["test_losses"]
        weights, start = res["params"], res
    return dict(res, losses=losses, test_losses=test_losses)
