"""Epoch runner: the per-epoch driver of ``multivae_tpu/train/trainer.py``.

Per member and epoch (``trainer.py:88-196, 347-414, 817-1008``):

* the :class:`~multivae_tpu_torch.data.MissingModalitySampler` (seeded
  ``cfg.seed + epoch``) emits subset-homogeneous batches; with
  ``fused_training`` the full-size complete batches run first, in sampler
  order, in one epoch call; the remaining batches then run grouped by
  ``(presence pattern, rows)`` in :func:`canonical_group_order`, one epoch
  call per group. Complete batches, full or partial, of ``joint_elbo``
  without dropout take the MoPoE step kernel (``ops/fused_step.py``,
  ``csrc/mopoe_step.cu``), those of moe, jsd, poe and of any method with
  dropout the method step kernel (``ops/fused_methods.py``,
  ``csrc/method_step.cu``); a single-present group takes the presence
  kernel (``ops/fused_presence.py``, ``csrc/presence_step.cu``). The three
  kernels are persistent: on a card a group's epoch call is ONE launch
  that runs all its steps with Adam inside. Without ``fused_training``
  every batch takes the general autograd step, in the same order with the
  same noise and masks;
* a config outside the split layout (more encoder hidden layers, decoder
  hidden layers, a per-sample output scale, the laplace, bernoulli or
  categorical likelihood, an unfactorized latent) inside the layer-stack
  step's envelope (``ops/fused_generic.py``) sends its full complete
  batches to that kernel (``csrc/generic_step.cu``, persistent as well:
  one launch with Adam inside) and every other batch
  (the partial complete batch, the single-present groups) to the general
  autograd step, as the JAX package does (``trainer.py:896-899,
  925-944``);
* with ``data_parallel = N > 1`` the full complete batches take the
  data-parallel epoch (``ops/fused_sharded.py``): each batch's rows split
  over a data mesh of ``N`` entries, every shard runs the row-slice entry
  point of the same step kernel, the shards' gradients are summed in shard
  order and one Adam update follows. Every other group (the partial
  complete batch, the single-present groups) takes the unsharded kernels
  as above, on the first device. ``batch_size`` must be a multiple of
  ``N``. Noise and masks are the unsharded run's, row-sliced, so the two
  runs agree to the order of the sums;
* the test split is evaluated with the general forward and
  :func:`~multivae_tpu_torch.train.losses.total_loss`;
* every 5 epochs and at the end the model and optimizer state are
  checkpointed in the JAX package's layout.

Noise: torch cannot reproduce JAX's threefry streams. Each epoch's noise
comes from one generator seeded by ``(cfg.seed, model_idx, epoch)``
(:func:`epoch_generator`, the counterpart of ``fold_in(base_rng, epoch)``),
drawn on the CPU per step in emission order (the full complete batches,
then the other training batches in sampler order, then the test batches)
and copied to the device in one transfer for the training steps and one
for the test pass. With ``dropout_rate > 0`` the kernels' pre-scaled keep
masks (``bernoulli(1 - rate) / (1 - rate)``, ``[B, hidden]``, one per
encoder pass) come from a generator of their own (:func:`mask_generator`,
the counterpart of ``fold_in(key, 7)``), so the noise of a run does not
depend on its dropout rate; they are drawn in the same order and copied
once per epoch; the general step takes the same masks (one per hidden layer
of every network and pass,
:func:`~multivae_tpu_torch.train.train_step.general_mask_count`). The test
pass takes no mask. The
metrics are fetched once for each pass. Configurations whose TPU route is
a kernel the port does not have yet raise ``NotImplementedError`` naming
the ROADMAP item; nothing falls back.
The chunked drivers are not ported: ``epoch_chunk`` is accepted and the
per-epoch driver runs (ROADMAP Queue 1 item 5).

Ensembles (``trainer.py:199-238, 1011-1105``): :func:`run_epochs` trains
the members in turn, or, when :func:`resolve_ensemble` says so
(``ensemble_parallel``), :func:`run_epochs_ensemble` runs epochs outermost
and the members inside, each member's epoch being the same function on the
member's mesh device and CUDA stream, with the member's own generators:
the result is the sequential run's, bit for bit. The JAX package's stacked
``vmap`` step over the members' common prefix is not ported (ROADMAP Queue
1 item 4).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import MissingModalitySampler, simple_batches
from ..ops import (
    fused_generic,
    fused_methods,
    fused_presence,
    fused_sharded,
    fused_step,
)
from ..ops.adam import AdamState, adam_hyper
from ..parallel import data_mesh, make_mesh, spread, visible_cards
from ..params import dims_from, load_flat_params, model_flat_params
from ..utils.filehandling import model_checkpoint_dir, model_log_dir
from .checkpoint import save_checkpoint, save_networks
from .logging import MetricLogger
from .train_step import (
    batch_noise_width,
    eval_step,
    general_mask_count,
    general_step,
)


def unported_features(cfg, model) -> List[str]:
    """Each part of ``cfg`` whose route in the JAX package is a kernel or a
    driver the port does not have yet, with its ROADMAP item."""
    out = []
    if getattr(cfg, "precision", "float32") != "float32":
        out.append(f"precision={cfg.precision!r}: bf16 kernel products "
                   f"(ROADMAP Queue 1 item 8)")
    if not fused_step.split_layout_ok(cfg, model):
        # outside the split layout the layer-stack step's envelope decides
        out += fused_generic.envelope_gaps(cfg, model)
        if cfg.data_parallel > 1:
            out.append("data_parallel > 1 with an architecture outside the "
                       "split layout: the row-sharded general step (ROADMAP "
                       "Queue 1 item 4)")
    if cfg.tensor_parallel > 1:
        out.append("tensor_parallel > 1: tensor-parallel training (ROADMAP "
                   "Queue 1 item 4)")
    if cfg.data_parallel > 1 and not cfg.fused_training:
        out.append("data_parallel > 1 with fused_training=False: the "
                   "row-sharded general step (ROADMAP Queue 1 item 4)")
    for flag in ("calc_nll", "calc_prd", "calc_clf", "calc_coherence"):
        if getattr(cfg, flag, False):
            out.append(f"{flag}: the eval cadence (ROADMAP Queue 1 item 3)")
    return out


def check_supported(cfg, model) -> None:
    missing = unported_features(cfg, model)
    if missing:
        raise NotImplementedError(
            "not ported to multivae_tpu_torch yet: " + "; ".join(missing))


def epoch_generator(cfg, model_idx: int, epoch: int) -> torch.Generator:
    """The CPU generator of one member's epoch: a pure function of
    ``(cfg.seed, model_idx, epoch)``, so a resumed run replays the stream
    of the uninterrupted one."""
    seed = np.random.SeedSequence(
        [int(cfg.seed), int(model_idx), int(epoch)]).generate_state(
            1, dtype=np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) & (2 ** 63 - 1))


MASK_STREAM = 7  # the tag of the dropout masks' stream


def mask_generator(cfg, model_idx: int, epoch: int) -> torch.Generator:
    """The CPU generator of one member's epoch of dropout masks: a pure
    function of ``(cfg.seed, model_idx, epoch)`` and a fixed tag, apart
    from the noise's stream."""
    seed = np.random.SeedSequence(
        [int(cfg.seed), int(model_idx), int(epoch),
         MASK_STREAM]).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) & (2 ** 63 - 1))


def draw_masks(generator: torch.Generator, shapes, rate: float, device):
    """Pre-scaled dropout keep masks (values in ``{0, 1 / (1 - rate)}``),
    one ``[n_masks, rows, hidden]`` block per entry of ``shapes`` in order
    (``None`` where ``n_masks`` is 0), drawn on the CPU and copied to
    ``device`` once."""
    keep = 1.0 - float(rate)
    flat = [(torch.rand(n * r * h, generator=generator) < keep).float()
            / keep for n, r, h in shapes if n]
    if not flat:
        return [None] * len(shapes)
    buf = torch.cat(flat).to(device)
    out, off = [], 0
    for n, r, h in shapes:
        out.append(buf[off:off + n * r * h].view(n, r, h) if n else None)
        off += n * r * h
    return out


def draw_noise(generator: torch.Generator, shapes, device):
    """One standard-normal draw per ``(rows, width)`` in order, drawn on the
    CPU and copied to ``device`` once; returns the per-draw views."""
    flat = [torch.randn(r * w, generator=generator) for r, w in shapes]
    if not flat:
        return []
    buf = torch.cat(flat).to(device)
    out, off = [], 0
    for r, w in shapes:
        out.append(buf[off:off + r * w].view(r, w))
        off += r * w
    return out


def canonical_group_order(keys, mod_names, batch_size):
    """The complete-modality full-size group first, then the other
    ``(presence pattern, rows)`` keys sorted (``trainer.py:75-85``)."""
    full = (tuple(sorted(mod_names)), batch_size)
    ordered = [full] if full in keys else []
    return ordered + sorted(k for k in keys if k != full)


def make_group_fused_epoch(cfg, model, key):
    """The kernel epoch of the batches of one ``(presence pattern, rows)``
    group (``trainer.py:41-72, 885-895``): complete batches, full or
    partial, take the MoPoE step kernel for ``joint_elbo`` without dropout
    and the method step kernel otherwise; single-present batches the
    presence kernel. Returns ``fn(params, opt, xs, noise, masks) -> (opt,
    metrics [n, k], metric names)`` with ``xs = {mod: [n, B, d]}``,
    ``noise [n, B, w]``, ``masks [n, n_masks, B, hidden]`` or None;
    ``params`` and the moments are updated in place. A group the JAX
    package routes to a kernel the port does not have raises."""
    mods, rows = key
    mod_names = [m.name for m in model.modalities]
    dims = dims_from(cfg, rows)
    consts = fused_step.consts_from(cfg)
    hyper = adam_hyper(cfg)
    learn_scale = bool(cfg.learn_output_scale)
    method = cfg.method
    example = {m: None for m in mods}
    if len(mods) == len(mod_names):
        if not fused_methods.supports_method_fused(cfg, model, example):
            check_supported(cfg, model)
            raise NotImplementedError(f"no kernel for the group {key}")
        names = fused_methods.method_metric_names(model, method)
        mopoe = fused_step.supports_fused(cfg, model, example)

        def complete(p, opt, xs, noise, masks=None):
            x1s, x2s = xs[mod_names[0]], xs[mod_names[1]]
            if mopoe:
                metrics = fused_step.epoch_flat(
                    p, opt.mu, opt.nu, opt.count, x1s, x2s, noise, dims,
                    consts, hyper, learn_scale)
            else:
                metrics = fused_methods.method_epoch_flat(
                    method, p, opt.mu, opt.nu, opt.count, x1s, x2s, noise,
                    dims, consts, hyper, learn_scale, masks)
            return (AdamState(opt.count + len(noise), opt.mu, opt.nu),
                    metrics, names)
        return complete
    if not fused_presence.supports_presence_fused(cfg, model, example):
        check_supported(cfg, model)
        raise NotImplementedError(f"no kernel for the group {key}")
    mod_idx = mod_names.index(mods[0])
    names = fused_presence.presence_metric_names(model, method, mod_idx)

    def presence(p, opt, xs, noise, masks=None):
        metrics = fused_presence.presence_epoch_flat(
            p, opt.mu, opt.nu, opt.count, xs[mods[0]], noise, dims, consts,
            hyper, learn_scale, mod_idx, method, masks)
        return (AdamState(opt.count + len(noise), opt.mu, opt.nu), metrics,
                names)
    return presence


def make_generic_epoch(cfg, model):
    """The kernel epoch of the full complete batches of an architecture
    outside the split layout (``trainer.py:896-899``): the layer-stack step
    (``ops/fused_generic.py``), or None when the config is the split
    layout's or outside that step's envelope. Same contract as
    :func:`make_group_fused_epoch`'s functions; the metric rows are in the
    TPU kernel's order."""
    example = {m.name: None for m in model.modalities}
    if (fused_step.split_layout_ok(cfg, model)
            or not fused_generic.supports_generic_fused(cfg, model, example)):
        return None
    mod_names = [m.name for m in model.modalities]
    dims = dims_from(cfg, cfg.batch_size)
    consts = fused_step.consts_from(cfg)
    hyper = adam_hyper(cfg)
    learn_scale = bool(cfg.learn_output_scale)
    method = cfg.method
    names = fused_generic.generic_metric_names(model, method)
    order = fused_generic.metric_permutation(model, method)

    def generic(p, opt, xs, noise, masks=None):
        metrics = fused_generic.generic_epoch_flat(
            method, p, opt.mu, opt.nu, opt.count, xs[mod_names[0]],
            xs[mod_names[1]], noise, dims, consts, hyper, learn_scale, masks,
            order)
        return (AdamState(opt.count + len(noise), opt.mu, opt.nu), metrics,
                names)
    return generic


def _rows(data) -> int:
    return len(next(iter(data.values())))


def _stack(batches, mod, device):
    return torch.from_numpy(np.stack([b[mod] for b in batches])).to(device)


def _member_dataset(exp, model_idx, split: str):
    ds = exp.dataset_train if split == "train" else exp.dataset_test
    return ds[model_idx] if exp.cfg.num_models > 1 else ds


class _Logs:
    """Per-step metric rows of an epoch, fetched from the device once."""

    def __init__(self):
        self.blocks = []  # (names, [n, k] tensor, rows of it to log)

    def add(self, names, metrics, rows):
        self.blocks.append((tuple(names), metrics, list(rows)))

    def write(self, logger: Optional[MetricLogger], phase: str) -> None:
        if logger is None or not self.blocks:
            return
        flat = torch.cat([m.reshape(-1).float() for _, m, _ in
                          self.blocks]).cpu().numpy()
        off = 0
        write = (logger.write_training_logs if phase == "train"
                 else logger.write_testing_logs)
        for names, metrics, rows in self.blocks:
            n, k = metrics.shape
            block = flat[off:off + n * k].reshape(n, k)
            off += n * k
            for j in rows:
                # jitted JAX steps return their metric dicts key-sorted
                write(dict(sorted(zip(names, block[j]))))


def make_dp_epoch(cfg, model, device):
    """The data-parallel epoch of the full complete batches for
    ``cfg.data_parallel > 1`` (``trainer.py:900-908``) over a data mesh that
    starts at ``device``, or None for ``data_parallel == 1``. A
    ``batch_size`` the shards do not divide raises."""
    n = int(cfg.data_parallel)
    if n <= 1:
        return None
    if cfg.batch_size % n:
        raise ValueError(
            f"batch_size={cfg.batch_size} is not a multiple of "
            f"data_parallel={n}: every shard takes batch_size / "
            f"data_parallel rows of a full batch")
    example = {m.name: None for m in model.modalities}
    if not fused_methods.supports_method_fused(cfg, model, example):
        check_supported(cfg, model)
        raise NotImplementedError("no data-parallel kernel for this config")
    return fused_sharded.make_fused_dp_epoch(
        cfg, model, data_mesh(n, spread(device, n)))


def train_one_epoch(exp, model_idx: int, logger: Optional[MetricLogger],
                    generator: torch.Generator, epoch: int = 0,
                    log_every: int = 1, dp_epoch=None) -> int:
    """One epoch of one member; returns the number of steps. ``dp_epoch``
    (:func:`make_dp_epoch`) takes the full complete batches when given."""
    n_steps, logs = enqueue_train_epoch(exp, model_idx, generator, epoch,
                                        log_every, dp_epoch)
    logs.write(logger, "train")
    return n_steps


def enqueue_train_epoch(exp, model_idx: int, generator: torch.Generator,
                        epoch: int = 0, log_every: int = 1, dp_epoch=None):
    """Launch one epoch of one member on its device's current stream
    without fetching anything; returns ``(number of steps, the epoch's
    logs)``, the logs still on the device."""
    cfg = exp.cfg
    model = exp.models[model_idx]
    device = exp.params[model_idx].device
    dataset = _member_dataset(exp, model_idx, "train")
    sub_indices = dataset.indices if cfg.num_models > 1 else None
    sampler = MissingModalitySampler(dataset, batch_size=cfg.batch_size,
                                     indices=sub_indices,
                                     seed=cfg.seed + epoch)
    mod_names = [m.name for m in model.modalities]
    fused = bool(cfg.fused_training)
    full, general = [], []
    for idxs in sampler:
        data, _, _ = dataset.gather(idxs)
        if (len(idxs) == cfg.batch_size
                and all(m in data for m in mod_names)):
            full.append(data)
        else:
            general.append(data)
    shapes = [(_rows(d), batch_noise_width(cfg, model, d))
              for d in full + general]
    noise = draw_noise(generator, shapes, device)
    noise_full, noise_general = noise[:len(full)], noise[len(full):]
    masks = [None] * len(shapes)
    if cfg.dropout_rate > 0.0:
        masks = draw_masks(
            mask_generator(cfg, model_idx, epoch),
            [(general_mask_count(cfg, d), _rows(d), cfg.hidden_dim)
             for d in full + general],
            cfg.dropout_rate, device)
    masks_full, masks_general = masks[:len(full)], masks[len(full):]

    p = exp.params[model_idx]
    opt: AdamState = exp.opt_states[model_idx]
    hyper = adam_hyper(cfg)
    logs = _Logs()
    n_steps = 0

    # outside the split layout only the full complete batches have a kernel
    generic_epoch = make_generic_epoch(cfg, model) if fused else None

    def run_general(data, eps, batch_masks, log: bool):
        # autograd of the model, then flat Adam: fused_training=False, and
        # the batches of a deep architecture that are not full and complete
        nonlocal opt, n_steps
        tdata = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
        opt, _, metrics = general_step(cfg, model, p, opt, tdata, eps,
                                       dims_from(cfg, _rows(data)), hyper,
                                       batch_masks)
        n_steps += 1
        if log:
            names = list(metrics)
            logs.add(names, torch.stack([metrics[k] for k in names])[None],
                     [0])

    def run_group(key, batches, batch_noise, batch_masks, rows_to_log,
                  epoch_fn=None):
        # one kernel epoch over the group's batches
        nonlocal opt, n_steps
        epoch_fn = epoch_fn or make_group_fused_epoch(cfg, model, key)
        xs = {m: _stack(batches, m, device) for m in key[0]}
        opt, metrics, names = epoch_fn(
            p, opt, xs, torch.stack(batch_noise),
            None if batch_masks[0] is None else torch.stack(batch_masks))
        n_steps += len(batches)
        logs.add(names, metrics, rows_to_log)

    if fused and full:
        run_group((tuple(sorted(mod_names)), cfg.batch_size), full,
                  noise_full, masks_full, range(0, len(full), log_every),
                  dp_epoch or generic_epoch)
    elif not fused:
        for j, data in enumerate(full):
            run_general(data, noise_full[j], masks_full[j],
                        j % log_every == 0)

    groups: Dict = {}
    for i, data in enumerate(general):
        groups.setdefault((tuple(sorted(data)), _rows(data)), []).append(i)
    for key in canonical_group_order(groups, mod_names, cfg.batch_size):
        idx = groups[key]
        if fused and generic_epoch is None:
            run_group(key, [general[i] for i in idx],
                      [noise_general[i] for i in idx],
                      [masks_general[i] for i in idx],
                      [j for j, i in enumerate(idx) if i % log_every == 0])
        else:
            for i in idx:
                run_general(general[i], noise_general[i], masks_general[i],
                            i % log_every == 0)

    exp.opt_states[model_idx] = opt
    load_flat_params(model, p, dims_from(cfg, cfg.batch_size))
    return n_steps, logs


def test_batches(exp, model_idx: int, epoch: int):
    """The test pass's batches in evaluation order (``trainer.py:347-411``):
    full complete batches first, then the rest grouped by sorted
    ``(presence pattern, rows)``; each as ``(data, noise draw index)``
    with the draws numbered in emission order."""
    cfg = exp.cfg
    dataset = _member_dataset(exp, model_idx, "test")
    mod_names = exp.mod_names
    scannable, others = [], []
    for idxs in simple_batches(len(dataset), cfg.batch_size,
                               np.random.default_rng(cfg.seed + epoch)):
        data, _, _ = dataset.gather(idxs)
        if not data:
            continue
        if len(idxs) == cfg.batch_size and all(m in data for m in mod_names):
            scannable.append(data)
        else:
            others.append(data)
    order = [(d, i) for i, d in enumerate(scannable)]
    groups: Dict = {}
    for i, data in enumerate(others):
        groups.setdefault((tuple(sorted(data)), _rows(data)), []).append(i)
    for key in sorted(groups):
        order += [(others[i], len(scannable) + i) for i in groups[key]]
    return order, scannable + others


@torch.no_grad()
def test_one_epoch(exp, model_idx: int, logger: Optional[MetricLogger],
                   generator: torch.Generator, epoch: int):
    """Evaluate the member on its test split; returns the per-batch metric
    dicts (device tensors) in evaluation order."""
    cfg = exp.cfg
    model = exp.models[model_idx]
    device = next(model.parameters()).device
    order, emitted = test_batches(exp, model_idx, epoch)
    noise = draw_noise(generator,
                       [(_rows(d), batch_noise_width(cfg, model, d))
                        for d in emitted], device)
    logs, results = _Logs(), []
    for data, i in order:
        tdata = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
        _, metrics = eval_step(cfg, model, tdata, noise[i])
        results.append(metrics)
        names = list(metrics)
        logs.add(names, torch.stack([metrics[k] for k in names])[None], [0])
    logs.write(logger, "test")
    return results


def resume_from_checkpoints(exp) -> int:
    """Restore every member's model, params and Adam state from its latest
    checkpoint; returns (and sets) the epoch to resume from."""
    from .checkpoint import find_checkpoint, restore_checkpoint, \
        restore_opt_state

    cfg = exp.cfg
    dims = dims_from(cfg, cfg.batch_size)
    latest = 0
    for model_idx in range(cfg.num_models):
        model = exp.models[model_idx]
        path, epoch = find_checkpoint(cfg.dir_checkpoints, model_idx,
                                      cfg.num_models, None, cfg.model_save)
        restore_checkpoint(path, model)
        exp.params[model_idx] = model_flat_params(model, dims)
        restored = restore_opt_state(os.path.dirname(path), dims,
                                     model.mod_names, exp.device)
        if restored is not None:
            exp.opt_states[model_idx] = restored
        latest = max(latest, epoch + 1)
    cfg.start_epoch = latest
    return latest


def resolve_ensemble(cfg, model) -> bool:
    """Whether the members train through :func:`run_epochs_ensemble`
    (``trainer.py:199-228``). ``cfg.ensemble_parallel`` is True, False or
    ``"auto"``: auto takes the ensemble runner when the members can spread
    over the visible cards (:func:`ensemble_mesh`) and otherwise only when
    the sequential loop would not run the step kernels anyway."""
    if cfg.num_models <= 1:
        return False
    if getattr(cfg, "tensor_parallel", 1) > 1:
        return False
    if cfg.ensemble_parallel is True:
        return True
    if cfg.ensemble_parallel is False:
        return False
    if ensemble_mesh(cfg) is not None:
        return True
    if cfg.fused_training:
        example = {m.name: None for m in model.modalities}
        if (fused_step.supports_fused(cfg, model, example)
                or fused_methods.supports_method_fused(cfg, model, example)
                or fused_generic.supports_generic_fused(cfg, model,
                                                        example)):
            return False
    return True


def ensemble_mesh(cfg):
    """The ``(model, data)`` mesh of an ensemble over the visible cards, or
    None with at most one card or a card count the members do not divide
    (``trainer.py:231-238``)."""
    n_dev = len(visible_cards())
    if n_dev <= 1 or n_dev % cfg.num_models != 0:
        return None
    return make_mesh(n_model=cfg.num_models,
                     n_data=n_dev // cfg.num_models)


def _checkpoint_member(exp, model_idx: int, epoch: int) -> None:
    cfg = exp.cfg
    ckpt_dir = model_checkpoint_dir(cfg, model_idx, epoch)
    opt = (exp.opt_states[model_idx]
           if cfg.save_optimizer != "none" else None)
    save_checkpoint(ckpt_dir, exp.models[model_idx], opt, cfg.model_save,
                    dims=dims_from(cfg, cfg.batch_size))
    save_networks(os.path.dirname(ckpt_dir)
                  if cfg.num_models > 1 else cfg.dir_checkpoints,
                  exp.models[model_idx])


def run_epochs_ensemble(exp, use_tensorboard: bool = True,
                        log_every: int = 1, progress: bool = True):
    """Ensemble runner (``trainer.py:1011-1105``): epochs outermost, the
    members inside. Member ``m`` lives on entry ``m`` of the mesh's model
    axis (the visible cards when the members divide them, else all on the
    experiment's device) and works on a CUDA stream of its own: every
    member's training epoch is launched first, then each member's logs are
    fetched and its test pass runs. A member's epoch is
    :func:`enqueue_train_epoch`, the sequential loop's, with the member's
    own noise and mask generators, so params, moments, logs and checkpoints
    are the sequential run's, bit for bit. Returns the host-clock seconds
    per epoch (all members; train, test, logging, ending in a device
    synchronize)."""
    cfg = exp.cfg
    n_models = cfg.num_models
    mesh = ensemble_mesh(cfg) if exp.device.type == "cuda" else None
    if mesh is None:
        mesh = make_mesh(n_models, 1, spread(exp.device, 1) * n_models)
    members = fused_sharded.MemberStreams(mesh)
    for m, dev in enumerate(members.devices):
        if exp.params[m].device != dev:
            exp.models[m].to(dev)
            opt = exp.opt_states[m]
            exp.params[m] = exp.params[m].to(dev)
            exp.opt_states[m] = AdamState(opt.count, opt.mu.to(dev),
                                          opt.nu.to(dev))
    dp_epochs = [make_dp_epoch(cfg, exp.models[m], dev)
                 for m, dev in enumerate(members.devices)]
    loggers = [MetricLogger(model_log_dir(cfg, m),
                            use_tensorboard=use_tensorboard)
               for m in range(n_models)]
    for logger in loggers:
        logger.add_text("FLAGS", cfg.describe())
    print(f"training epochs progress (ensemble of {n_models}, mesh "
          f"{[str(d) for d in members.devices]}):")
    walls: List[float] = []
    t0 = time.time()
    for epoch in range(cfg.start_epoch, cfg.end_epoch):
        start = time.perf_counter()
        generators = [epoch_generator(cfg, m, epoch)
                      for m in range(n_models)]
        pending = []
        for m in range(n_models):
            with members.member(m):
                pending.append(enqueue_train_epoch(
                    exp, m, generators[m], epoch, log_every, dp_epochs[m]))
        for m in range(n_models):
            with members.member(m):
                # the fetches synchronize the member's stream
                pending[m][1].write(loggers[m], "train")
                test_one_epoch(exp, m, loggers[m], generators[m], epoch)
                if (epoch + 1) % 5 == 0 or (epoch + 1) == cfg.end_epoch:
                    _checkpoint_member(exp, m, epoch)
        members.join()
        if exp.device.type == "cuda":
            for dev in dict.fromkeys(members.devices):
                torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - start)
        if progress:
            frac = (epoch + 1 - cfg.start_epoch) / max(
                cfg.end_epoch - cfg.start_epoch, 1)
            print(f"\r  ensemble: epoch {epoch + 1}/{cfg.end_epoch} "
                  f"({100 * frac:.1f}%) [{time.time() - t0:.1f}s]", end="",
                  flush=True)
    if progress:
        print()
    for logger in loggers:
        logger.close()
    return walls


def run_epochs(exp, use_tensorboard: bool = True, log_every: int = 1,
               progress: bool = True):
    """Train every ensemble member (``run_epochs``, per-epoch loop): in
    turn, or through :func:`run_epochs_ensemble` when
    :func:`resolve_ensemble` says so. Returns member 0's host-clock seconds
    per epoch (train, test, logging, ending in a device synchronize)."""
    cfg = exp.cfg
    check_supported(cfg, exp.models[0])
    if cfg.load_saved:
        resume_from_checkpoints(exp)
    cfg.save(os.path.join(cfg.dir_experiment_run, "flags.json"))
    if resolve_ensemble(cfg, exp.models[0]):
        return run_epochs_ensemble(exp, use_tensorboard=use_tensorboard,
                                   log_every=log_every, progress=progress)
    dp_epoch = make_dp_epoch(cfg, exp.models[0], exp.device)
    sync = (torch.cuda.synchronize if exp.device.type == "cuda"
            else (lambda: None))
    walls: List[float] = []
    print("training epochs progress:")
    for model_idx in range(cfg.num_models):
        logger = MetricLogger(model_log_dir(cfg, model_idx),
                              use_tensorboard=use_tensorboard)
        logger.add_text("FLAGS", cfg.describe())
        t0 = time.time()
        for epoch in range(cfg.start_epoch, cfg.end_epoch):
            start = time.perf_counter()
            generator = epoch_generator(cfg, model_idx, epoch)
            train_one_epoch(exp, model_idx, logger, generator, epoch,
                            log_every, dp_epoch)
            test_one_epoch(exp, model_idx, logger, generator, epoch)
            sync()
            if model_idx == 0:
                walls.append(time.perf_counter() - start)
            if (epoch + 1) % 5 == 0 or (epoch + 1) == cfg.end_epoch:
                _checkpoint_member(exp, model_idx, epoch)
            if progress:
                frac = (epoch + 1 - cfg.start_epoch) / max(
                    cfg.end_epoch - cfg.start_epoch, 1)
                print(f"\r  model {model_idx}: epoch {epoch + 1}/"
                      f"{cfg.end_epoch} ({100 * frac:.1f}%) "
                      f"[{time.time() - t0:.1f}s]", end="", flush=True)
        if progress:
            print()
        logger.close()
    return walls
