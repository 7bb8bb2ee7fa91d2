"""Epoch runner: the per-epoch driver of ``multivae_tpu/train/trainer.py``.

Per member and epoch (``trainer.py:88-196, 347-414, 817-1008``):

* the :class:`~multivae_tpu_torch.data.MissingModalitySampler` (seeded
  ``cfg.seed + epoch``) emits subset-homogeneous batches; the full-size
  complete batches run first, in sampler order, then the remaining batches
  grouped by ``(presence pattern, rows)`` in :func:`canonical_group_order`.
  Which step takes each group, and in which precision, is read from the
  member's :class:`~.routes.Routes`, built once per run; :mod:`.routes`
  states the rules. A kernel group is one epoch call (on a card ONE launch
  of a persistent kernel with Adam inside); on a general step each batch
  is one step of autograd and Adam;
* the batches come from each member's splits kept scaled on its device
  (:class:`~multivae_tpu_torch.train.device_cohort.DeviceCohort`, built at
  first use): the sampler runs on the host as before, and a batch is an
  ``index_select`` on the device, bit for bit what
  ``MultimodalDataset.gather`` gives, one copy of row indices an epoch;
* the test split is evaluated with the general forward and
  :func:`~multivae_tpu_torch.train.losses.total_loss`; on a card each
  batch replays a CUDA graph of that forward, one per ``(member, presence
  pattern, rows)`` (:class:`EvalGraph`);
* every 5 epochs and at the end the model and optimizer state are
  checkpointed in the JAX package's layout: fetched and encoded on the
  training thread, written by the checkpoint writer's thread while the
  next epochs run (:data:`~.checkpoint.WRITER`);
* on the eval cadence (:func:`run_eval_cadence`, ``trainer.py:412-508``
  there) the IWAE likelihoods, PRD, latent probes and coherence of
  :mod:`multivae_tpu_torch.eval` are logged after the test pass.

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
pass takes no mask. The metrics are fetched once for each pass. The
chunked drivers are not ported: ``epoch_chunk`` is accepted and the
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

import contextlib
import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import MissingModalitySampler, simple_batches
from ..ops import fused_methods, fused_presence, fused_sharded, fused_step
from ..ops.adam import AdamState, adam_hyper
from ..ops.bf16 import cfg_bf16
from ..parallel import make_mesh, spread, visible_cards
from ..parallel.tensor import tp_step
from ..params import dims_from, load_flat_params, model_flat_params
from ..utils.filehandling import model_checkpoint_dir, model_log_dir
from . import checkpoint, profiling
from .device_cohort import DeviceCohort
from .logging import MetricLogger
from .routes import MOPOE, PRESENCE, Routes, check_supported, group_kernel
from .train_step import (
    batch_noise_width,
    dp_general_step,
    eval_step,
    general_mask_count,
    general_step,
)


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


@profiling.spanned("trainer.noise")
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
    buf = profiling.to_device(torch.cat(flat), device)
    out, off = [], 0
    for n, r, h in shapes:
        out.append(buf[off:off + n * r * h].view(n, r, h) if n else None)
        off += n * r * h
    return out


@profiling.spanned("trainer.noise")
def draw_noise(generator: torch.Generator, shapes, device):
    """One standard-normal draw per ``(rows, width)`` in order, drawn on the
    CPU and copied to ``device`` once; returns the per-draw views."""
    flat = [torch.randn(r * w, generator=generator) for r, w in shapes]
    if not flat:
        return []
    buf = profiling.to_device(torch.cat(flat), device)
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
    group on the step :func:`~.routes.group_kernel` names, in ``cfg``'s
    precision. Returns ``fn(params, opt, xs, noise, masks) -> (opt, metrics
    [n, k], metric names)`` with ``xs = {mod: [n, B, d]}``, ``noise [n, B,
    w]``, ``masks [n, n_masks, B, hidden]`` or None; ``params`` and the
    moments are updated in place."""
    mods, rows = key
    kernel = group_kernel(cfg, model, key)
    bf16 = cfg_bf16(cfg)
    mod_names = [m.name for m in model.modalities]
    dims = dims_from(cfg, rows)
    consts = fused_step.consts_from(cfg)
    hyper = adam_hyper(cfg)
    learn_scale = bool(cfg.learn_output_scale)
    method = cfg.method
    if kernel == PRESENCE:
        mod_idx = mod_names.index(mods[0])
        names = fused_presence.presence_metric_names(model, method, mod_idx)
    else:
        names = fused_methods.method_metric_names(model, method)

    def epoch(p, opt, xs, noise, masks=None):
        state = (p, opt.mu, opt.nu, opt.count)
        if kernel == PRESENCE:
            metrics = fused_presence.presence_epoch_flat(
                *state, xs[mods[0]], noise, dims, consts, hyper, learn_scale,
                mod_idx, method, masks, bf16=bf16)
        elif kernel == MOPOE:
            metrics = fused_step.epoch_flat(
                *state, xs[mod_names[0]], xs[mod_names[1]], noise, dims,
                consts, hyper, learn_scale, bf16=bf16)
        else:
            metrics = fused_methods.method_epoch_flat(
                method, *state, xs[mod_names[0]], xs[mod_names[1]], noise,
                dims, consts, hyper, learn_scale, masks, bf16=bf16)
        return (AdamState(opt.count + len(noise), opt.mu, opt.nu), metrics,
                names)
    return epoch


def _rows(data) -> int:
    return len(next(iter(data.values())))


def _stack(batches, mod):
    """The batches' ``mod`` tensors as one ``[n, rows, d]`` tensor: the
    block they are consecutive slabs of, as :func:`gather_batches` gives a
    group's batches, without a copy; else a stack of them."""
    parts = [b[mod] for b in batches]
    first = parts[0]
    storage = first.untyped_storage().data_ptr()
    step = first.numel() * first.element_size()
    if all(p.is_contiguous() and p.shape == first.shape
           and p.untyped_storage().data_ptr() == storage
           and p.data_ptr() == first.data_ptr() + j * step
           for j, p in enumerate(parts)):
        return first.as_strided((len(parts),) + tuple(first.shape),
                                (first.numel(),) + first.stride(),
                                first.storage_offset())
    return torch.stack(parts)


def _member_dataset(exp, model_idx, split: str):
    ds = exp.dataset_train if split == "train" else exp.dataset_test
    return ds[model_idx] if exp.cfg.num_models > 1 else ds


def device_cohort(exp, model_idx: int, split: str) -> DeviceCohort:
    """The member's ``split`` (``"train"`` or ``"test"``) on its model's
    device: built at first use and kept on ``exp`` (``set_datasets`` drops
    it), built again where the model moved to another device."""
    device = next(exp.models[model_idx].parameters()).device
    cohort = exp.device_cohorts.get((model_idx, split))
    if cohort is None or cohort.device != device:
        cohort = exp.device_cohorts[(model_idx, split)] = DeviceCohort(
            _member_dataset(exp, model_idx, split), device)
    return cohort


@profiling.spanned("trainer.gather")
def gather_batches(cohort: DeviceCohort, batches):
    """Each batch ``(indices, modalities)`` as ``{modality: [rows, d]}``
    on the cohort's device, in order: the batches of one ``(modalities,
    rows)`` group are consecutive slabs of the group's ``[n, rows, d]``
    gather (:meth:`DeviceCohort.gather_groups`, one index copy for all)."""
    groups: Dict = {}
    for i, (idxs, mods) in enumerate(batches):
        groups.setdefault((mods, len(idxs)), []).append(i)
    stacks = cohort.gather_groups([(mods, [batches[i][0] for i in members])
                                   for (mods, _), members in groups.items()])
    out = [None] * len(batches)
    for members, stack in zip(groups.values(), stacks):
        for j, i in enumerate(members):
            out[i] = {m: t[j] for m, t in stack.items()}
    return out


class _Logs:
    """Per-step metric rows of an epoch, fetched from the device once."""

    def __init__(self):
        self.blocks = []  # (names, [n, k] tensor, rows of it to log)

    def add(self, names, metrics, rows):
        self.blocks.append((tuple(names), metrics, list(rows)))

    def write(self, logger: Optional[MetricLogger], phase: str) -> None:
        if logger is None or not self.blocks:
            return
        flat = profiling.fetch(torch.cat([m.reshape(-1).float() for _, m, _
                                          in self.blocks]),
                               "trainer.fetch").numpy()
        off = 0
        write = (logger.write_training_logs if phase == "train"
                 else logger.write_testing_logs)
        with profiling.span("trainer.log_rows"):
            for names, metrics, rows in self.blocks:
                n, k = metrics.shape
                block = flat[off:off + n * k].reshape(n, k)
                off += n * k
                for j in rows:
                    # jitted JAX steps return their metric dicts key-sorted
                    write(dict(sorted(zip(names, block[j]))))


def train_one_epoch(exp, model_idx: int, logger: Optional[MetricLogger],
                    generator: torch.Generator, epoch: int = 0,
                    log_every: int = 1, routes: Optional[Routes] = None
                    ) -> int:
    """One epoch of one member on its ``routes`` (built here when not
    given); returns the number of steps."""
    n_steps, logs = enqueue_train_epoch(exp, model_idx, generator, epoch,
                                        log_every, routes)
    logs.write(logger, "train")
    return n_steps


@profiling.spanned("trainer.batches")
def epoch_batches(exp, model_idx: int, epoch: int):
    """One member's training batches of an epoch in sampler order, as
    ``(full complete batches, the others)``, each ``{modality: [rows,
    d]}`` on the member's device (:func:`gather_batches`)."""
    cfg = exp.cfg
    cohort = device_cohort(exp, model_idx, "train")
    dataset = cohort.dataset
    sub_indices = dataset.indices if cfg.num_models > 1 else None
    sampler = MissingModalitySampler(dataset, batch_size=cfg.batch_size,
                                     indices=sub_indices,
                                     seed=cfg.seed + epoch)
    mod_names = exp.models[model_idx].mod_names
    full, general = [], []
    for idxs in sampler:
        mods = cohort.modalities_of(idxs)
        if (len(idxs) == cfg.batch_size
                and all(m in mods for m in mod_names)):
            full.append((idxs, mods))
        else:
            general.append((idxs, mods))
    data = gather_batches(cohort, full + general)
    return data[:len(full)], data[len(full):]


@profiling.spanned("trainer.steps")
def enqueue_train_epoch(exp, model_idx: int, generator: torch.Generator,
                        epoch: int = 0, log_every: int = 1,
                        routes: Optional[Routes] = None, batches=None,
                        bf16_full=None):
    """Launch one epoch of one member on its device's current stream
    without fetching anything; returns ``(number of steps, the epoch's
    logs)``, the logs still on the device. ``routes``: the member's
    :class:`~.routes.Routes`, built here when not given. ``batches``: the
    epoch's :func:`epoch_batches`, if already drawn. ``bf16_full``: the
    ensemble runner's count of full complete batches that may take the
    bfloat16 branch (:meth:`~.routes.Routes.full_parts`)."""
    cfg = exp.cfg
    model = exp.models[model_idx]
    device = exp.params[model_idx].device
    routes = routes or Routes(cfg, model, device)
    mod_names = [m.name for m in model.modalities]
    full, general = batches or epoch_batches(exp, model_idx, epoch)
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

    @profiling.spanned("trainer.launch")
    def run_general(mesh, data, eps, batch_masks, log: bool):
        # autograd of the model, then flat Adam, over the step's mesh
        nonlocal opt, n_steps
        args = (p, opt, data, eps, dims_from(cfg, _rows(data)), hyper)
        with profiling.span("trainer.general_step"):
            if mesh is None:
                opt, _, metrics = general_step(cfg, model, *args,
                                               batch_masks)
            elif "tensor" in mesh.shape:
                opt, _, metrics = tp_step(cfg, model, *args, mesh,
                                          batch_masks)
            else:
                opt, _, metrics = dp_general_step(cfg, routes.replicas,
                                                  *args, mesh, batch_masks)
        profiling.count("trainer.general_steps", 1)
        n_steps += 1
        if log:
            names = list(metrics)
            logs.add(names, torch.stack([metrics[k] for k in names])[None],
                     [0])

    @profiling.spanned("trainer.launch")
    def run_group(epoch_fn, batches, batch_noise, batch_masks, log):
        # one kernel epoch over the group's batches
        nonlocal opt, n_steps
        xs = {m: _stack(batches, m) for m in batches[0]}
        opt, metrics, names = epoch_fn(
            p, opt, xs, torch.stack(batch_noise),
            None if batch_masks[0] is None else torch.stack(batch_masks))
        n_steps += len(batches)
        logs.add(names, metrics, [j for j, on in enumerate(log) if on])

    def run(step, batches, batch_noise, batch_masks, log):
        # the batches on ``step``; ``log[j]``: whether the j-th is logged
        if step.epoch is None:
            for args in zip(batches, batch_noise, batch_masks, log):
                run_general(step.mesh, *args)
        else:
            run_group(step.epoch, batches, batch_noise, batch_masks, log)

    for lo, hi, step in routes.full_parts(len(full), bf16_full):
        run(step, full[lo:hi], noise_full[lo:hi], masks_full[lo:hi],
            [j % log_every == 0 for j in range(lo, hi)])
    groups: Dict = {}
    for i, data in enumerate(general):
        groups.setdefault((tuple(sorted(data)), _rows(data)), []).append(i)
    for key in canonical_group_order(groups, mod_names, cfg.batch_size):
        idx = groups[key]
        run(routes.group(key, bf16_full), [general[i] for i in idx],
            [noise_general[i] for i in idx],
            [masks_general[i] for i in idx],
            [i % log_every == 0 for i in idx])

    exp.opt_states[model_idx] = opt
    load_flat_params(model, p, dims_from(cfg, cfg.batch_size))
    return n_steps, logs


def test_batches(exp, model_idx: int, epoch: int):
    """The test pass's batches in evaluation order (``trainer.py:347-411``):
    full complete batches first, then the rest grouped by sorted
    ``(presence pattern, rows)``; each as ``(data, noise draw index)``
    with the draws numbered in emission order, ``data`` on the member's
    device (:func:`gather_batches`)."""
    cfg = exp.cfg
    cohort = device_cohort(exp, model_idx, "test")
    mod_names = exp.mod_names
    scannable, others = [], []
    for idxs in simple_batches(len(cohort.dataset), cfg.batch_size,
                               np.random.default_rng(cfg.seed + epoch)):
        mods = cohort.modalities_of(idxs)
        if not mods:
            continue
        if len(idxs) == cfg.batch_size and all(m in mods for m in mod_names):
            scannable.append((idxs, mods))
        else:
            others.append((idxs, mods))
    data = gather_batches(cohort, scannable + others)
    scannable, others = data[:len(scannable)], data[len(scannable):]
    order = [(d, i) for i, d in enumerate(scannable)]
    groups: Dict = {}
    for i, data in enumerate(others):
        groups.setdefault((tuple(sorted(data)), _rows(data)), []).append(i)
    for key in sorted(groups):
        order += [(others[i], len(scannable) + i) for i in groups[key]]
    return order, scannable + others


class EvalGraph:
    """:func:`eval_step` of one model at one ``(presence pattern, rows)``
    captured in a CUDA graph: its inputs (each modality's batch, the noise)
    are static buffers, and it reads the model's parameters in place
    (``load_flat_params`` copies into them), so one capture serves every
    epoch. Captured after PyTorch's side-stream warm-up, which also makes
    the forward's constants (``ops.fusion.device_constant``); counted as
    ``test_graph_captures``."""

    def __init__(self, cfg, model, data, noise):
        self.addresses = _param_addresses(model)
        self.inputs = {m: t.clone() for m, t in data.items()}
        self.noise = noise.clone()
        with torch.cuda.device(noise.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(3):
                    eval_step(cfg, model, self.inputs, self.noise)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                _, self.outputs = eval_step(cfg, model, self.inputs,
                                            self.noise)
        self.names = list(self.outputs)
        profiling.count("test_graph_captures", 1)

    def run(self, data, noise):
        """``(metric names, [k] metrics)`` of a batch: its data and noise
        copied in, a replay, and one stack of the outputs, which the next
        replay leaves alone."""
        for m, t in self.inputs.items():
            t.copy_(data[m])
        self.noise.copy_(noise)
        self.graph.replay()
        return self.names, torch.stack([self.outputs[k]
                                        for k in self.names])


def _param_addresses(model):
    """Where the model's parameters live: a captured graph reads there."""
    return tuple(p.data_ptr() for p in model.parameters())


def _test_forward(exp, model_idx: int, data, noise):
    """``(metric names, [k] metrics)`` of one test batch: on a card the
    replay of the member's :class:`EvalGraph` for the batch's ``(presence
    pattern, rows)`` (captured at its first use, again only if the
    parameters moved), on the CPU :func:`eval_step`."""
    cfg, model = exp.cfg, exp.models[model_idx]
    if noise.device.type != "cuda":
        _, metrics = eval_step(cfg, model, data, noise)
        names = list(metrics)
        return names, torch.stack([metrics[k] for k in names])
    key = (model_idx, tuple(data), _rows(data))
    graph = exp.test_graphs.get(key)
    if graph is None or graph.addresses != _param_addresses(model):
        graph = exp.test_graphs[key] = EvalGraph(cfg, model, data, noise)
    return graph.run(data, noise)


@torch.no_grad()
@profiling.spanned("trainer.test")
def test_one_epoch(exp, model_idx: int, logger: Optional[MetricLogger],
                   generator: torch.Generator, epoch: int):
    """Evaluate the member on its test split; returns the per-batch metric
    dicts (device tensors) in evaluation order. On a card each batch is a
    CUDA graph's replay (:func:`_test_forward`)."""
    cfg = exp.cfg
    model = exp.models[model_idx]
    device = next(model.parameters()).device
    order, emitted = test_batches(exp, model_idx, epoch)
    noise = draw_noise(generator,
                       [(_rows(d), batch_noise_width(cfg, model, d))
                        for d in emitted], device)
    logs, results = _Logs(), []
    for data, i in order:
        with profiling.span("trainer.test.forward"):
            names, metrics = _test_forward(exp, model_idx, data, noise[i])
            results.append(dict(zip(names, metrics)))
            logs.add(names, metrics[None], [0])
    logs.write(logger, "test")
    return results


# evals riding the eval_freq cadence; calc_prd rides eval_freq_fid. The one
# flag registry: eval_cadence_active, eval_breaks_after and run_eval_cadence
# all derive from it
_EVAL_FREQ_FLAGS = ("calc_nll", "calc_clf", "calc_coherence")


def _any_eval_freq_flag(cfg) -> bool:
    return any(getattr(cfg, f, False) for f in _EVAL_FREQ_FLAGS)


def eval_cadence_active(cfg) -> bool:
    """Any eval hooked onto the ``eval_freq`` / ``eval_freq_fid`` cadence?"""
    return bool(_any_eval_freq_flag(cfg) or cfg.calc_prd)


def eval_breaks_after(cfg, epoch_done: int) -> bool:
    """Must the host run eval code after ``epoch_done`` epochs?"""
    if _any_eval_freq_flag(cfg) and epoch_done % cfg.eval_freq == 0:
        return True
    return bool(cfg.calc_prd and epoch_done % cfg.eval_freq_fid == 0)


def run_eval_cadence(exp, model_idx: int, logger, epoch_done: int
                     ) -> Dict[str, float]:
    """The eval cadence of one member after ``epoch_done`` epochs
    (``trainer.py:441-508``): ``calc_nll`` (IWAE likelihoods),
    ``calc_clf`` (latent probes) and ``calc_coherence`` at multiples of
    ``eval_freq``, ``calc_prd`` at multiples of ``eval_freq_fid``, every
    family at the final epoch. PRD and coherence share one
    conditional-generation pass; the modality classifiers are fit once per
    member and cached on ``exp``. Returns the host-clock seconds of each
    part that ran (``Likelihoods``, ``cond_generation``, ``PRD``,
    ``Latent Representation``, ``Generation``), each ending in a fetch."""
    from ..eval import coherence, likelihood, representation, sample_quality

    cfg = exp.cfg
    final = epoch_done == cfg.end_epoch
    on_freq = final or epoch_done % cfg.eval_freq == 0
    on_fid = cfg.calc_prd and (final or epoch_done % cfg.eval_freq_fid == 0)
    seconds: Dict[str, float] = {}
    cond = []

    @contextlib.contextmanager
    def timed(part):
        start = time.perf_counter()
        yield
        seconds[part] = seconds.get(part, 0.0) + time.perf_counter() - start

    def cond_samples():
        if not cond:
            with timed("cond_generation"):
                cond.append(sample_quality.generate_conditional_samples(
                    exp, model_idx))
        return cond[0]

    if cfg.calc_nll and on_freq:
        with timed("Likelihoods"):
            lhoods = likelihood.estimate_likelihoods(exp, model_idx)
        if logger is not None:
            logger.write_lhood_logs(lhoods)
    if on_fid:
        samples = cond_samples()
        with timed("PRD"):
            prd = sample_quality.calc_prd_score(exp, model_idx,
                                                samples=samples)
        if logger is not None:
            logger.write_prd_scores(prd)
    if getattr(cfg, "calc_clf", False) and on_freq:
        with timed("Latent Representation"):
            clfs = representation.train_clf_lr_all_subsets(exp, model_idx)
            accs = representation.test_clf_lr_all_subsets(exp, clfs,
                                                          model_idx)
        if logger is not None and accs:
            logger.write_lr_eval(accs)
    if getattr(cfg, "calc_coherence", False) and on_freq:
        # fit on the train split, which does not change: once per member
        cache = getattr(exp, "_modality_clfs", None)
        if cache is None:
            cache = exp._modality_clfs = {}
        gen_eval = {}
        with timed("Generation"):
            if model_idx not in cache:
                cache[model_idx] = coherence.train_modality_classifiers(
                    exp, model_idx)
        if cache[model_idx] is not None:
            samples = cond_samples()
            with timed("Generation"):
                gen_eval = coherence.evaluate_coherence(
                    exp, model_idx, clfs=cache[model_idx], samples=samples)
        if logger is not None and gen_eval:
            logger.write_coherence_logs(gen_eval)
    return seconds


def resume_from_checkpoints(exp) -> int:
    """Restore every member's model, params and Adam state from its latest
    checkpoint (the port's or the JAX package's); returns (and sets) the
    epoch to resume from. Resuming a run the JAX package wrote warns once:
    its noise came from threefry streams, the rest of the run's comes from
    torch's (:func:`epoch_generator`)."""
    from .checkpoint import checkpoint_format, find_checkpoint, \
        restore_checkpoint, restore_opt_state

    cfg = exp.cfg
    dims = dims_from(cfg, cfg.batch_size)
    latest = 0
    formats = set()
    for model_idx in range(cfg.num_models):
        model = exp.models[model_idx]
        path, epoch = find_checkpoint(cfg.dir_checkpoints, model_idx,
                                      cfg.num_models, None, cfg.model_save)
        formats.add(checkpoint_format(path))
        restore_checkpoint(path, model)
        exp.params[model_idx] = model_flat_params(model, dims)
        restored = restore_opt_state(os.path.dirname(path), dims,
                                     model.mod_names, exp.device)
        if restored is not None:
            exp.opt_states[model_idx] = restored
        latest = max(latest, epoch + 1)
    if "msgpack" in formats:
        warnings.warn(
            f"resuming a run the JAX package wrote at epoch {latest}: its "
            f"noise came from JAX's threefry streams, the epochs from here "
            f"on draw torch's, so the run is not the one the JAX package "
            f"would have continued", stacklevel=2)
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
    return not Routes(cfg, model).kernel_config


def ensemble_mesh(cfg):
    """The ``(model, data)`` mesh of an ensemble over the visible cards, or
    None with at most one card or a card count the members do not divide
    (``trainer.py:231-238``)."""
    n_dev = len(visible_cards())
    if n_dev <= 1 or n_dev % cfg.num_models != 0:
        return None
    return make_mesh(n_model=cfg.num_models,
                     n_data=n_dev // cfg.num_models)


def _checkpoint_files(exp, model_idx: int, epoch: int):
    """Member ``model_idx``'s checkpoint of ``epoch`` and its network dumps
    (:func:`~.checkpoint.checkpoint_files`): the state fetched and encoded
    on this thread, as ``(path, bytes)``."""
    cfg = exp.cfg
    ckpt_dir = model_checkpoint_dir(cfg, model_idx, epoch)
    opt = (exp.opt_states[model_idx]
           if cfg.save_optimizer != "none" else None)
    return checkpoint.checkpoint_files(
        ckpt_dir, os.path.dirname(ckpt_dir) if cfg.num_models > 1
        else cfg.dir_checkpoints, exp.models[model_idx], opt,
        cfg.model_save, dims_from(cfg, cfg.batch_size))


@profiling.spanned("trainer.checkpoint")
def _checkpoint_member(exp, model_idx: int, epoch: int) -> None:
    """Checkpoint member ``model_idx`` at ``epoch``: fetch and encode its
    state here, then hand the files to the writer thread
    (:data:`~.checkpoint.WRITER`), waiting first for the previous
    checkpoint's files, not for these."""
    checkpoint.WRITER.submit(_checkpoint_files(exp, model_idx, epoch))


@contextlib.contextmanager
def _checkpoints_on_disk():
    """Wait for the writer thread when the block ends, by a return or a
    raise: every checkpoint the block submitted is then on disk, and the
    writer's error, if it had one, is raised."""
    try:
        yield
    finally:
        with profiling.span("trainer.checkpoint"):
            checkpoint.WRITER.wait()


def run_epochs_ensemble(exp, use_tensorboard: bool = True,
                        log_every: int = 1, progress: bool = True,
                        profile_dir: Optional[str] = None):
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
    synchronize); each member's eval cadence runs after it. A checkpoint
    is one writer job holding every member's files; the runner waits for
    the writer before it returns or raises, so every checkpoint is then on
    disk.

    Each member's routes are an ensemble member's
    (:class:`~.routes.Routes`, ``ensemble``: whether the members spread over
    the cards), which under ``precision="bfloat16"`` read the fewest full
    complete batches any member has this epoch. ``profile_dir``: the first
    epoch is traced (:mod:`.profiling`), every member's training and test
    pass."""
    cfg = exp.cfg
    n_models = cfg.num_models
    mesh = ensemble_mesh(cfg) if exp.device.type == "cuda" else None
    spread_members = mesh is not None
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
    member_routes = [Routes(cfg, exp.models[m], dev, spread_members)
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
    with _checkpoints_on_disk():
        for epoch in range(cfg.start_epoch, cfg.end_epoch):
            start = time.perf_counter()
            with _tracing(profile_dir, exp.device, epoch == cfg.start_epoch,
                          epoch):
                generators = [epoch_generator(cfg, m, epoch)
                              for m in range(n_models)]
                batches = [epoch_batches(exp, m, epoch)
                           for m in range(n_models)]
                n_common = min(len(full) for full, _ in batches)
                pending = []
                for m in range(n_models):
                    with members.member(m):
                        pending.append(enqueue_train_epoch(
                            exp, m, generators[m], epoch, log_every,
                            member_routes[m], batches[m], n_common))
                for m in range(n_models):
                    with members.member(m):
                        # the fetches synchronize the member's stream
                        pending[m][1].write(loggers[m], "train")
                        test_one_epoch(exp, m, loggers[m], generators[m],
                                       epoch)
                members.join()
                if exp.device.type == "cuda":
                    for dev in dict.fromkeys(members.devices):
                        torch.cuda.synchronize(dev)
            if (epoch + 1) % 5 == 0 or (epoch + 1) == cfg.end_epoch:
                # one writer job holds every member's files
                with profiling.span("trainer.checkpoint"):
                    files = []
                    for m in range(n_models):
                        with members.member(m):
                            files += _checkpoint_files(exp, m, epoch)
                    checkpoint.WRITER.submit(files)
            walls.append(time.perf_counter() - start)
            if (eval_cadence_active(cfg) and (eval_breaks_after(cfg, epoch + 1)
                                              or epoch + 1 == cfg.end_epoch)):
                for m in range(n_models):
                    with members.member(m):
                        run_eval_cadence(exp, m, loggers[m], epoch + 1)
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


def _tracing(profile_dir, device, first: bool, epoch: int):
    """The trace of an epoch (:mod:`.profiling`) where ``profile_dir`` is
    set and the epoch is the first trained one, else a null context."""
    if profile_dir is None or not first:
        return contextlib.nullcontext()
    return profiling.trace(profile_dir, device, epoch)


def run_epochs(exp, use_tensorboard: bool = True, log_every: int = 1,
               progress: bool = True, profile_dir: Optional[str] = None):
    """Train every ensemble member (``run_epochs``, per-epoch loop): in
    turn, or through :func:`run_epochs_ensemble` when
    :func:`resolve_ensemble` says so. Returns member 0's host-clock seconds
    per epoch (train, test, logging, ending in a device synchronize); the
    eval cadence runs after it. Checkpoints go to the writer thread
    (:func:`_checkpoint_member`); the run waits for it before it returns
    or raises, so every checkpoint is then on disk. A resume finds its
    checkpoint once the writer is idle
    (:func:`~.checkpoint.find_checkpoint`). ``profile_dir``: member 0's
    first trained epoch, its training and test pass, is traced there
    (``trainer.py:966-986``)."""
    cfg = exp.cfg
    check_supported(cfg, exp.models[0])
    if cfg.load_saved:
        resume_from_checkpoints(exp)
    cfg.save(os.path.join(cfg.dir_experiment_run, "flags.json"))
    if resolve_ensemble(cfg, exp.models[0]):
        return run_epochs_ensemble(exp, use_tensorboard=use_tensorboard,
                                   log_every=log_every, progress=progress,
                                   profile_dir=profile_dir)
    member_routes = [Routes(cfg, model, exp.device) for model in exp.models]
    sync = (torch.cuda.synchronize if exp.device.type == "cuda"
            else (lambda: None))
    walls: List[float] = []
    print("training epochs progress:")
    with _checkpoints_on_disk():
        for model_idx in range(cfg.num_models):
            logger = MetricLogger(model_log_dir(cfg, model_idx),
                                  use_tensorboard=use_tensorboard)
            logger.add_text("FLAGS", cfg.describe())
            t0 = time.time()
            for epoch in range(cfg.start_epoch, cfg.end_epoch):
                start = time.perf_counter()
                generator = epoch_generator(cfg, model_idx, epoch)
                with _tracing(profile_dir, exp.device, model_idx == 0
                              and epoch == cfg.start_epoch, epoch):
                    train_one_epoch(exp, model_idx, logger, generator, epoch,
                                    log_every, member_routes[model_idx])
                    test_one_epoch(exp, model_idx, logger, generator, epoch)
                    sync()
                if model_idx == 0:
                    walls.append(time.perf_counter() - start)
                if (eval_cadence_active(cfg)
                        and (eval_breaks_after(cfg, epoch + 1)
                             or epoch + 1 == cfg.end_epoch)):
                    run_eval_cadence(exp, model_idx, logger, epoch + 1)
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
