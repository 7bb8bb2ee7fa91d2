"""Routes: which step takes each batch of a member's epoch, and in which
precision, decided here alone (``multivae_tpu/train/trainer.py:41-72,
834-944`` there). The trainer, the ensemble runner, :func:`check_supported`
and ``resolve_ensemble`` read a :class:`Routes`.

An epoch runs its full-size complete batches first, then the other batches
grouped by ``(presence pattern, rows)``. With ``fused_training``:

* on the split layout's architecture (any method; poe with its unimodal
  ELBOs) a group of complete batches takes the MoPoE step
  (``csrc/mopoe_step.cu``) for ``joint_elbo`` without dropout, else the
  method step (``csrc/method_step.cu``), and a single-present group the
  presence step (``csrc/presence_step.cu``): each persistent, a group ONE
  launch with Adam inside. With ``data_parallel = N > 1`` the full complete
  batches take the row-slice epoch instead (``ops/fused_sharded.py``: each
  batch's rows split over ``N`` shards, their gradients summed in shard
  order, one Adam update); ``N`` must divide ``batch_size``;
* on any other architecture the full complete batches take the layer-stack
  step (``ops/fused_generic.py``, ``csrc/generic_step.cu``) and every other
  batch the general autograd step (``trainer.py:896-899, 925-944`` there);
  past that step's caps :attr:`Routes.gaps` name the ROADMAP item and the
  config raises.

Every batch takes a general step with ``tensor_parallel > 1`` (the
tensor-parallel step over a ``("data", "tensor")`` mesh, ``:834-859``), and
without ``fused_training`` or with ``data_parallel = N > 1`` off the split
layout (the data-parallel general step over ``N`` entries where the rows
divide ``N``, else the unsharded one, ``:860-865, 909-935``).

``precision="bfloat16"`` (the kernels' ``matmul_bf16`` branch,
``ops/bf16.py``) takes, as the JAX package does:

* one member, no data parallel: every kernel group, a partial complete
  ``joint_elbo`` one on the method step (the group policy never takes the
  MoPoE kernel, ``trainer.py:63-66`` there; under float32 the two steps
  compute the same function);
* the row-slice route: the full complete batches, the other groups
  float32 (its XLA step, ``:925-940``);
* the ensemble runner, members spread over the cards: each member's first
  ``bf16_full`` full complete batches, unsharded; on one card nothing
  (``:1011-1105, 241-343``);
* the layer-stack, autograd and tensor-parallel steps read no precision.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

from ..ops import (
    fused_generic,
    fused_methods,
    fused_presence,
    fused_sharded,
    fused_step,
)
from ..ops.adam import AdamState, adam_hyper
from ..ops.bf16 import cfg_bf16
from ..parallel import data_mesh, spread, tp_mesh
from ..parallel.tensor import check_divides
from ..params import GenericDims, dims_from, generic_dims, layout_index
from . import profiling
from .train_step import mesh_for_rows, model_replicas

# the steps a group's batches can take
MOPOE, METHOD, PRESENCE = "mopoe", "method", "presence"
ROW_SLICE, LAYER_STACK = "row-slice", "layer-stack"
AUTOGRAD, DP_AUTOGRAD, TENSOR = "autograd", "dp-autograd", "tensor"
# how a config's full complete batches run: on a group kernel, on the
# row-slice or layer-stack epoch, or each on a general step
KERNEL, GENERAL = "kernel", "general"
PRECISIONS = ("float32", "bfloat16")   # by whether the branch is on


class Step(NamedTuple):
    """What takes a group's batches, in what precision (None: reads none),
    and the group's epoch function (:func:`~.trainer.make_group_fused_epoch`'s
    contract), or None and the mesh of the general step each batch takes."""
    name: str
    precision: Optional[str]
    epoch: Optional[Callable]
    mesh: object = None


def check_supported(cfg, model) -> None:
    """Raise ``NotImplementedError`` naming each of :attr:`Routes.gaps`."""
    gaps = Routes(cfg, model).gaps
    if gaps:
        raise NotImplementedError(
            "not ported to multivae_tpu_torch yet: " + "; ".join(gaps))


def group_kernel(cfg, model, key) -> str:
    """The step kernel of the batches of one ``(presence pattern, rows)``
    group: :data:`MOPOE` or :data:`METHOD` for complete batches
    (:func:`~..ops.fused_step.takes_mopoe_step`), :data:`PRESENCE` for a
    single-present one. A group the JAX package routes to a kernel the port
    does not have raises."""
    mods, rows = key
    present = {m: None for m in mods}
    if len(mods) == len(model.modalities):
        if fused_methods.supports_method_fused(cfg, model, present):
            return (MOPOE if fused_step.takes_mopoe_step(cfg, model, rows)
                    else METHOD)
    elif fused_presence.supports_presence_fused(cfg, model, present):
        return PRESENCE
    check_supported(cfg, model)
    raise NotImplementedError(f"no kernel for the group {key}")


class Routes:
    """One member's routes on ``device``, built once per run: the general
    step's mesh (``step_mesh``) and model replicas, the row-slice or
    layer-stack epoch, and each kernel group's epoch at its first use;
    ``device`` None decides alone and builds nothing. ``ensemble``: None
    for the sequential loop, else whether the ensemble runner's members
    spread over the cards. ``kernel_config``: whether a step kernel takes
    the config's full complete batches by the JAX package's rule, which
    reads no mesh (``resolve_ensemble``'s ``"auto"``). ``gaps``: what keeps
    the config off the layer-stack step its full complete batches take."""

    def __init__(self, cfg, model, device=None,
                 ensemble: Optional[bool] = None):
        n_data, n_tensor = int(cfg.data_parallel), int(cfg.tensor_parallel)
        fused = bool(cfg.fused_training)
        complete = {m.name: None for m in model.modalities}
        method = fused_methods.supports_method_fused(cfg, model, complete)
        self.cfg, self.model = cfg, model
        self.bf16 = cfg_bf16(cfg)
        self.full_key = (tuple(sorted(complete)), cfg.batch_size)
        self.kernel_config = fused and (
            method or fused_generic.supports_generic_fused(cfg, model,
                                                           complete))
        if n_tensor > 1 or not fused or (n_data > 1 and not method):
            self.full = GENERAL
        elif not method:
            self.full = LAYER_STACK
        elif n_data > 1 and not (self.bf16 and ensemble is not None):
            self.full = ROW_SLICE     # the JAX runner's members: unsharded
        else:
            self.full = KERNEL
        self.gaps = (fused_generic.envelope_gaps(cfg, model)
                     if self.full == LAYER_STACK else [])
        bf16_kernels = self.bf16 and self.full == KERNEL
        self._bf16_groups = bf16_kernels and ensemble is None
        self._bf16_prefix = bf16_kernels and ensemble is not False
        self._cfg_f32 = (dataclasses.replace(cfg, precision="float32")
                         if self.bf16 else cfg)
        self._kernels: Dict = {}
        self.step_mesh = self.replicas = self._full_step = None
        if device is None:
            return
        if self.gaps:
            check_supported(cfg, model)
        if n_tensor > 1:
            check_divides(cfg, n_tensor)
            self.step_mesh = tp_mesh(n_tensor, n_data,
                                     spread(device, n_data * n_tensor))
        elif self.full == GENERAL and n_data > 1:
            self.step_mesh = data_mesh(n_data, spread(device, n_data))
        if self.step_mesh is not None:
            self.replicas = model_replicas(model)
        if self.full == ROW_SLICE:
            if cfg.batch_size % n_data:
                raise ValueError(
                    f"batch_size={cfg.batch_size} is not a multiple of "
                    f"data_parallel={n_data}: every shard takes batch_size "
                    f"/ data_parallel rows of a full batch")
            self._full_step = Step(ROW_SLICE, PRECISIONS[self.bf16],
                                   fused_sharded.make_fused_dp_epoch(
                                       cfg, model, data_mesh(
                                           n_data, spread(device, n_data))))
        elif self.full == LAYER_STACK:
            self._full_step = Step(LAYER_STACK, None,
                                   _layer_stack_epoch(cfg, model))

    def general(self, rows: int) -> Step:
        """The general step of a batch of ``rows`` rows: over the
        tensor-parallel mesh, over the data mesh where the rows divide it,
        else unsharded."""
        mesh = self.step_mesh
        if mesh is not None and "tensor" in mesh.shape:
            return Step(TENSOR, None, None, mesh)
        mesh = mesh_for_rows(mesh, rows)
        return Step(AUTOGRAD if mesh is None else DP_AUTOGRAD, None, None,
                    mesh)

    def full_parts(self, n: int, bf16_full: Optional[int] = None):
        """The ``n`` full complete batches of an epoch as ``(lo, hi,
        step)`` runs. ``bf16_full`` (the ensemble runner's): at most the
        first ``bf16_full`` take the bfloat16 branch, the others float32."""
        if not n:
            return []
        if self.full != KERNEL:
            return [(0, n, self._full_step or self.general(
                self.cfg.batch_size))]
        if bf16_full is None:
            k = n if self._bf16_groups else 0
        else:
            k = min(int(bf16_full), n) if self._bf16_prefix else 0
        return [(lo, hi, self._kernel(self.full_key, bf16))
                for lo, hi, bf16 in ((0, k, True), (k, n, False))
                if hi > lo]

    def group(self, key, bf16_full: Optional[int] = None) -> Step:
        """The step of a ``(presence pattern, rows)`` group other than the
        full complete batches; ``bf16_full`` given (an ensemble member's
        epoch), a kernel group takes float32."""
        if self.full not in (KERNEL, ROW_SLICE):
            return self.general(key[1])
        return self._kernel(key, self._bf16_groups and bf16_full is None)

    def _kernel(self, key, bf16: bool) -> Step:
        step = self._kernels.get((key, bf16))
        if step is None:
            # looked up at each build: a harness may wrap it there
            from . import trainer

            cfg = self.cfg if bf16 else self._cfg_f32
            step = self._kernels[(key, bf16)] = Step(
                group_kernel(cfg, self.model, key), PRECISIONS[bf16],
                trainer.make_group_fused_epoch(cfg, self.model, key))
        return step


def _layer_stack_epoch(cfg, model):
    """The layer-stack step's epoch of the full complete batches, metric
    rows in the TPU kernel's order. At the split layout's architecture (poe
    without its unimodal ELBOs) the state is gathered into the general
    layout for the launch and scattered back after it."""
    mod_names = [m.name for m in model.modalities]
    dims = generic_dims(cfg, cfg.batch_size)
    layout = dims_from(cfg, cfg.batch_size)
    gather = (None if isinstance(layout, GenericDims)
              else layout_index(layout, dims, mod_names))
    consts = fused_step.consts_from(cfg)
    hyper = adam_hyper(cfg)
    learn_scale = bool(cfg.learn_output_scale)
    method = cfg.method
    uni = bool(cfg.poe_unimodal_elbos)
    names = fused_generic.generic_metric_names(model, method, uni)
    order = fused_generic.metric_permutation(model, method, uni)

    def generic(p, opt, xs, noise, masks=None):
        state = (p, opt.mu, opt.nu)
        if gather is not None:
            index = profiling.to_device(gather, p.device)
            state = tuple(t[index] for t in state)
        metrics = fused_generic.generic_epoch_flat(
            method, *state, opt.count, [xs[m] for m in mod_names], noise,
            dims, consts, hyper, learn_scale, masks, order,
            unimodal_elbos=uni)
        if gather is not None:
            for t, g in zip((p, opt.mu, opt.nu), state):
                t[index] = g
        return (AdamState(opt.count + len(noise), opt.mu, opt.nu), metrics,
                names)
    return generic
