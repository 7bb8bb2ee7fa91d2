"""The step kernels over a mesh: data-parallel row shards, and the CUDA
streams of ensemble members.

Counterpart of ``multivae_tpu/ops/fused_sharded.py``.

* Data parallel (``make_fused_dp_scan_train_step`` there): a batch's rows
  are split over the mesh's ``data`` axis. Shard ``k`` runs the row-slice
  step kernel on rows ``[k local_b, (k + 1) local_b)`` with ``row_offset =
  k local_b`` and ``b_total`` the whole batch (``csrc/mopoe_step.cu`` for
  ``joint_elbo`` without dropout, the TPU kernel ``_dp_kernel``;
  ``csrc/method_step.cu`` otherwise, ``_dp_method_kernel``), so its
  gradients and metrics are partial sums. The sum over the shards, in shard
  order, is outside the kernel as the ``psum`` is there: plain tensor adds
  on the first shard's device. :func:`mean_rescale` turns the summed local
  means into the batch's, and one Adam update (``csrc/flat_adam.cu``)
  follows per step. The noise and the masks are the single-device streams,
  row-sliced, so a sharded run and an unsharded one from one seed agree to
  the order of the sums.
* Ensemble: the members are independent; the trainer's ensemble runner
  runs each member's epoch on its entry of the mesh's ``model`` axis, on a
  CUDA stream of its own (:class:`MemberStreams`).

The shards share one flat train state on the first entry's device. A shard
whose entry is another device takes copies of the params and of its rows and
returns its partial sums to the first device.

``cfg.precision = "bfloat16"`` runs the shards on the kernels' bfloat16
branch (``bf16``, :mod:`.bf16`), as the JAX functions read ``matmul_bf16``
from it: a shard's rounded products are its local rows', summed over the
shards after rounding, as ``psum`` sums the TPU kernels' partial
gradients.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

from ..params import FusedDims, dims_from
from . import fused_step
from .adam import AdamHyper, AdamState, adam_hyper, adam_update
from .bf16 import cfg_bf16
from .fused_methods import (
    method_metric_names,
    n_dropout_masks,
    slice_method_step_flat,
)
from .fused_step import FusedConsts, metric_names, slice_step_flat, split_noise

# metric order (fused_step.METRIC_TEMPLATES, method_metric_names): [0, 9)
# and [17, ...) are sums over b_total, exact under the sum over shards;
# [9, 17) are local means, summed and then divided by the shard count
MEAN_LO, MEAN_HI = 9, 17


def mean_rescale(mvec: torch.Tensor, n_dev: int) -> torch.Tensor:
    """The metric vector of the whole batch from the shards' sum."""
    return torch.cat([mvec[:MEAN_LO],
                      mvec[MEAN_LO:MEAN_HI] / float(n_dev),
                      mvec[MEAN_HI:]])


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def _shard_devices(mesh, p: torch.Tensor, b_total: int):
    devices = mesh.axis_devices("data")
    if devices[0] != p.device:
        raise ValueError(f"the train state is on {p.device}, the mesh's "
                         f"first data entry is {devices[0]}")
    if b_total % len(devices):
        raise ValueError(f"a batch of {b_total} rows does not split over "
                         f"{len(devices)} shards: batch_size must be a "
                         f"multiple of data_parallel")
    return devices


def _dp_update(shard_step, p, mu, nu, t: int, devices, local_b: int,
               hyper: AdamHyper, rescale=mean_rescale) -> torch.Tensor:
    """Run ``shard_step(params, rows, row_offset, device) -> (metrics,
    grads)`` for every shard, sum both in shard order on the state's
    device, update the state once; returns the batch's metric vector,
    ``rescale(sum, shard count)`` (the kernels' local means divided by the
    shard count; None where every shard's metrics are already its share of
    the batch's, as the general step's)."""
    mvec = grads = None
    for k, dev in enumerate(devices):
        rows = slice(k * local_b, (k + 1) * local_b)
        m, g = shard_step(_on(p, dev), rows, k * local_b, dev)
        m, g = _on(m, p.device), _on(g, p.device)
        mvec = m if mvec is None else mvec + m
        grads = g if grads is None else grads + g
    adam_update(p, mu, nu, grads, t, hyper)
    return mvec if rescale is None else rescale(mvec, len(devices))


def dp_step_flat(p, mu, nu, t: int, x1, x2, noise, dims: FusedDims,
                 consts: FusedConsts, hyper: AdamHyper, learn_scale: bool,
                 mesh, bf16: bool = False) -> torch.Tensor:
    """One data-parallel MoPoE step and its Adam update at step ``t`` on
    the flat state, in place; ``dims.b`` is the whole batch, ``noise [B, cd
    + s1 + s2]``; ``bf16`` the bfloat16 branch. Returns ``metrics[17]`` of
    the whole batch."""
    devices = _shard_devices(mesh, p, dims.b)
    local = dims._replace(b=dims.b // len(devices))

    def shard_step(pk, rows, offset, dev):
        ej, es1, es2 = split_noise(_on(noise[rows], dev), local)
        return slice_step_flat(pk, _on(x1[rows], dev), _on(x2[rows], dev),
                               ej, es1, es2, local, consts, learn_scale,
                               offset, dims.b, bf16)
    return _dp_update(shard_step, p, mu, nu, t, devices, local.b, hyper)


def dp_method_step_flat(method: str, p, mu, nu, t: int, x1, x2, noise,
                        dims: FusedDims, consts: FusedConsts,
                        hyper: AdamHyper, learn_scale: bool, mesh,
                        masks: Optional[Sequence] = None,
                        bf16: bool = False) -> torch.Tensor:
    """One data-parallel step of ``method`` (optionally with keep masks
    ``[2 | 4, B, hidden]``) and its Adam update at step ``t`` on the flat
    state, in place; ``dims.b`` is the whole batch, ``noise [B,
    noise_width]``; ``bf16`` the bfloat16 branch. Returns ``metrics[17 |
    19]`` of the whole batch."""
    devices = _shard_devices(mesh, p, dims.b)
    local = dims._replace(b=dims.b // len(devices))

    def shard_step(pk, rows, offset, dev):
        local_masks = None if masks is None else [_on(m[rows], dev)
                                                  for m in masks]
        return slice_method_step_flat(
            method, pk, _on(x1[rows], dev), _on(x2[rows], dev),
            _on(noise[rows], dev), local, consts, learn_scale, local_masks,
            offset, dims.b, bf16)
    return _dp_update(shard_step, p, mu, nu, t, devices, local.b, hyper)


def make_fused_dp_epoch(cfg, model, mesh):
    """The data-parallel epoch over full complete batches, the contract of
    ``make_fused_dp_scan_train_step`` in the flat-buffer form: ``fn(params,
    opt, xs, noise, masks=None) -> (opt, metrics [n, k], metric names)``
    with ``xs = {mod: [n, B, d]}`` (``B`` a multiple of the mesh's ``data``
    axis), ``noise [n, B, w]`` and ``masks [n, 2 | 4, B, hidden]`` or None:
    the streams of the unsharded epoch. ``params`` and the moments are
    updated in place; ``cfg.precision`` picks the kernels' instance."""
    consts = fused_step.consts_from(cfg)
    bf16 = cfg_bf16(cfg)
    hyper = adam_hyper(cfg)
    learn_scale = bool(cfg.learn_output_scale)
    mod_names = [m.name for m in model.modalities]
    method = cfg.method
    use_hand = fused_step.takes_mopoe_step(cfg, model, cfg.batch_size)
    n_masks = 0 if use_hand else n_dropout_masks(method, cfg.dropout_rate)
    names = (metric_names(model) if use_hand
             else method_metric_names(model, method))

    def epoch(p, opt: AdamState, xs, noise, masks=None):
        x1s, x2s = xs[mod_names[0]], xs[mod_names[1]]
        n_steps, b_total = x1s.shape[0], x1s.shape[1]
        if (0 if masks is None else masks.shape[1]) != n_masks:
            raise ValueError(f"the data-parallel {method} epoch takes "
                             f"{n_masks} masks per step")
        dims = dims_from(cfg, b_total)
        steps = []
        for i in range(n_steps):
            t = opt.count + i + 1
            if use_hand:
                steps.append(dp_step_flat(
                    p, opt.mu, opt.nu, t, x1s[i], x2s[i], noise[i], dims,
                    consts, hyper, learn_scale, mesh, bf16))
            else:
                steps.append(dp_method_step_flat(
                    method, p, opt.mu, opt.nu, t, x1s[i], x2s[i], noise[i],
                    dims, consts, hyper, learn_scale, mesh,
                    None if masks is None else masks[i], bf16))
        return (AdamState(opt.count + n_steps, opt.mu, opt.nu),
                torch.stack(steps), names)
    return epoch


class MemberStreams:
    """One CUDA stream per entry of the mesh's ``model`` axis, on that
    entry's device: what member ``m`` enqueues inside :meth:`member` runs
    there, in order, beside the other members' work. On the CPU the
    contexts do nothing."""

    def __init__(self, mesh):
        self.devices: List[torch.device] = mesh.axis_devices("model")
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in self.devices]

    @contextlib.contextmanager
    def member(self, m: int):
        dev, stream = self.devices[m], self.streams[m]
        if stream is None:
            yield dev
            return
        # what the device's current stream has enqueued (the member's
        # state) comes first
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            yield dev

    def join(self) -> None:
        """Each device's current stream waits for its members' streams."""
        for dev, stream in zip(self.devices, self.streams):
            if stream is not None:
                torch.cuda.current_stream(dev).wait_stream(stream)
