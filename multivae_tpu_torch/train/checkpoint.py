"""Checkpoints in a numpy-only format, in the reference's directory layout.

Counterpart of ``multivae_tpu/train/checkpoint.py``. A checkpoint is
``checkpoints/[model_i/]<epoch:04d>/model.npz``: one array per parameter,
keyed by its flax tree path (``enc_rois/heads/kernel``) in the JAX layout
(kernels ``[in, out]``), so a JAX param tree and the port's ``state_dict``
convert to it exactly (:mod:`multivae_tpu_torch.params`). Beside it,
``opt_state.npz`` holds Adam's ``count``, ``mu`` and ``nu``, the moments in
the JAX package's raveled order (``FlatAdamState``), written first: a
checkpoint directory is found through its model file, so once that exists
its optimizer state is complete. Every file is written to a temporary
name, fsynced, renamed into place, and its directory fsynced, so a crash
leaves the previous file or the new one, and the rename survives a power
loss.

A run directory the JAX package wrote reads too: its checkpoint is
``<epoch:04d>/model`` (no suffix) and ``opt_state`` beside it, both
``flax.serialization.to_bytes`` files (read by
:mod:`multivae_tpu_torch.train.flax_msgpack`). :func:`find_checkpoint`
finds either file, and :func:`checkpoint_format` tells the two formats
apart by a file's first bytes, not by its name.
"""

from __future__ import annotations

import glob
import io
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import flax_msgpack, profiling
from ..params import (
    flatten_tree,
    ravel_to_split_flat,
    split_flat_to_ravel,
    state_dict_to_tree,
    tree_to_state_dict,
    unflatten_tree,
)

CHECKPOINT_SUFFIX = ".npz"
OPT_STATE_FILE = "opt_state.npz"
JAX_OPT_STATE_FILE = "opt_state"   # the JAX package's, msgpack


@profiling.spanned("trainer.checkpoint.write")
def _atomic_write(path: str, data: bytes) -> None:
    """Write to ``<path>.tmp``, fsync, ``os.replace`` into place, then fsync
    the directory: a crash leaves the previous complete file or none, never
    a torn one, and the new name is on disk when this returns."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@profiling.spanned("trainer.checkpoint.serialize")
def _npz_bytes(arrays: Mapping[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _fetched(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: profiling.fetch(v.detach(), "trainer.checkpoint.fetch")
            for k, v in tensors.items()}


@profiling.spanned("trainer.checkpoint.serialize")
def _model_tree(model: torch.nn.Module) -> dict:
    """The model's param tree, numpy leaves, fetched from its device."""
    return state_dict_to_tree(_fetched(model.state_dict()))


def save_tree(ckpt_dir: str, tree: Mapping,
              model_save: str = "model") -> str:
    """Write a param tree (numpy leaves) as ``<ckpt_dir>/<model_save>.npz``
    crash-safely; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, model_save + CHECKPOINT_SUFFIX)
    _atomic_write(path, _npz_bytes({
        k: np.asarray(v, dtype=np.float32)
        for k, v in flatten_tree(tree).items()}))
    return path


def save_opt_state(ckpt_dir: str, opt_state, dims, mod_names) -> str:
    """Write an :class:`~multivae_tpu_torch.ops.adam.AdamState` (the layout
    of ``dims``, split or general) as ``opt_state.npz`` in the JAX package's
    raveled order."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, OPT_STATE_FILE)
    with profiling.span("trainer.checkpoint.serialize"):
        moments = _fetched({"mu": opt_state.mu, "nu": opt_state.nu})
        arrays = {k: split_flat_to_ravel(v, dims, mod_names)
                  for k, v in moments.items()}
    _atomic_write(path, _npz_bytes({
        "count": np.asarray(opt_state.count, dtype=np.int32), **arrays}))
    return path


def save_checkpoint(ckpt_dir: str, model: torch.nn.Module, opt_state=None,
                    model_save: str = "model", dims=None) -> str:
    """Write one epoch checkpoint: the optimizer state (when given, with
    the ``dims`` of its layout) before the model's weights."""
    if opt_state is not None:
        save_opt_state(ckpt_dir, opt_state, dims, model.mod_names)
    return save_tree(ckpt_dir, _model_tree(model), model_save)


def save_networks(checkpoints_dir: str, model: torch.nn.Module) -> None:
    """Per-modality encoder/decoder dumps ``enc_<mod>.npz`` /
    ``dec_<mod>.npz`` at the checkpoints root, overwritten at each save
    (``save_networks`` of the JAX package)."""
    os.makedirs(checkpoints_dir, exist_ok=True)
    tree = _model_tree(model)
    for key, sub in tree.items():
        if key.startswith("enc_") or key.startswith("dec_"):
            _atomic_write(os.path.join(checkpoints_dir,
                                       key + CHECKPOINT_SUFFIX),
                          _npz_bytes({k: np.asarray(v, dtype=np.float32)
                                      for k, v in flatten_tree(sub).items()}))


def checkpoint_format(path: str) -> str:
    """``"npz"`` (a zip archive, the port's) or ``"msgpack"`` (a
    ``flax.serialization.to_bytes`` state dict, the JAX package's), by the
    file's first bytes; anything else raises."""
    with open(path, "rb") as fh:
        head = fh.read(4)
    if head == b"PK\x03\x04":
        return "npz"
    if flax_msgpack.is_msgpack_map(head):
        return "msgpack"
    raise ValueError(f"{path}: neither an npz nor a flax msgpack "
                     f"checkpoint")


def load_tree(path: str) -> dict:
    """Read a checkpoint of either format back into a param tree of numpy
    arrays."""
    if checkpoint_format(path) == "msgpack":
        return flax_msgpack.read(path)
    with np.load(path) as fh:
        return unflatten_tree({k: fh[k] for k in fh.files})


def restore_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a checkpoint into ``model`` (strictly: every parameter)."""
    model.load_state_dict(tree_to_state_dict(load_tree(path)), strict=True)
    return model


def restore_opt_state(ckpt_dir: str, dims, mod_names, device):
    """The :class:`~multivae_tpu_torch.ops.adam.AdamState` saved in
    ``ckpt_dir`` (the layout of ``dims``, on ``device``), or None when
    there is none."""
    from ..ops.adam import AdamState

    for name in (OPT_STATE_FILE, JAX_OPT_STATE_FILE):
        path = os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            break
    else:
        return None
    if checkpoint_format(path) == "msgpack":
        # FlatAdamState, keyed by its fields as to_bytes keys a NamedTuple
        state = flax_msgpack.read(path)
        count, mu, nu = int(state["count"]), state["mu"], state["nu"]
    else:
        with np.load(path) as fh:
            count, mu, nu = int(fh["count"]), fh["mu"], fh["nu"]
    return AdamState(count,
                     ravel_to_split_flat(mu, dims, mod_names).to(device),
                     ravel_to_split_flat(nu, dims, mod_names).to(device))


def find_checkpoint(checkpoints_dir: str, model_idx: int = 0,
                    num_models: int = 1, load_epoch: Optional[int] = None,
                    model_save: str = "model") -> Tuple[str, int]:
    """Latest (or the newest at or before ``load_epoch``) checkpoint path
    and its epoch, discovered by globbing ``*/<model_save>.npz`` and the
    JAX package's ``*/<model_save>`` under the (per-member) checkpoint
    dir."""
    base = checkpoints_dir
    if num_models > 1:
        base = os.path.join(base, f"model_{model_idx}")
    cp_files = [p for p in glob.glob(os.path.join(base, "*", model_save))
                if os.path.isfile(p)
                and not os.path.exists(p + CHECKPOINT_SUFFIX)]
    cp_files += glob.glob(os.path.join(base, "*",
                                       model_save + CHECKPOINT_SUFFIX))
    if not cp_files:
        raise ValueError("You need first to train the model.")
    epochs = np.array([int(os.path.basename(os.path.dirname(p)))
                       for p in cp_files])
    order = np.argsort(epochs)
    cp_files = [cp_files[i] for i in order]
    epochs = epochs[order]
    if load_epoch is None:
        return cp_files[-1], int(epochs[-1])
    eligible = np.where(epochs <= load_epoch)[0]
    idx = int(eligible[-1]) if len(eligible) else 0
    return cp_files[idx], int(epochs[idx])
