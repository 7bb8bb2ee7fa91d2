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
loss. Reading the JAX package's msgpack checkpoints is not done yet
(ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

import glob
import io
import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

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


def _npz_bytes(arrays: Mapping[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


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
    _atomic_write(path, _npz_bytes({
        "count": np.asarray(opt_state.count, dtype=np.int32),
        "mu": split_flat_to_ravel(opt_state.mu, dims, mod_names),
        "nu": split_flat_to_ravel(opt_state.nu, dims, mod_names)}))
    return path


def save_checkpoint(ckpt_dir: str, model: torch.nn.Module, opt_state=None,
                    model_save: str = "model", dims=None) -> str:
    """Write one epoch checkpoint: the optimizer state (when given, with
    the ``dims`` of its layout) before the model's weights."""
    if opt_state is not None:
        save_opt_state(ckpt_dir, opt_state, dims, model.mod_names)
    return save_tree(ckpt_dir, state_dict_to_tree(model.state_dict()),
                     model_save)


def save_networks(checkpoints_dir: str, model: torch.nn.Module) -> None:
    """Per-modality encoder/decoder dumps ``enc_<mod>.npz`` /
    ``dec_<mod>.npz`` at the checkpoints root, overwritten at each save
    (``save_networks`` of the JAX package)."""
    os.makedirs(checkpoints_dir, exist_ok=True)
    tree = state_dict_to_tree(model.state_dict())
    for key, sub in tree.items():
        if key.startswith("enc_") or key.startswith("dec_"):
            _atomic_write(os.path.join(checkpoints_dir,
                                       key + CHECKPOINT_SUFFIX),
                          _npz_bytes({k: np.asarray(v, dtype=np.float32)
                                      for k, v in flatten_tree(sub).items()}))


def load_tree(path: str) -> dict:
    """Read a checkpoint back into a param tree of numpy arrays."""
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

    path = os.path.join(ckpt_dir, OPT_STATE_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path) as fh:
        count, mu, nu = int(fh["count"]), fh["mu"], fh["nu"]
    return AdamState(count,
                     ravel_to_split_flat(mu, dims, mod_names).to(device),
                     ravel_to_split_flat(nu, dims, mod_names).to(device))


def find_checkpoint(checkpoints_dir: str, model_idx: int = 0,
                    num_models: int = 1, load_epoch: Optional[int] = None,
                    model_save: str = "model") -> Tuple[str, int]:
    """Latest (or the newest at or before ``load_epoch``) checkpoint path
    and its epoch, discovered by globbing ``*/<model_save>.npz`` under the
    (per-member) checkpoint dir."""
    base = checkpoints_dir
    if num_models > 1:
        base = os.path.join(base, f"model_{model_idx}")
    cp_files = glob.glob(os.path.join(base, "*",
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
