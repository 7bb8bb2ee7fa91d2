"""Checkpoints in a numpy-only format, in the reference's directory layout.

Counterpart of ``multivae_tpu/train/checkpoint.py``. A checkpoint is
``checkpoints/[model_i/]<epoch:04d>/model.npz``: one array per parameter,
keyed by its flax tree path (``enc_rois/heads/kernel``) in the JAX layout
(kernels ``[in, out]``), so a JAX param tree and the port's ``state_dict``
convert to it exactly (:mod:`multivae_tpu_torch.params`). Reading the JAX
package's msgpack checkpoints is not done yet (ROADMAP Queue 1).
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
    state_dict_to_tree,
    tree_to_state_dict,
    unflatten_tree,
)

CHECKPOINT_SUFFIX = ".npz"


def _atomic_write(path: str, data: bytes) -> None:
    """Write to ``<path>.tmp``, fsync, then ``os.replace`` into place: a
    crash leaves the previous complete file or none, never a torn one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def save_tree(ckpt_dir: str, tree: Mapping,
              model_save: str = "model") -> str:
    """Write a param tree (numpy leaves) as ``<ckpt_dir>/<model_save>.npz``
    crash-safely; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v, dtype=np.float32)
                     for k, v in flatten_tree(tree).items()})
    path = os.path.join(ckpt_dir, model_save + CHECKPOINT_SUFFIX)
    _atomic_write(path, buf.getvalue())
    return path


def save_checkpoint(ckpt_dir: str, model: torch.nn.Module,
                    model_save: str = "model") -> str:
    """Write the model's weights as one epoch checkpoint."""
    return save_tree(ckpt_dir, state_dict_to_tree(model.state_dict()),
                     model_save)


def load_tree(path: str) -> dict:
    """Read a checkpoint back into a param tree of numpy arrays."""
    with np.load(path) as fh:
        return unflatten_tree({k: fh[k] for k in fh.files})


def restore_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a checkpoint into ``model`` (strictly: every parameter)."""
    model.load_state_dict(tree_to_state_dict(load_tree(path)), strict=True)
    return model


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
