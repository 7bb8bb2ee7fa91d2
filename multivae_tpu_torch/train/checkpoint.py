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

The trainer fetches and encodes a checkpoint on its own thread
(:func:`checkpoint_files`) and hands the files to :data:`WRITER`, one
worker thread that writes them (:class:`CheckpointWriter`) while the next
epochs run. The crash contract, that of
``torch.distributed.checkpoint.async_save``:

* every file is still atomic, and every rename is made durable by a
  directory fsync;
* checkpoints complete in order, file after file as submitted, and at
  most one is in flight: a checkpoint is on disk before the next one's
  first file is written;
* every checkpoint is on disk when ``run_epochs`` returns or raises;
* a crash can lose only the newest checkpoint's unfinished files, which a
  crash during a synchronous write lost too; :func:`find_checkpoint` then
  finds the previous complete one.

:func:`save_checkpoint`, :func:`save_tree`, :func:`save_opt_state` and
:func:`save_networks` write synchronously.

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
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

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


def _atomic_write(path: str, data: bytes, dir_fd: int) -> None:
    """Write to ``<path>.tmp``, fsync, ``os.replace`` into place, then fsync
    the directory (open as ``dir_fd``): a crash leaves the previous
    complete file or none, never a torn one, and the new name is on disk
    when this returns. Plain ``os`` calls: each gives up the GIL and takes
    it back, and the writer thread takes it as few times as it can."""
    tmp = path + ".tmp"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o666)
    try:
        view = memoryview(data)
        while view:
            view = view[os.write(fd, view):]
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    os.fsync(dir_fd)


Files = Sequence[Tuple[str, bytes]]  # (path, bytes), written in this order


@profiling.spanned("trainer.checkpoint.flush")
def _write_files(files: Files) -> None:
    """:func:`_atomic_write` each file in order, each directory opened once."""
    dir_fds: Dict[str, int] = {}
    try:
        for path, data in files:
            folder = os.path.dirname(os.path.abspath(path))
            if folder not in dir_fds:
                dir_fds[folder] = os.open(folder, os.O_RDONLY)
            _atomic_write(path, data, dir_fds[folder])
    finally:
        for fd in dir_fds.values():
            os.close(fd)


class CheckpointWriter:
    """One worker thread, started at the first :meth:`submit`, that writes
    jobs of ``(path, bytes)`` files (:func:`_atomic_write` each, in order)
    while the caller goes on. At most one job is in flight: :meth:`submit`
    first waits for the previous one. An error of the worker is raised on
    the caller's thread at the next :meth:`submit` or :meth:`wait`.

    Every wait runs in the span ``trainer.checkpoint.write`` on the
    caller's thread (the part of the writes the caller still waits for);
    the worker's files in ``trainer.checkpoint.flush``. Counters, on the
    caller's thread: ``checkpoint_files_deferred`` (files handed over) and
    ``checkpoint_writer_waits`` (waits that found the worker busy)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._job: Optional[Files] = None
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def submit(self, files: Files) -> None:
        """Hand ``files`` (their directories made, their bytes the
        writer's own) to the worker, once the previous job is written."""
        self.wait()
        profiling.count("checkpoint_files_deferred", len(files))
        with self._cond:
            self._job = list(files)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="checkpoint-writer", daemon=True)
                self._thread.start()
            self._cond.notify_all()

    def wait(self) -> None:
        """Block until every submitted file is on disk; raise the worker's
        error, if it had one."""
        with profiling.span("trainer.checkpoint.write"), self._cond:
            if self._job is not None:
                profiling.count("checkpoint_writer_waits", 1)
            while self._job is not None:
                self._cond.wait()
            error, self._error = self._error, None
        if error is not None:
            raise error

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._job is None:
                    self._cond.wait()
                job = self._job
            error = None
            try:
                _write_files(job)
            except BaseException as exc:  # raised on the caller's thread
                error = exc
            with self._cond:
                self._error, self._job = error, None
                self._cond.notify_all()


# One writer for the process, so that every checkpoint it writes (members
# and runs in turn overwrite the same enc_/dec_ dumps) completes in order;
# each run drains it before it returns or raises.
WRITER = CheckpointWriter()


@profiling.spanned("trainer.checkpoint.serialize")
def _npz_bytes(arrays: Mapping[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _fetched(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The tensors on the host: those of a dtype joined on their device and
    fetched in one copy, one wait for the device."""
    tensors = {k: v.detach() for k, v in tensors.items()}
    out = {}
    for dtype in dict.fromkeys(v.dtype for v in tensors.values()):
        keys = [k for k, v in tensors.items() if v.dtype == dtype]
        host = profiling.fetch(torch.cat([tensors[k].reshape(-1)
                                          for k in keys]),
                               "trainer.checkpoint.fetch")
        parts = host.split([tensors[k].numel() for k in keys])
        out.update({k: part.view(tensors[k].shape)
                    for k, part in zip(keys, parts)})
    return {k: out[k] for k in tensors}


@profiling.spanned("trainer.checkpoint.serialize")
def _model_tree(model: torch.nn.Module) -> dict:
    """The model's param tree, numpy leaves, fetched from its device."""
    return state_dict_to_tree(_fetched(model.state_dict()))


@profiling.spanned("trainer.checkpoint.serialize")
def _opt_state_arrays(opt_state, dims, mod_names) -> Dict[str, np.ndarray]:
    """``opt_state.npz``'s arrays: Adam's count and its moments, fetched
    and raveled in the JAX package's order."""
    moments = _fetched({"mu": opt_state.mu, "nu": opt_state.nu})
    return {"count": np.asarray(opt_state.count, dtype=np.int32),
            **{k: split_flat_to_ravel(v, dims, mod_names)
               for k, v in moments.items()}}


def _tree_bytes(tree: Mapping) -> bytes:
    return _npz_bytes({k: np.asarray(v, dtype=np.float32)
                       for k, v in flatten_tree(tree).items()})


def _network_files(checkpoints_dir: str, tree: Mapping) -> Files:
    return [(os.path.join(checkpoints_dir, key + CHECKPOINT_SUFFIX),
             _tree_bytes(sub))
            for key, sub in tree.items()
            if key.startswith("enc_") or key.startswith("dec_")]


def save_tree(ckpt_dir: str, tree: Mapping,
              model_save: str = "model") -> str:
    """Write a param tree (numpy leaves) as ``<ckpt_dir>/<model_save>.npz``
    crash-safely; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, model_save + CHECKPOINT_SUFFIX)
    _write_files([(path, _tree_bytes(tree))])
    return path


def save_opt_state(ckpt_dir: str, opt_state, dims, mod_names) -> str:
    """Write an :class:`~multivae_tpu_torch.ops.adam.AdamState` (the layout
    of ``dims``, split or general) as ``opt_state.npz`` in the JAX package's
    raveled order."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, OPT_STATE_FILE)
    _write_files([(path, _npz_bytes(
        _opt_state_arrays(opt_state, dims, mod_names)))])
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
    _write_files(_network_files(checkpoints_dir, _model_tree(model)))


def checkpoint_files(ckpt_dir: str, networks_dir: str,
                     model: torch.nn.Module, opt_state=None,
                     model_save: str = "model", dims=None) -> Files:
    """The files :func:`save_checkpoint` and :func:`save_networks` write,
    byte for byte, as ``(path, bytes)`` in their order, for
    :meth:`CheckpointWriter.submit`; the directories are made. The state
    is fetched (the model once) and encoded here, before the submit: on
    the CPU a fetch is the live tensor itself, which the next epoch's
    steps update in place, so the writer is handed bytes of its own."""
    os.makedirs(ckpt_dir, exist_ok=True)
    os.makedirs(networks_dir, exist_ok=True)
    with profiling.span("trainer.checkpoint.serialize"):
        opt = (None if opt_state is None
               else _opt_state_arrays(opt_state, dims, model.mod_names))
        tree = _model_tree(model)
        files = [] if opt is None else [
            (os.path.join(ckpt_dir, OPT_STATE_FILE), _npz_bytes(opt))]
        files.append((os.path.join(ckpt_dir, model_save + CHECKPOINT_SUFFIX),
                      _tree_bytes(tree)))
        files += _network_files(networks_dir, tree)
    return files


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
    dir, once :data:`WRITER` has written every checkpoint submitted."""
    WRITER.wait()
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
