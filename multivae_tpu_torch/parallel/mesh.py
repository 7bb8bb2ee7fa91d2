"""Device meshes for ensemble, data and tensor parallelism.

Counterpart of ``multivae_tpu/parallel/mesh.py`` (``make_mesh``,
``data_mesh``, ``tp_mesh``, ``tp_param_spec``). A mesh is an explicit grid
of ``torch.device`` entries with named axes: ensemble members ride the
``model`` axis, a batch's row shards the ``data`` axis, the hidden width's
column blocks the ``tensor`` axis (:mod:`.tensor`). Nothing is placed by
the mesh itself: the code that runs a shard or a member reads its entry and
launches there.

Several entries may name one device. By default the entries are the visible
cards, and a mesh with more entries than cards wraps (entry ``k`` is card
``k % count``), so one card holds every shard or member. An explicit
``devices`` list is taken as given and must be long enough.

A partition spec is a tuple of axis names or None, one per dimension of a
leaf (``()`` replicates it): the JAX module's ``PartitionSpec`` without the
``NamedSharding`` helpers, which have no counterpart here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch


class Mesh:
    """A grid of devices with named axes (``jax.sharding.Mesh``'s
    ``devices``, ``axis_names`` and ``shape``, nothing else)."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...],
                 shape: Tuple[int, ...]):
        flat = [torch.device(d) for d in devices]
        n = 1
        for s in shape:
            n *= s
        if len(shape) != len(axis_names) or n != len(flat):
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} does not "
                             f"hold {len(flat)} devices")
        self.flat: List[torch.device] = flat   # row-major over the axes
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis."""
        stride = 1
        for name in reversed(self.axis_names):
            if name == axis:
                return self.flat[:stride * self.shape[axis]:stride]
            stride *= self.shape[name]
        raise KeyError(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat]})"


def visible_cards() -> List[torch.device]:
    """One device per visible CUDA card."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def spread(device, n: int) -> List[torch.device]:
    """``n`` mesh entries starting at ``device``: the CPU ``n`` times, or
    the visible cards from ``device``'s on, wrapping at the card count."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * n
    cards = visible_cards()
    if not cards:
        raise RuntimeError("a mesh over CUDA devices needs a visible card")
    first = device.index if device.index is not None else \
        torch.cuda.current_device()
    return [cards[(first + k) % len(cards)] for k in range(n)]


def make_mesh(n_model: int = 1, n_data: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(model, data)`` mesh. ``devices=None``: the visible cards,
    wrapping when the mesh has more entries than there are cards
    (``n_data`` then defaults to ``max(cards // n_model, 1)``)."""
    if devices is None:
        if n_data is None:
            n_data = max(len(visible_cards()) // n_model, 1)
        devices = spread("cuda", n_model * n_data)
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_model
    n = n_model * n_data
    if n > len(devices):
        raise ValueError(f"mesh {n_model}x{n_data} needs {n} devices, have "
                         f"{len(devices)}")
    return Mesh(devices[:n], ("model", "data"), (n_model, n_data))


def data_mesh(n_data: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D data-parallel mesh of ``n_data`` entries (every device of
    ``devices``, or every visible card, when ``n_data`` is None)."""
    if devices is None:
        n_data = n_data or max(len(visible_cards()), 1)
        devices = spread("cuda", n_data)
    devices = list(devices)
    n_data = n_data or len(devices)
    if n_data > len(devices):
        raise ValueError(f"data mesh needs {n_data} devices, have "
                         f"{len(devices)}")
    return Mesh(devices[:n_data], ("data",), (n_data,))


def tp_mesh(n_tensor: int, n_data: int = 1,
            devices: Optional[Sequence] = None) -> Mesh:
    """A ``("data", "tensor")`` mesh of ``n_data x n_tensor`` entries for
    tensor (and data) parallel training (``mesh.py:64-84``): entry ``(d,
    t)`` is device ``d n_tensor + t`` of ``devices``, by default the
    visible cards, wrapping as :func:`make_mesh` does."""
    n = n_data * n_tensor
    if devices is None:
        devices = spread("cuda", n)
    devices = list(devices)
    if n > len(devices):
        raise ValueError(f"tp mesh {n_data}x{n_tensor} needs {n} devices, "
                         f"have {len(devices)}")
    return Mesh(devices[:n], ("data", "tensor"), (n_data, n_tensor))


def tp_param_spec(shape, hidden: int) -> Tuple[Optional[str], ...]:
    """The partition spec of one flax leaf under hidden-width sharding
    (``mesh.py:90-108``, the same rule in the same order): a 2-D kernel
    ``[in, out]`` whose rows are ``hidden`` wide shards its rows
    (``("tensor", None)``, the row-split side whose product is summed over
    the axis), else one whose columns are shards its columns (``(None,
    "tensor")``); a 1-D leaf of width ``hidden`` shards; every other leaf
    is replicated (``()``)."""
    shape = tuple(shape)
    if len(shape) == 2:
        if shape[0] == hidden:
            return ("tensor", None)
        if shape[1] == hidden:
            return (None, "tensor")
    elif len(shape) == 1 and shape[0] == hidden:
        return ("tensor",)
    return ()
