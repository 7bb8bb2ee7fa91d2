"""Device meshes for ensemble x data parallelism.

Counterpart of ``multivae_tpu/parallel/mesh.py:19-39`` (``make_mesh``,
``data_mesh``). A mesh is an explicit grid of ``torch.device`` entries with
named axes: ensemble members ride the ``model`` axis, a batch's row shards
the ``data`` axis. Nothing is placed by the mesh itself: the code that runs
a shard or a member reads its entry and launches there.

Several entries may name one device. By default the entries are the visible
cards, and a mesh with more entries than cards wraps (entry ``k`` is card
``k % count``), so one card holds every shard or member. An explicit
``devices`` list is taken as given and must be long enough.

Tensor and pipeline parallelism (``tp_mesh``, ``tp_param_spec``,
``pipeline.py``) and the ``NamedSharding`` helpers of the JAX module have no
counterpart here.
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
