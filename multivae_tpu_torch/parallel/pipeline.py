"""GPipe pipeline parallelism over a homogeneous layer stack.

Counterpart of ``multivae_tpu/parallel/pipeline.py``: the stages of a deep
stack sit one per entry of a 1-D ``("pipe",)`` mesh and microbatches stream
through them on the GPipe fill-and-drain schedule: with ``S`` stages and
``M`` microbatches the pipeline runs ``T = M + S - 1`` ticks, and at tick
``t`` stage ``s`` runs microbatch ``t - s`` where that exists (the bubble
is ``(S - 1) / T``). Each entry runs only its own stage, on its own
device, and the activations hop to the next entry by ``.to(device)``
(``lax.ppermute`` there). Autograd through the schedule gives the reverse
pipeline, the hops running backwards. A stage must keep the activation's
shape; the pipelined MLP folds its narrower first layer into the stack by
zero-padding the input to the stack's width, which is exact (the padded
kernel rows only ever multiply zeros, so their gradients are 0).

The mesh's entries may name one device (one card holds every stage); by
default they are the visible cards and, as in the JAX package, too few of
them raise.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Sequence

import torch

from ..params import tree_to_tensors
from .mesh import Mesh, visible_cards


def pipe_mesh(n_stages: int, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D ``("pipe",)`` mesh with one stage per entry."""
    devices = list(devices if devices is not None else visible_cards())
    if n_stages > len(devices):
        raise ValueError(f"pipeline of {n_stages} stages needs {n_stages} "
                         f"devices, have {len(devices)}")
    return Mesh(devices[:n_stages], ("pipe",), (n_stages,))


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def stack_stages(stage_params: Sequence):
    """Stage parameter trees (dicts of tensors, one shape per leaf) stacked
    along a new leading stage axis."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *stage_params)


def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor, *,
                   n_micro: int, mesh: Mesh, axis_name: str = "pipe",
                   with_coords: bool = False) -> torch.Tensor:
    """``x [batch, d]`` through the stage stack on the GPipe schedule.

    ``stage_fn(stage_params, h) -> h`` (with ``with_coords``:
    ``stage_fn(stage_params, h, stage, micro)``, the stage and microbatch
    indices, for a stochastic stage) keeps ``h``'s shape;
    ``stacked_params`` has one slice per stage on its leading axis
    (:func:`stack_stages`); ``n_micro`` must divide the batch. Returns the
    stack's output on ``x``'s device, equal to the stages applied in turn.
    """
    devices = mesh.axis_devices(axis_name)
    n_stages = len(devices)
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by n_micro {n_micro}")
    mb = batch // n_micro
    params = [_tree_map(lambda leaf, s=s: leaf[s].to(devices[s]),
                        stacked_params) for s in range(n_stages)]
    inbox = [None] * n_stages   # what each stage reads this tick
    done = []
    for t in range(n_micro + n_stages - 1):
        outbox = [None] * n_stages
        for s, dev in enumerate(devices):
            micro = t - s
            if not 0 <= micro < n_micro:
                continue        # filling or draining: the stage is idle
            h = (x[micro * mb:(micro + 1) * mb].to(dev) if s == 0
                 else inbox[s])
            out = (stage_fn(params[s], h, s, micro) if with_coords
                   else stage_fn(params[s], h))
            if s == n_stages - 1:
                done.append(out.to(x.device))
            else:
                outbox[s + 1] = out.to(devices[s + 1])
        inbox = outbox
    return torch.cat(done)


# ---------------------------------------------------------------------------
# the worked example: a pipelined deep-MLP regressor and its train step
# ---------------------------------------------------------------------------
def mlp_stage(p, h):
    """One homogeneous stage: ``relu(h @ w + b)``."""
    return torch.relu(h @ p["w"] + p["b"])


def init_pipelined_mlp(in_dim: int, hidden: int, out_dim: int,
                       n_layers: int, tree: Optional[Mapping] = None,
                       generator: Optional[torch.Generator] = None):
    """The deep MLP's params ``{"stack": {"w": [S, hidden, hidden], "b":
    [S, hidden]}, "head": {"w": [hidden, out_dim], "b": [out_dim]}}``, the
    first layer's kernel zero beyond row ``in_dim``.

    ``tree``: the JAX package's ``init_pipelined_mlp`` params as numpy
    arrays, carried over by :func:`multivae_tpu_torch.params.
    tree_to_tensors`; else drawn from ``generator`` by the same law
    (uniform in ``±1 / sqrt(fan_in)``, a zero head bias)."""
    if tree is not None:
        params = tree_to_tensors(tree)
        want = {"stack": {"w": (n_layers, hidden, hidden),
                          "b": (n_layers, hidden)},
                "head": {"w": (hidden, out_dim), "b": (out_dim,)}}
        got = _tree_map(lambda t: tuple(t.shape), params)
        if got != want:
            raise ValueError(f"pipelined MLP params of shapes {got}, want "
                             f"{want}")
        return params
    ws, bs = [], []
    for i in range(n_layers):
        bound = 1.0 / math.sqrt(in_dim if i == 0 else hidden)
        w = torch.empty(hidden, hidden).uniform_(-bound, bound,
                                                 generator=generator)
        if i == 0 and in_dim < hidden:
            w[in_dim:] = 0.0
        ws.append(w)
        bs.append(torch.empty(hidden).uniform_(-bound, bound,
                                               generator=generator))
    bound = 1.0 / math.sqrt(hidden)
    head = {"w": torch.empty(hidden, out_dim).uniform_(-bound, bound,
                                                        generator=generator),
            "b": torch.zeros(out_dim)}
    return {"stack": {"w": torch.stack(ws), "b": torch.stack(bs)},
            "head": head}


def _pad_input(x, hidden: int):
    return torch.nn.functional.pad(x, (0, hidden - x.shape[1]))


def _head_loss(params, h, y):
    pred = h @ params["head"]["w"] + params["head"]["b"]
    return torch.mean((pred - y) ** 2)


def pipelined_mlp_loss(params, x, y, *, n_micro: int, mesh: Mesh):
    """MSE of the pipelined deep MLP (the stack on the GPipe schedule)."""
    h = pipeline_apply(mlp_stage, params["stack"],
                       _pad_input(x, params["head"]["w"].shape[0]),
                       n_micro=n_micro, mesh=mesh)
    return _head_loss(params, h, y)


def sequential_mlp_loss(params, x, y):
    """The reference on one device: the same stack applied in turn."""
    h = _pad_input(x, params["head"]["w"].shape[0])
    stack = params["stack"]
    for s in range(stack["w"].shape[0]):
        h = mlp_stage({"w": stack["w"][s], "b": stack["b"][s]}, h)
    return _head_loss(params, h, y)


def make_pipelined_train_step(mesh: Mesh, n_micro: int, lr: float = 1e-2):
    """``step(params, x, y) -> (new params, loss)``: SGD whose forward and
    backward both run the pipeline."""
    names = (("stack", "w"), ("stack", "b"), ("head", "w"), ("head", "b"))

    def step(params, x, y):
        leaves = _tree_map(lambda t: t.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = pipelined_mlp_loss(leaves, x, y, n_micro=n_micro,
                                      mesh=mesh)
            grads = torch.autograd.grad(loss, [leaves[a][b]
                                               for a, b in names])
        new = {"stack": {}, "head": {}}
        for (a, b), g in zip(names, grads):
            new[a][b] = (leaves[a][b] - lr * g).detach()
        return new, loss.detach()
    return step
