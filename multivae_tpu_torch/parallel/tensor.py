"""Tensor parallelism: the model's MLP layers split over a mesh's ``tensor``
axis, composed with data parallelism over its ``data`` axis.

Counterpart of ``make_tp_train_step`` / ``make_tp_scan_train_step``
(``multivae_tpu/train/train_step.py:120-199``) and of the GSPMD placement
of ``tp_param_spec`` there (``parallel/mesh.py:90-108``). JAX states the
placement and XLA inserts the collectives; here both are written out with
plain torch ops:

* **placement.** Each step cuts the flat params into pieces by
  :func:`~.mesh.tp_param_spec` (:func:`multivae_tpu_torch.params.tp_pieces`):
  a sharded leaf's ``k``-th block lives on tensor entry ``k``, a replicated
  leaf on the first entry. Each piece is an autograd leaf;
* **layers** (Megatron's, :meth:`TensorShards.linear`). An activation of
  the hidden width is either whole, on the first entry, or split into
  column blocks, block ``k`` on entry ``k``. A column-split layer (its
  kernel's columns sharded) takes a whole input (a split one is gathered)
  and gives a split output, each entry adding its bias block. A row-split
  layer (its kernel's rows sharded) takes a split input (a whole one is
  sliced where it is) and gives partial sums, summed over the axis in entry
  order on the first entry; its bias is added once, after the sum, gathered
  when it is a sharded hidden-width leaf. Any other layer runs whole on the
  first entry. The rule tests the rows first, so a ``[hidden, hidden]``
  layer is row-split and split layers need not alternate. ReLU and the
  dropout keep masks (``[B, hidden]``, cut by the same columns, so they are
  the unsharded step's masks) apply blockwise;
* **gradients and Adam.** Autograd through the copies between entries
  gives every piece's gradient; the pieces are joined into one flat
  gradient on the first entry, in the train state's layout, and Adam runs
  there on the flat state, which stays whole as JAX keeps ``opt_state``
  replicated (``train_step.py:120-131``): ``csrc/flat_adam.cu`` on a card,
  its plain version on the CPU. The next step cuts the pieces again;
* **the data axis.** A batch whose rows divide the ``data`` axis shards
  over it (``trainer.py:849-858``): data row ``d`` of the mesh runs the
  layers above on its rows as a slice of the whole batch
  (:class:`~multivae_tpu_torch.ops.fusion.Rows`), and the rows' gradients
  and metrics are summed as ``ops.fused_sharded._dp_update`` sums data
  shards. Any other batch runs whole on the first data row.

The step reads no precision: the JAX package's TP step is its XLA step.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from ..ops.adam import AdamHyper, AdamState
from ..params import tp_axis, tp_gather, tp_gather_flat, tp_pieces, tp_slice
from ..train.train_step import loss_and_metrics, sharded_step
from .mesh import tp_param_spec


class Split(list):
    """An activation ``[B, hidden]`` held as one column block per tensor
    entry, block ``k`` on entry ``k``."""


class TensorShards:
    """One step's params cut over the tensor entries ``devices`` of a data
    row of the mesh, and the model's layers run on them."""

    def __init__(self, flat: torch.Tensor, dims, mod_names, hidden: int,
                 devices: List[torch.device], trainable: Dict[str, bool]):
        self.devices = list(devices)
        self.n = len(self.devices)
        self.pieces, self.specs = tp_pieces(
            flat, dims, mod_names, lambda s: tp_param_spec(s, hidden),
            self.devices)
        self.dims, self.mod_names = dims, mod_names
        for path, pieces in self.pieces.items():
            for piece in pieces:
                piece.requires_grad_(trainable[path])

    # ----------------------------------------------------------- activations
    def whole(self, h):
        """A whole activation on the first entry."""
        return tp_gather(h, (None, "tensor")) if isinstance(h, Split) else h

    def split(self, h) -> Split:
        """A split activation: a whole one sliced into column blocks."""
        if isinstance(h, Split):
            return h
        return Split(tp_slice(h, (None, "tensor"), k, self.n).to(dev)
                     for k, dev in enumerate(self.devices))

    def leaf(self, path: str) -> torch.Tensor:
        """A leaf whole on the first entry."""
        return tp_gather(self.pieces[path], self.specs[path])

    # ---------------------------------------------------------------- layers
    def linear(self, path: str, h):
        """``h @ kernel + bias`` of the layer at ``path``, as its kernel's
        spec splits it (the module's docstring)."""
        kernel = f"{path}/kernel"
        axis = tp_axis(self.specs[kernel])
        if axis == 1:       # column-split: whole in, split out; its bias
            x = self.whole(h)   # is hidden wide, so sharded too
            return Split(x.to(dev) @ w + b for dev, w, b in zip(
                self.devices, self.pieces[kernel], self.pieces[
                    f"{path}/bias"]))
        if axis == 0:       # row-split: split in, summed out
            xs = self.split(h)
            out = None
            for x, w in zip(xs, self.pieces[kernel]):
                part = (x @ w).to(self.devices[0])
                out = part if out is None else out + part
            return out + self.leaf(f"{path}/bias")
        return self.whole(h) @ self.leaf(kernel) + self.leaf(f"{path}/bias")

    def act(self, h, mask: Optional[torch.Tensor]):
        """ReLU, then the keep mask, blockwise on a split activation."""
        if not isinstance(h, Split):
            h = torch.relu(h)
            return h if mask is None else h * mask
        out = Split()
        for k, (x, dev) in enumerate(zip(h, self.devices)):
            x = torch.relu(x)
            if mask is not None:
                x = x * tp_slice(mask, (None, "tensor"), k, self.n).to(dev)
            out.append(x)
        return out

    def stack(self, net: str, n_layers: int, h, masks):
        """The hidden layers ``hidden_0 .. hidden_{n - 1}`` of ``net``."""
        for i in range(n_layers):
            h = self.act(self.linear(f"{net}/hidden_{i}", h),
                         None if masks is None else masks[i])
        return h

    # ------------------------------------------------------------- the model
    def encoder_forward(self, net: str, module):
        def forward(x, masks=None):
            h = self.stack(net, module.num_hidden_layers, x, masks)
            return module.split_heads(self.whole(self.linear(
                f"{net}/heads", h)))
        return forward

    def decoder_forward(self, net: str, module):
        def forward(style_z, class_z, masks=None):
            h = self.stack(net, module.num_hidden_layers,
                           module.latent_input(style_z, class_z), masks)
            if module.learn_output_sample_scale:
                return module.outputs(self.whole(self.linear(
                    f"{net}/out_heads", h)))
            return module.outputs(self.whole(self.linear(f"{net}/out_mu", h)),
                                  self.leaf(f"{net}/out_logvar"))
        return forward

    @contextlib.contextmanager
    def installed(self, model):
        """The model's encoders and decoders run on these pieces inside the
        block (their ``forward`` replaced on the instances, restored
        after)."""
        modules = []
        for name in model.mod_names:
            for net, make in ((f"enc_{name}", self.encoder_forward),
                              (f"dec_{name}", self.decoder_forward)):
                module = getattr(model, net)
                module.forward = make(net, module)
                modules.append(module)
        try:
            yield
        finally:
            for module in modules:
                del module.forward

    def grad_flat(self) -> torch.Tensor:
        """The flat gradient (zeros for a frozen leaf) on the first
        entry."""
        grads = {path: [p.grad if p.grad is not None
                        else torch.zeros_like(p) for p in pieces]
                 for path, pieces in self.pieces.items()}
        return tp_gather_flat(grads, self.specs, self.dims, self.mod_names)


def trainable_leaves(model) -> Dict[str, bool]:
    """Whether each flax leaf of ``model`` trains (a frozen output scale
    does not)."""
    out = {}
    for name, p in model.named_parameters():
        *parents, last = name.split(".")
        out["/".join(parents + ["kernel" if last == "weight" else last])] = \
            p.requires_grad
    return out


def check_divides(cfg, n_tensor: int) -> None:
    """``hidden_dim`` must split over the tensor axis
    (``train_step.py:133-137``)."""
    if cfg.hidden_dim % n_tensor:
        raise ValueError(
            f"tensor_parallel={n_tensor} must divide "
            f"hidden_dim={cfg.hidden_dim} (the hidden dimension is what "
            f"shards over the tensor axis)")


def tp_step(cfg, model, params: torch.Tensor, opt: AdamState,
            batch: Dict[str, torch.Tensor], noise: torch.Tensor, dims,
            hyper: AdamHyper, mesh, masks=None):
    """One tensor-parallel step over the ``("data", "tensor")`` mesh
    (:func:`~.mesh.tp_mesh`), in place on ``params`` (whole, on the mesh's
    first entry) and ``opt``'s moments: ``(opt with count + 1, loss,
    metrics)``, the whole batch's. ``batch``, ``noise`` and ``masks`` as
    in :func:`multivae_tpu_torch.train.train_step.general_step`."""
    n_data, n_tensor = mesh.shape["data"], mesh.shape["tensor"]
    check_divides(cfg, n_tensor)
    rows = len(next(iter(batch.values())))
    grid = [mesh.flat[d * n_tensor:(d + 1) * n_tensor] for d in range(n_data)]
    shards = n_data if rows % n_data == 0 else 1
    trainable = trainable_leaves(model)

    def shard_grads(pk, shard, eps, shard_masks, row_window, d):
        pieces = TensorShards(pk, dims, model.mod_names, cfg.hidden_dim,
                              grid[d], trainable)
        with torch.enable_grad(), pieces.installed(model):
            loss, metrics = loss_and_metrics(cfg, model, shard, eps,
                                             shard_masks, row_window)
            loss.backward()
        return ({k: v.detach() for k, v in metrics.items()},
                pieces.grad_flat())

    return sharded_step(shard_grads, params, opt, batch, noise, hyper,
                        [grid[d][0] for d in range(shards)], masks)
