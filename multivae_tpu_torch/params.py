"""The weights bridge between the JAX param tree and the port's modules.

The JAX package keeps a flax param tree: nested dicts whose leaves are
``kernel [in, out]``, ``bias [out]`` and ``out_logvar [1, D]``. The port's
``state_dict`` has the same paths joined by dots, with ``weight [out, in]``
in place of ``kernel``. :func:`tree_to_state_dict` and
:func:`state_dict_to_tree` convert between the two exactly (a rename and a
transpose). :func:`flatten_tree` / :func:`unflatten_tree` key a tree by its
``/``-joined path, the checkpoint format.

The packed and split layouts of the fused kernels (``FLAT_NAMES``,
``SPLIT_NAMES``, :func:`flatten_params`, :func:`split_params`,
:func:`join_params`; ``multivae_tpu/ops/fused_step.py:65-105, 164-248``)
are carried here without their kernels. They stay in the JAX layout
``[in, out]``, which is what the kernels take.

Training keeps params and the Adam moments as flat buffers in the split
layout (:func:`flat_views`); :func:`split_flat_to_ravel` and
:func:`ravel_to_split_flat` convert such a buffer to and from the JAX
package's raveled ``FlatAdamState`` vectors.

Tensor parallelism cuts the leaves of a flat buffer into pieces by their
partition spec (:func:`tp_pieces`, :func:`tp_slice`; the rule is
``multivae_tpu_torch.parallel.tp_param_spec``) and joins the pieces'
gradients back into a flat buffer (:func:`tp_gather_flat`). A tree of
numpy arrays in the JAX layout, as the pipelined MLP's stacked stages or a
checkpoint read by :mod:`multivae_tpu_torch.train.flax_msgpack`, becomes
tensors by :func:`tree_to_tensors`.

An architecture outside the split layout (any modality count from 2, any
encoder and decoder depth, any of the three output-scale modes) trains on
the general flat layout
(:class:`GenericDims`, :func:`generic_shapes`): the leaves of the flax tree
themselves, each in the JAX layout, back to back in model order.
:func:`dims_from` picks the layout of a config (:func:`generic_dims` gives
any config's general-layout dims, :func:`layout_index` moves a buffer
between the two layouts), and :func:`flat_size`,
:func:`flat_views`, :func:`model_flat_params`, :func:`load_flat_params`,
:func:`grads_to_flat`, :func:`split_flat_to_ravel` and
:func:`ravel_to_split_flat` serve both, by the type of the dims.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, \
    Sequence, Tuple

import numpy as np
import torch


class FusedDims(NamedTuple):
    b: int        # batch
    d1: int       # clinical width
    d2: int       # rois width
    h: int        # hidden width
    cd: int       # class (content) dim
    s1: int       # clinical style dim
    s2: int       # rois style dim


class GenericDims(NamedTuple):
    """The sizes of the general flat layout: the batch, per modality (in
    model order) its width and its style width, the hidden and content
    widths, the depths, the output-scale mode and the likelihood. A style
    width of 0 is a modality without style latents (the unfactorized
    latent)."""
    b: int
    ds: Tuple[int, ...]  # per-modality widths
    h: int
    cd: int
    ss: Tuple[int, ...]  # per-modality style widths
    n_enc: int          # encoder hidden layers (>= 1)
    n_dec: int          # decoder hidden layers (>= 0)
    sample_scale: bool  # a per-sample output scale (``out_heads``)
    # one of ``ops.likelihoods.LIKELIHOODS`` (the kernels take its index)
    likelihood: str = "normal"

    @property
    def m(self) -> int:
        """The modality count."""
        return len(self.ds)

    # the first two modalities' sizes under the split layout's names
    @property
    def d1(self) -> int:
        return self.ds[0]

    @property
    def d2(self) -> int:
        return self.ds[1]

    @property
    def s1(self) -> int:
        return self.ss[0]

    @property
    def s2(self) -> int:
        return self.ss[1]


def split_layout(cfg) -> bool:
    """Whether ``cfg`` is the architecture the split layout describes: two
    modalities, one encoder hidden layer, linear decoders, factorized
    styles, normal likelihood with a per-feature output scale."""
    return (len(cfg.input_dim) == 2
            and cfg.num_hidden_layer_encoder == 1
            and cfg.num_hidden_layer_decoder == 0
            and bool(cfg.factorized_representation)
            and all(s > 0 for s in cfg.style_dim)
            and cfg.likelihood == "normal"
            and not cfg.learn_output_sample_scale)


def generic_dims(cfg, batch_size: int) -> GenericDims:
    """The general layout's dims of ``cfg``, whatever its architecture
    (``Config.derive`` gives an unfactorized latent style widths 0)."""
    return GenericDims(
        b=batch_size, ds=tuple(int(d) for d in cfg.input_dim),
        h=cfg.hidden_dim, cd=cfg.class_dim,
        ss=tuple(int(s) for s in cfg.style_dim),
        n_enc=int(cfg.num_hidden_layer_encoder),
        n_dec=int(cfg.num_hidden_layer_decoder),
        sample_scale=bool(cfg.learn_output_sample_scale),
        likelihood=cfg.likelihood)


def dims_from(cfg, batch_size: int):
    """The dims of the layout ``cfg`` trains on: :class:`FusedDims` for the
    split layout, :class:`GenericDims` for any other architecture or
    likelihood."""
    if not split_layout(cfg):
        return generic_dims(cfg, batch_size)
    return FusedDims(b=batch_size, d1=cfg.input_dim[0], d2=cfg.input_dim[1],
                     h=cfg.hidden_dim, cd=cfg.class_dim,
                     s1=cfg.style_dim[0], s2=cfg.style_dim[1])


# packed layout (matches the flax param tree)
FLAT_NAMES = (
    "enc1_Wh", "enc1_bh", "enc1_Wo", "enc1_bo",
    "enc2_Wh", "enc2_bh", "enc2_Wo", "enc2_bo",
    "dec1_Wd", "dec1_bd", "dec1_olv",
    "dec2_Wd", "dec2_bd", "dec2_olv",
)

# split layout consumed by the kernels (one tensor per head)
SPLIT_NAMES = tuple(
    f"{e}_{part}" for e in ("enc1", "enc2")
    for part in ("Wh", "bh", "Wcmu", "bcmu", "Wclv", "bclv",
                 "Wsmu", "bsmu", "Wslv", "bslv")
) + tuple(
    f"{d}_{part}" for d in ("dec1", "dec2")
    for part in ("Wds", "Wdc", "bd", "olv")
)


# ----------------------------------------------------------------- the tree
def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """Nested param tree -> ``{"enc_rois/heads/kernel": leaf, ...}``."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(flatten_tree(val, path + "/"))
        else:
            out[path] = val
    return out


def unflatten_tree(flat: Mapping[str, object]) -> Dict:
    """Inverse of :func:`flatten_tree`."""
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def tree_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy or array-like leaves) -> port ``state_dict``."""
    sd = {}
    for path, leaf in flatten_tree(tree).items():
        arr = torch.as_tensor(np.array(leaf, dtype=np.float32))
        *parents, last = path.split("/")
        if last == "kernel":
            last, arr = "weight", arr.T.contiguous()
        sd[".".join(parents + [last])] = arr
    return sd


def state_dict_to_tree(sd: Mapping[str, torch.Tensor],
                       as_numpy: bool = True) -> Dict:
    """Port ``state_dict`` -> JAX param tree; leaves are numpy arrays, or
    the tensors themselves (transposed views for kernels) when
    ``as_numpy`` is False."""
    flat = {}
    for key, val in sd.items():
        *parents, last = key.split(".")
        if last == "weight":
            last, val = "kernel", val.T
        if as_numpy:
            val = val.detach().cpu().numpy().copy()
        flat["/".join(parents + [last])] = val
    return unflatten_tree(flat)


# ------------------------------------------------- packed and split layouts
def flatten_params(tree: Mapping, mod_names) -> Dict[str, object]:
    """Param tree -> packed named dict (the flagship 2-modality layout)."""
    n1, n2 = mod_names
    return {
        "enc1_Wh": tree[f"enc_{n1}"]["hidden_0"]["kernel"],
        "enc1_bh": tree[f"enc_{n1}"]["hidden_0"]["bias"],
        "enc1_Wo": tree[f"enc_{n1}"]["heads"]["kernel"],
        "enc1_bo": tree[f"enc_{n1}"]["heads"]["bias"],
        "enc2_Wh": tree[f"enc_{n2}"]["hidden_0"]["kernel"],
        "enc2_bh": tree[f"enc_{n2}"]["hidden_0"]["bias"],
        "enc2_Wo": tree[f"enc_{n2}"]["heads"]["kernel"],
        "enc2_bo": tree[f"enc_{n2}"]["heads"]["bias"],
        "dec1_Wd": tree[f"dec_{n1}"]["out_mu"]["kernel"],
        "dec1_bd": tree[f"dec_{n1}"]["out_mu"]["bias"],
        "dec1_olv": tree[f"dec_{n1}"]["out_logvar"],
        "dec2_Wd": tree[f"dec_{n2}"]["out_mu"]["kernel"],
        "dec2_bd": tree[f"dec_{n2}"]["out_mu"]["bias"],
        "dec2_olv": tree[f"dec_{n2}"]["out_logvar"],
    }


def split_params(p: Mapping[str, object], dims: FusedDims):
    """Packed -> split layout: the head columns and the decoder's style and
    content input rows become separate tensors."""
    cd = dims.cd
    out = {}
    for e, s in (("enc1", dims.s1), ("enc2", dims.s2)):
        Wo, bo = p[f"{e}_Wo"], p[f"{e}_bo"]
        out[f"{e}_Wh"] = p[f"{e}_Wh"]
        out[f"{e}_bh"] = p[f"{e}_bh"]
        out[f"{e}_Wcmu"] = Wo[:, :cd]
        out[f"{e}_bcmu"] = bo[:cd]
        out[f"{e}_Wclv"] = Wo[:, cd:2 * cd]
        out[f"{e}_bclv"] = bo[cd:2 * cd]
        out[f"{e}_Wsmu"] = Wo[:, 2 * cd:2 * cd + s]
        out[f"{e}_bsmu"] = bo[2 * cd:2 * cd + s]
        out[f"{e}_Wslv"] = Wo[:, 2 * cd + s:]
        out[f"{e}_bslv"] = bo[2 * cd + s:]
    for d, s in (("dec1", dims.s1), ("dec2", dims.s2)):
        Wd = p[f"{d}_Wd"]
        out[f"{d}_Wds"] = Wd[:s]
        out[f"{d}_Wdc"] = Wd[s:]
        out[f"{d}_bd"] = p[f"{d}_bd"]
        out[f"{d}_olv"] = p[f"{d}_olv"]
    return out


def join_params(sp: Mapping[str, torch.Tensor], dims: FusedDims):
    """Split -> packed layout of tensors (inverse of :func:`split_params`)."""
    out = {}
    for e in ("enc1", "enc2"):
        out[f"{e}_Wh"] = sp[f"{e}_Wh"]
        out[f"{e}_bh"] = sp[f"{e}_bh"]
        out[f"{e}_Wo"] = torch.cat([sp[f"{e}_Wcmu"], sp[f"{e}_Wclv"],
                                    sp[f"{e}_Wsmu"], sp[f"{e}_Wslv"]], dim=1)
        out[f"{e}_bo"] = torch.cat([sp[f"{e}_bcmu"], sp[f"{e}_bclv"],
                                    sp[f"{e}_bsmu"], sp[f"{e}_bslv"]])
    for d in ("dec1", "dec2"):
        out[f"{d}_Wd"] = torch.cat([sp[f"{d}_Wds"], sp[f"{d}_Wdc"]])
        out[f"{d}_bd"] = sp[f"{d}_bd"]
        out[f"{d}_olv"] = sp[f"{d}_olv"]
    return out


def model_split_params(model, dims: FusedDims) -> Dict[str, torch.Tensor]:
    """The model's weights in the split layout, as contiguous tensors on
    the model's device."""
    tree = state_dict_to_tree(model.state_dict(), as_numpy=False)
    sp = split_params(flatten_params(tree, model.mod_names), dims)
    return {k: v.detach().contiguous() for k, v in sp.items()}


def packed_to_tree(p: Mapping[str, object], mod_names) -> Dict:
    """Packed named dict -> param tree (inverse of :func:`flatten_params`;
    ``multivae_tpu`` ``unflatten_grads``)."""
    n1, n2 = mod_names
    tree = {}
    for i, n in ((1, n1), (2, n2)):
        tree[f"enc_{n}"] = {
            "hidden_0": {"kernel": p[f"enc{i}_Wh"], "bias": p[f"enc{i}_bh"]},
            "heads": {"kernel": p[f"enc{i}_Wo"], "bias": p[f"enc{i}_bo"]}}
        tree[f"dec_{n}"] = {
            "out_mu": {"kernel": p[f"dec{i}_Wd"], "bias": p[f"dec{i}_bd"]},
            "out_logvar": p[f"dec{i}_olv"]}
    return tree


# ------------------------------------------------------------ the flat state
# The port trains on three flat float32 buffers (params, Adam mu, Adam nu)
# holding the 28 split tensors back to back in SPLIT_NAMES order; the split
# tensors are views of them. The kernels take a buffer and compute the same
# offsets from the dims (csrc/step_common.cuh, make_layout).
def split_shapes(dims: FusedDims) -> Dict[str, tuple]:
    """Shape of every split tensor, in SPLIT_NAMES order."""
    shapes = {}
    for e, d, s in (("enc1", dims.d1, dims.s1), ("enc2", dims.d2, dims.s2)):
        shapes.update({
            f"{e}_Wh": (d, dims.h), f"{e}_bh": (dims.h,),
            f"{e}_Wcmu": (dims.h, dims.cd), f"{e}_bcmu": (dims.cd,),
            f"{e}_Wclv": (dims.h, dims.cd), f"{e}_bclv": (dims.cd,),
            f"{e}_Wsmu": (dims.h, s), f"{e}_bsmu": (s,),
            f"{e}_Wslv": (dims.h, s), f"{e}_bslv": (s,)})
    for dd, d, s in (("dec1", dims.d1, dims.s1), ("dec2", dims.d2, dims.s2)):
        shapes.update({f"{dd}_Wds": (s, d), f"{dd}_Wdc": (dims.cd, d),
                       f"{dd}_bd": (d,), f"{dd}_olv": (1, d)})
    return {n: shapes[n] for n in SPLIT_NAMES}


# The general flat layout: the leaves of the flax tree, each in the JAX layout
# ([in, out] kernels), back to back in this order: encoder 1 .. encoder M,
# decoder 1 .. decoder M (model order, whatever the names' sorted order);
# inside an encoder ``hidden_0`` .. ``hidden_{n_enc - 1}`` then ``heads``;
# inside a decoder ``hidden_0`` .. ``hidden_{n_dec - 1}`` then ``out_mu`` and
# ``out_logvar``, or ``out_heads`` with a per-sample scale; of a layer the
# kernel, then the bias. Names are ``enc1/hidden_0/kernel``;
# csrc/generic_step.cu (make_layout) computes the same offsets.
def generic_shapes(dims: GenericDims) -> Dict[str, tuple]:
    """Shape of every tensor of the general layout, in its order."""
    shapes = {}
    for e, (d, s) in enumerate(zip(dims.ds, dims.ss)):
        width = d
        for i in range(dims.n_enc):
            shapes[f"enc{e + 1}/hidden_{i}/kernel"] = (width, dims.h)
            shapes[f"enc{e + 1}/hidden_{i}/bias"] = (dims.h,)
            width = dims.h
        n_heads = 2 * dims.cd + 2 * s
        shapes[f"enc{e + 1}/heads/kernel"] = (width, n_heads)
        shapes[f"enc{e + 1}/heads/bias"] = (n_heads,)
    for e, (d, s) in enumerate(zip(dims.ds, dims.ss)):
        width = s + dims.cd
        for i in range(dims.n_dec):
            shapes[f"dec{e + 1}/hidden_{i}/kernel"] = (width, dims.h)
            shapes[f"dec{e + 1}/hidden_{i}/bias"] = (dims.h,)
            width = dims.h
        if dims.sample_scale:
            shapes[f"dec{e + 1}/out_heads/kernel"] = (width, 2 * d)
            shapes[f"dec{e + 1}/out_heads/bias"] = (2 * d,)
        else:
            shapes[f"dec{e + 1}/out_mu/kernel"] = (width, d)
            shapes[f"dec{e + 1}/out_mu/bias"] = (d,)
            shapes[f"dec{e + 1}/out_logvar"] = (1, d)
    return shapes


def layout_shapes(dims) -> Dict[str, tuple]:
    """Name and shape of every tensor of the layout of ``dims``, in order."""
    if isinstance(dims, GenericDims):
        return generic_shapes(dims)
    return split_shapes(dims)


@functools.lru_cache(maxsize=None)
def flat_size(dims) -> int:
    """Floats of the layout's flat buffer (remembered per ``dims``: every
    kernel launch checks its buffers against it)."""
    return sum(math.prod(s) for s in layout_shapes(dims).values())


def flat_views(buf: torch.Tensor, dims) -> Dict[str, torch.Tensor]:
    """The layout's tensors as views of a flat buffer."""
    out, off = {}, 0
    for name, shape in layout_shapes(dims).items():
        n = math.prod(shape)
        out[name] = buf[off:off + n].view(shape)
        off += n
    if off != buf.numel():
        raise ValueError(f"flat buffer holds {buf.numel()} floats, the "
                         f"layout {off}")
    return out


def flatten_split(sp: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Split tensors -> one new flat buffer in SPLIT_NAMES order."""
    return torch.cat([sp[n].reshape(-1) for n in SPLIT_NAMES]).contiguous()


def flatten_named(tensors: Mapping[str, torch.Tensor], dims) -> torch.Tensor:
    """The layout's tensors (by name) -> one new flat buffer in its order."""
    return torch.cat([tensors[n].reshape(-1)
                      for n in layout_shapes(dims)]).contiguous()


def _generic_paths(dims: GenericDims, mod_names) -> Dict[str, str]:
    """General-layout name -> flax tree path (``enc1/heads/kernel`` ->
    ``enc_<modality 1>/heads/kernel``)."""
    out = {}
    for name in generic_shapes(dims):
        net, rest = name.split("/", 1)
        out[name] = f"{net[:3]}_{mod_names[int(net[3:]) - 1]}/{rest}"
    return out


def _flat_tree(flat: torch.Tensor, dims, mod_names) -> Dict[str, torch.Tensor]:
    """A flat buffer as ``{flax tree path: leaf}`` (views where the layout
    allows)."""
    views = flat_views(flat, dims)
    if isinstance(dims, GenericDims):
        paths = _generic_paths(dims, mod_names)
        return {paths[n]: v for n, v in views.items()}
    return flatten_tree(packed_to_tree(join_params(views, dims), mod_names))


def _tree_flat(leaves: Mapping[str, torch.Tensor], dims,
               mod_names) -> torch.Tensor:
    """Inverse of :func:`_flat_tree`: a new flat buffer."""
    if isinstance(dims, GenericDims):
        paths = _generic_paths(dims, mod_names)
        shapes = generic_shapes(dims)
        for n, p in paths.items():
            if tuple(leaves[p].shape) != shapes[n]:
                raise ValueError(f"{p}: shape {tuple(leaves[p].shape)}, the "
                                 f"layout has {shapes[n]}")
        return torch.cat([leaves[paths[n]].reshape(-1)
                          for n in shapes]).contiguous()
    packed = flatten_params(unflatten_tree(leaves), mod_names)
    return flatten_split(split_params(packed, dims))


def model_flat_params(model, dims) -> torch.Tensor:
    """The model's weights as a flat buffer in the layout of ``dims``."""
    if isinstance(dims, GenericDims):
        tree = state_dict_to_tree(model.state_dict(), as_numpy=False)
        return _tree_flat({k: v.detach() for k, v in
                           flatten_tree(tree).items()}, dims, model.mod_names)
    return flatten_split(model_split_params(model, dims))


def grads_to_flat(model, dims) -> torch.Tensor:
    """The model's ``.grad`` s as a flat buffer of the layout of ``dims``
    (zero where a parameter has none, e.g. a frozen output scale)."""
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    tree = state_dict_to_tree(grads, as_numpy=False)
    return _tree_flat(flatten_tree(tree), dims, model.mod_names).detach()


@torch.no_grad()
def load_flat_params(model, flat: torch.Tensor, dims) -> None:
    """Copy a flat buffer of the layout of ``dims`` into the model's
    parameters."""
    sd = {}
    for path, leaf in _flat_tree(flat, dims, model.mod_names).items():
        *parents, last = path.split("/")
        if last == "kernel":
            last, leaf = "weight", leaf.T
        sd[".".join(parents + [last])] = leaf
    model.load_state_dict(sd, strict=True)


def layout_index(src, dst, mod_names) -> torch.Tensor:
    """Indices that gather a flat buffer of the layout ``src`` into the
    layout ``dst`` of the same params: ``buf[layout_index(src, dst,
    names)]`` holds every tensor in ``dst``'s place (the split and the
    general layout hold the same floats in another order)."""
    where = torch.arange(flat_size(src), dtype=torch.float64)
    return _tree_flat(_flat_tree(where, src, mod_names), dst,
                      mod_names).long()


def ravel_order(tree: Mapping) -> list:
    """The flat paths of a param tree in ``jax.flatten_util.ravel_pytree``
    order: dict keys sorted at every level. That is not model order once a
    name sorts apart from its place (``clinical, rois, mod2, mod3`` ravel as
    ``clinical, mod2, mod3, rois``): the general layout keeps model order
    and the conversions go by path."""
    return sorted(flatten_tree(tree), key=lambda p: tuple(p.split("/")))


@functools.lru_cache(maxsize=16)
def _ravel_index(dims, mod_names: tuple) -> np.ndarray:
    """For each float of the JAX package's raveled vector, its place in a
    flat buffer of the layout of ``dims``: the layout's conversion run on
    the places themselves (float64, exact), as int64."""
    where = torch.arange(flat_size(dims), dtype=torch.float64)
    leaves = _flat_tree(where, dims, mod_names)
    return np.concatenate([leaves[p].reshape(-1).numpy()
                           for p in ravel_order(unflatten_tree(leaves))]
                          ).astype(np.int64)


def split_flat_to_ravel(flat: torch.Tensor, dims, mod_names) -> np.ndarray:
    """The port's flat state (the layout of ``dims``) -> the JAX package's
    raveled vector (``FlatAdamState.mu``/``nu`` order): one gather of the
    buffer by :func:`_ravel_index`."""
    flat = torch.as_tensor(flat).detach().cpu()
    if flat.numel() != flat_size(dims):
        raise ValueError(f"flat buffer holds {flat.numel()} floats, the "
                         f"layout {flat_size(dims)}")
    return flat.reshape(-1).numpy()[_ravel_index(dims, tuple(mod_names))
                                    ].astype(np.float32, copy=False)


def ravel_to_split_flat(vec, dims, mod_names) -> torch.Tensor:
    """Inverse of :func:`split_flat_to_ravel`."""
    vec = torch.as_tensor(np.asarray(vec, dtype=np.float32))
    template = _flat_tree(torch.zeros(flat_size(dims)), dims, mod_names)
    shapes = {p: tuple(v.shape) for p, v in template.items()}
    total = sum(math.prod(s) for s in shapes.values())
    if total != vec.numel():
        raise ValueError(f"raveled vector holds {vec.numel()} floats, the "
                         f"param tree {total}")
    leaves, off = {}, 0
    for path in ravel_order(unflatten_tree(template)):
        n = math.prod(shapes[path])
        leaves[path] = vec[off:off + n].reshape(shapes[path])
        off += n
    return _tree_flat(leaves, dims, mod_names)


def tree_to_tensors(tree: Mapping) -> Dict:
    """A nested tree of numpy arrays (or array-likes) as float32 tensors
    with the same structure and layout."""
    return {k: (tree_to_tensors(v) if isinstance(v, Mapping)
                else torch.as_tensor(np.array(v, dtype=np.float32)))
            for k, v in tree.items()}


# ------------------------------------------------ tensor-parallel pieces
def tp_axis(spec) -> Optional[int]:
    """The dimension a partition spec shards over the ``tensor`` axis, or
    None for a replicated leaf."""
    return spec.index("tensor") if "tensor" in spec else None


def tp_slice(leaf: torch.Tensor, spec, k: int, n: int) -> torch.Tensor:
    """Piece ``k`` of ``n`` of a leaf (JAX layout) under ``spec``: its
    ``k``-th block along the sharded dimension, or the leaf itself when it
    is replicated."""
    axis = tp_axis(spec)
    if axis is None:
        return leaf
    width = leaf.shape[axis] // n
    return leaf.narrow(axis, k * width, width)


def tp_gather(pieces: Sequence[torch.Tensor], spec) -> torch.Tensor:
    """Inverse of :func:`tp_slice` over ``k = 0 .. n - 1``: the pieces
    joined in order on the first one's device."""
    axis = tp_axis(spec)
    if axis is None:
        return pieces[0]
    dev = pieces[0].device
    return torch.cat([p.to(dev) for p in pieces], dim=axis)


def tp_pieces(flat: torch.Tensor, dims, mod_names,
              spec_of: Callable[[tuple], tuple], devices
              ) -> Tuple[Dict[str, List[torch.Tensor]], Dict[str, tuple]]:
    """The leaves of a flat buffer cut over ``devices`` (the tensor axis's
    entries, in order): ``({flax path: pieces}, {flax path: spec})``. A
    sharded leaf gives one copy of its piece on each entry, a replicated
    leaf one copy on the first entry; ``spec_of(shape)`` gives a leaf's
    partition spec."""
    pieces, specs = {}, {}
    for path, leaf in _flat_tree(flat, dims, mod_names).items():
        spec = specs[path] = spec_of(tuple(leaf.shape))
        if tp_axis(spec) is None:
            pieces[path] = [leaf.detach().to(devices[0]).clone()]
        else:
            pieces[path] = [tp_slice(leaf.detach(), spec, k,
                                     len(devices)).to(dev).clone()
                            for k, dev in enumerate(devices)]
    return pieces, specs


def tp_gather_flat(leaves: Mapping[str, Sequence[torch.Tensor]],
                   specs: Mapping[str, tuple], dims,
                   mod_names) -> torch.Tensor:
    """A flat buffer in the layout of ``dims`` from every leaf's pieces
    (the inverse of :func:`tp_pieces`), on the first entry's device."""
    return _tree_flat({path: tp_gather(p, specs[path])
                       for path, p in leaves.items()}, dims, mod_names)
