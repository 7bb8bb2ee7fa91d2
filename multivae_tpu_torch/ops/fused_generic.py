"""Train steps of complete batches for architectures outside the split
layout: a hand-written CUDA layer-stack kernel and its plain PyTorch version.

Counterpart of ``multivae_tpu/ops/fused_generic.py``. The TPU kernel
(``make_generic_fused_epoch``) traces ``jax.value_and_grad`` of the real
``model.apply`` + ``total_loss`` into its body, for any model. CUDA cannot
trace a model into a kernel, so the port writes the step by hand with the
sizes as arguments: :func:`generic_fwd_bwd_reference` (plain) and
``csrc/generic_step.cu`` (kernel) compute the loss of one full complete
batch, its metric families and the gradient of every parameter, for
``M = 2 .. MAX_MODS`` modalities, encoders of ``1 .. MAX_DEPTH`` hidden
layers, decoders of ``0 .. MAX_DEPTH`` hidden layers, each output-scale mode
(a learned or a frozen per-feature ``out_logvar``, or the per-sample
``out_heads`` projection to ``loc | logvar``) and each likelihood of
``LIKELIHOODS`` (:func:`output_nll`; bernoulli and categorical read the
location as logits and leave the log-variance an exact zero gradient). A
style width of 0 is a modality without style latents: the unfactorized
latent has no style heads, noise or KL, and its decoders read the content
latent alone. Between the stacks stands the method's latent math: at M = 2
the method step's (:func:`.fused_methods.latent_fwd_bwd`,
``csrc/latent_common.cuh``), at any other M and for poe without its
unimodal ELBOs the M-modality one (:func:`.latent_multi.latent_fwd_bwd`,
``csrc/latent_multi.cuh``). The
kernel is persistent: on CUDA tensors :func:`generic_epoch_flat` runs a
whole group of steps with Adam inside in ONE cooperative launch (the TPU
kernel's epoch contract), and one step is the same kernel with ``n = 1`` and
Adam off.

The envelope (:func:`supports_generic_fused`): every modality present, the
methods of ``PORTED_METHODS`` (poe with or without its unimodal ELBOs),
``2 .. MAX_MODS`` modalities and ``1 .. MAX_DEPTH`` / ``0 .. MAX_DEPTH``
hidden layers; beyond those caps the trainer raises, naming the ROADMAP
item.

Params, gradients and the Adam moments are flat buffers in the general
layout (:func:`multivae_tpu_torch.params.generic_shapes`). The modalities'
batches are a sequence ``xs`` in model order.

Noise ``[B, noise_width]``: ``cd | s_1 .. s_M``; poe with its unimodal ELBOs
appends ``cd | s_m`` per modality (a style width of 0 has no columns).
Dropout masks are pre-scaled keep masks ``[n_masks, B, hidden]`` (values in
``{0, 1 / (1 - rate)}``), one per hidden layer and pass, multiplied in after
the ReLU, in this order: the main pass's encoder 1 layers ``0 .. n_enc -
1``, .. encoder M's, decoder 1 layers ``0 .. n_dec - 1``, .. decoder M's;
then for poe's unimodal ELBOs the re-runs' masks in the same order
(``M (n_enc + n_dec)`` masks per pass). Under dropout poe's unimodal ELBOs
re-encode and decode with their own masks; without it they reuse the main
pass's encodings and decode their own latents.

A step's metric vector is in the order of
:func:`.latent_multi.step_metric_names` (a style family without style
latents holds 0); :func:`generic_epoch_flat` returns the rows of
:func:`generic_metric_names`, the TPU kernel's (``loss``, then the other
families ``total_loss`` emits, sorted by name). On CUDA tensors a step
launches the kernel, on CPU tensors it runs the plain version; a kernel that
does not build or launch raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from ..params import GenericDims, flat_size, flat_views, flatten_named
from . import latent_multi
from .adam import AdamHyper, adam_scalars, adam_update
from .fused_methods import METHODS, latent_fwd_bwd
from .fused_step import (
    LOG2PI,
    FusedConsts,
    argtypes_of,
    check_inputs,
    check_phase_times,
    check_stack,
    workspace,
)
from .likelihoods import LIKELIHOODS, tie_sign

PORTED_METHODS = METHODS
LOG2 = math.log(2.0)
# the caps of the kernel (kMaxMods, kMaxDepth of generic_step.cu; a launch
# also reads them from the library)
MAX_MODS = 10   # modalities
MAX_DEPTH = 8   # hidden layers per network

# launches of each kernel in this module; a caller resets and reads it
KERNEL_LAUNCHES: Dict[str, int] = {"generic_step": 0}
# train steps run by those launches (one launch may run a group of steps)
KERNEL_STEPS: Dict[str, int] = {"generic_step": 0}


def envelope_gaps(cfg, model) -> list:
    """What keeps ``(cfg, model)`` outside the step's envelope, each with
    its ROADMAP item (empty inside it): the caps."""
    item = "(ROADMAP Queue 2 item 2)"
    out = []
    if not 2 <= len(model.modalities) <= MAX_MODS:
        out.append(f"{len(model.modalities)} modalities: the generic step "
                   f"takes 2 to {MAX_MODS} {item}")
    if cfg.method not in PORTED_METHODS:
        out.append(f"method={cfg.method!r}: not finished in the generic "
                   f"step {item}")
    if not 1 <= cfg.num_hidden_layer_encoder <= MAX_DEPTH:
        out.append(f"num_hidden_layer_encoder="
                   f"{cfg.num_hidden_layer_encoder}: the generic step takes "
                   f"1 to {MAX_DEPTH} {item}")
    if not 0 <= cfg.num_hidden_layer_decoder <= MAX_DEPTH:
        out.append(f"num_hidden_layer_decoder="
                   f"{cfg.num_hidden_layer_decoder}: the generic step takes "
                   f"0 to {MAX_DEPTH} {item}")
    return out


def supports_generic_fused(cfg, model, batch) -> bool:
    """The TPU kernel's eligibility (``multivae_tpu``
    ``supports_generic_fused`` less its VMEM guard) inside the port's
    envelope: every modality present."""
    names = [m.name for m in model.modalities]
    return all(n in batch for n in names) and not envelope_gaps(cfg, model)


def styled(model) -> Tuple[bool, ...]:
    """Per modality, whether it has style latents: a factorized
    representation and a style width > 0 (a stand-in that names its
    modalities alone has them)."""
    factorized = getattr(model, "factorized_representation", True)
    return tuple(bool(factorized) and getattr(m, "style_dim", 1) > 0
                 for m in model.modalities)


def generic_metric_names(model, method: str,
                         unimodal_elbos: bool = True) -> Tuple[str, ...]:
    """Scalar families per step in the TPU kernel's order: ``loss``, then
    the other keys of ``total_loss`` sorted. A modality without style
    latents has no style families, as there."""
    absent = {f"{k}/{m.name}_style"
              for m, has in zip(model.modalities, styled(model)) if not has
              for k in ("kld_style", "latent_mu", "latent_logvar")}
    names = [n for n in latent_multi.step_metric_names(
        [m.name for m in model.modalities], method, unimodal_elbos)
             if n not in absent]
    return ("loss",) + tuple(sorted(n for n in names if n != "loss"))


def n_dropout_masks(method: str, rate: float, n_enc: int, n_dec: int,
                    n_mods: int = 2, unimodal_elbos: bool = True) -> int:
    """Keep masks streamed per complete step: one per hidden layer of every
    network and pass."""
    if rate <= 0.0:
        return 0
    passes = 2 if latent_multi.with_unimodal_elbos(method,
                                                    unimodal_elbos) else 1
    return n_mods * (n_enc + n_dec) * passes


def multi_latents(method: str, dims: GenericDims,
                  unimodal_elbos: bool = True) -> bool:
    """Whether the step's latent math is the M-modality one
    (``latent_multi``): any M but 2, and poe without its unimodal ELBOs.
    At M = 2 the others keep the method step's."""
    return dims.m != 2 or (method == "poe" and not unimodal_elbos)


# ------------------------------------------------------------ plain version
class StackNets:
    """Layer stacks of any depth for any modality count as
    :func:`.fused_methods.latent_fwd_bwd` takes its networks, on the named
    tensors of the general layout; ``xs`` the modalities' batches in model
    order; ``g`` holds every tensor's gradient (forward and hand-derived
    backward, no autograd). ``masks [n_masks, B, hidden]`` or None, in the
    module's order."""

    def __init__(self, sp, xs, dims: GenericDims, learn_scale: bool,
                 masks=None):
        self.sp, self.xs, self.dims = sp, xs, dims
        self.b = float(dims.b)
        self.learn_scale = learn_scale
        self.masks = masks
        self.reencode = masks is not None
        self.g = {n: torch.zeros_like(v) for n, v in sp.items()}

    def _mask(self, p: int, dec: bool, e: int, i: int):
        if self.masks is None:
            return None
        m, n_enc, n_dec = self.dims.m, self.dims.n_enc, self.dims.n_dec
        idx = (p * m * (n_enc + n_dec) + (m * n_enc if dec else 0)
               + e * (n_dec if dec else n_enc) + i)
        return self.masks[idx]

    def _stack(self, net: str, depth: int, h, mask_of):
        """``relu(h W + b) [* mask]`` through ``depth`` layers:
        ``(output, [(activation, mask)])``."""
        acts = []
        for i in range(depth):
            h = torch.relu(h @ self.sp[f"{net}/hidden_{i}/kernel"]
                           + self.sp[f"{net}/hidden_{i}/bias"])
            m = mask_of(i)
            if m is not None:
                h = h * m
            acts.append((h, m))
        return h, acts

    def _stack_bwd(self, net: str, inp, acts, g_h):
        """Backward of :func:`_stack` from the output's gradient; returns
        the input's. Where a mask is 0 the unit's gradient is 0; elsewhere
        the activation's sign is the ReLU's mask."""
        for i in reversed(range(len(acts))):
            h, m = acts[i]
            g_h = g_h * (h > 0.0).float()
            if m is not None:
                g_h = g_h * m
            below = acts[i - 1][0] if i > 0 else inp
            self.g[f"{net}/hidden_{i}/kernel"] += below.T @ g_h
            self.g[f"{net}/hidden_{i}/bias"] += g_h.sum(0)
            g_h = g_h @ self.sp[f"{net}/hidden_{i}/kernel"].T
        return g_h

    def encode(self, e: int, p: int):
        net, x = f"enc{e + 1}", self.xs[e]
        h, acts = self._stack(net, self.dims.n_enc, x,
                              lambda i: self._mask(p, False, e, i))
        heads = h @ self.sp[f"{net}/heads/kernel"] + self.sp[
            f"{net}/heads/bias"]
        cd, s = self.dims.cd, self.dims.ss[e]
        return acts, (heads[:, :cd], heads[:, cd:2 * cd],
                      heads[:, 2 * cd:2 * cd + s], heads[:, 2 * cd + s:])

    def encode_bwd(self, e: int, acts, head_grads) -> None:
        net = f"enc{e + 1}"
        g_heads = torch.cat(head_grads, dim=1)
        self.g[f"{net}/heads/kernel"] += acts[-1][0].T @ g_heads
        self.g[f"{net}/heads/bias"] += g_heads.sum(0)
        # the first layer's input is the data: its gradient is not needed
        self._stack_bwd(net, self.xs[e], acts,
                        g_heads @ self.sp[f"{net}/heads/kernel"].T)

    def decode(self, e: int, p: int, zs, zc):
        net, x = f"dec{e + 1}", self.xs[e]
        d = x.shape[1]
        z = torch.cat([zs, zc], dim=1)
        h, acts = self._stack(net, self.dims.n_dec, z,
                              lambda i: self._mask(p, True, e, i))
        if self.dims.sample_scale:
            both = h @ self.sp[f"{net}/out_heads/kernel"] + self.sp[
                f"{net}/out_heads/bias"]
            loc, lv = both[:, :d], both[:, d:]
        else:
            loc = h @ self.sp[f"{net}/out_mu/kernel"] + self.sp[
                f"{net}/out_mu/bias"]
            lv = self.sp[f"{net}/out_logvar"]
        nll, g_out, g_lv = output_nll(self.dims.likelihood, x, loc, lv,
                                      self.b)
        return nll, (z, h, acts, g_out, g_lv)

    def decode_bwd(self, e: int, cache):
        net = f"dec{e + 1}"
        z, h, acts, g_out, g_lv = cache
        if self.dims.sample_scale:
            # one right-hand side [g_loc | g_lv] for the fused projection
            out, g_out = "out_heads", torch.cat([g_out, g_lv], dim=1)
        else:
            out = "out_mu"
            if self.learn_scale:
                self.g[f"{net}/out_logvar"] += g_lv.sum(0, keepdim=True)
        self.g[f"{net}/{out}/kernel"] += h.T @ g_out
        self.g[f"{net}/{out}/bias"] += g_out.sum(0)
        g_z = self._stack_bwd(net, z, acts,
                              g_out @ self.sp[f"{net}/{out}/kernel"].T)
        s = self.dims.ss[e]
        return g_z[:, :s], g_z[:, s:]


def softplus(v):
    """``log(1 + exp(v))`` in the form the kernel computes."""
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs()))


def output_nll(likelihood: str, x, loc, lv, b: float):
    """``(nll, g_loc, g_lv)`` of a decoder's output: the NLL of ``x`` summed
    over rows and features and divided by ``b``, and its gradients with
    respect to the location (the logits for bernoulli and categorical) and
    the log-variance ``lv`` (``[B, d]`` per sample or ``[1, d]`` per
    feature; ``g_lv`` is ``[B, d]`` either way). bernoulli and categorical
    have no scale: their ``g_lv`` is an exact zero."""
    if likelihood == "normal":
        r = x - loc
        iv = torch.exp(-lv)
        nll = torch.sum(0.5 * LOG2PI + 0.5 * lv
                        + 0.5 * torch.square(r) * iv) / b
        return nll, -r * iv / b, (0.5 - 0.5 * torch.square(r) * iv) / b
    zero = torch.zeros_like(x)
    if likelihood == "laplace":
        # log(2 scale) + |r| / scale with scale = exp(lv / 2); d|r|/dr is
        # +1 at r = 0, as jax.grad(jnp.abs) takes it
        r = x - loc
        isc = torch.exp(-0.5 * lv)
        a = r.abs() * isc
        nll = torch.sum(LOG2 + 0.5 * lv + a) / b
        return nll, -tie_sign(r) * isc / b, (0.5 - 0.5 * a) / b
    if likelihood == "bernoulli":
        nll = torch.sum(softplus(loc) - x * loc) / b
        return nll, (torch.sigmoid(loc) - x) / b, zero
    if likelihood == "categorical":
        ls = torch.log_softmax(loc, dim=1)
        nll = -torch.sum(x * ls) / b
        return nll, (torch.exp(ls) * x.sum(1, keepdim=True) - x) / b, zero
    raise ValueError(f"likelihood not implemented: {likelihood}")


def _check_masks(name: str, method: str, dims: GenericDims, masks,
                 unimodal_elbos: bool = True):
    want = n_dropout_masks(method, 1.0, dims.n_enc, dims.n_dec, dims.m,
                           unimodal_elbos)
    if masks is not None and tuple(masks.shape) != (want, dims.b, dims.h):
        raise ValueError(f"{name}: {method} at depths ({dims.n_enc}, "
                         f"{dims.n_dec}) takes dropout masks "
                         f"{(want, dims.b, dims.h)}, got "
                         f"{tuple(masks.shape)}")


def _check_sizes(name: str, method: str, dims: GenericDims) -> None:
    if method not in PORTED_METHODS:
        raise ValueError(f"unknown method {method!r}")
    if not 2 <= dims.m <= MAX_MODS or len(dims.ss) != dims.m:
        raise ValueError(f"{name} takes 2 to {MAX_MODS} modalities, each "
                         f"with a style width (ROADMAP Queue 2 item 2); got "
                         f"widths {dims.ds} and styles {dims.ss}")


def generic_fwd_bwd_reference(method: str, sp, xs, noise,
                              dims: GenericDims, consts: FusedConsts,
                              learn_scale: bool = True, dropout_masks=None,
                              *, unimodal_elbos: bool = True):
    """Plain PyTorch version of the kernel: ``(loss, metrics, grads)`` of
    ``total_loss`` of the model on a complete batch, forward and
    hand-derived backward in tensor ops; ``sp`` and ``grads`` are dicts of
    the general layout's tensors, ``xs`` the modalities' batches in model
    order, ``metrics`` in
    :func:`.latent_multi.step_metric_names` order."""
    _check_sizes("generic_fwd_bwd_reference", method, dims)
    _check_masks("generic_fwd_bwd_reference", method, dims, dropout_masks,
                 unimodal_elbos)
    nets = StackNets(sp, tuple(xs), dims, learn_scale, dropout_masks)
    if multi_latents(method, dims, unimodal_elbos):
        loss, metrics = latent_multi.latent_fwd_bwd(
            method, nets, noise, dims.b, dims.cd, dims.ss, consts,
            unimodal_elbos)
    else:
        loss, metrics = latent_fwd_bwd(method, nets, noise, dims.b, dims.cd,
                                       dims.s1, dims.s2, consts)
    return loss, metrics, nets.g


# ------------------------------------------------------------------ kernel
# The C arguments of ``generic_epoch_launch`` in order: (name, kind), kinds
# as in ``fused_step.EPOCH_ARGS`` plus ``ptrs`` (a tuple of addresses, one
# per modality) and ``i32s`` (a tuple of ints, one per modality).
EPOCH_ARGS = (
    ("params", "ptr"), ("mu", "ptr"), ("nu", "ptr"), ("grads", "ptr"),
    ("metrics", "ptr"), ("xs", "ptrs"), ("noise", "ptr"),
    ("masks", "ptr"), ("work", "ptr"),
    ("n", "i32"), ("method", "i32"), ("uni", "i32"), ("b", "i32"),
    ("m", "i32"), ("ds", "i32s"), ("h", "i32"), ("cd", "i32"),
    ("ss", "i32s"), ("n_enc", "i32"), ("n_dec", "i32"),
    ("sample_scale", "i32"), ("likelihood", "i32"), ("beta", "f32"),
    ("beta_style", "f32"), ("beta_content", "f32"),
    ("learn_scale", "i32"), ("count", "i64"),
    ("lr", "f32"), ("b1", "f32"), ("b2", "f32"), ("one_minus_b1", "f32"),
    ("one_minus_b2", "f32"), ("log_b1", "f32"), ("log_b2", "f32"),
    ("eps", "f32"),
    ("phase_times", "ptr"), ("stream", "ptr"),
)


def phases(dims: GenericDims) -> Tuple[str, ...]:
    """The phases of one step of the persistent kernel at these depths and
    likelihood, in order (``2 (n_enc + n_dec) + 6``, one more for
    categorical: its loss needs whole rows of logits); a launch given
    ``phase_times`` stamps the device's clock at the start of every step
    and after every phase's barrier."""
    n_enc, n_dec = dims.n_enc, dims.n_dec
    names = [f"enc {i}" for i in range(n_enc)] + ["heads", "latents"]
    names += [f"dec {j}" for j in range(n_dec)] + ["output"]
    if dims.likelihood == "categorical":
        names.append("output rows")
    names.append("output grads")
    names += [f"dec {j} grads" for j in range(n_dec - 1, 0, -1)]
    if n_dec > 0:
        names.append("z grads")
    names += ["latents backward", "heads grads"]
    names += [f"enc {i} grads" for i in range(n_enc - 1, 0, -1)]
    return tuple(names + ["enc 0 grads, biases + Adam"])


def pack_epoch_args(p, mu, nu, grads, metrics, xs, noise, masks, work,
                    method: str, dims: GenericDims, consts: FusedConsts,
                    learn_scale: bool, count: int, hyper: AdamHyper,
                    stream: int, phase_times=None,
                    unimodal_elbos: bool = True) -> tuple:
    """The arguments of ``generic_epoch_launch`` in :data:`EPOCH_ARGS`
    order (``masks`` None becomes a null pointer). Pure: it reads only
    addresses and shapes."""
    return (
        p.data_ptr(), mu.data_ptr(), nu.data_ptr(), grads.data_ptr(),
        metrics.data_ptr(), tuple(x.data_ptr() for x in xs),
        noise.data_ptr(), None if masks is None else masks.data_ptr(),
        work.data_ptr(), int(xs[0].shape[0]), METHODS.index(method),
        int(latent_multi.with_unimodal_elbos(method, unimodal_elbos)),
        dims.b, *_shape(dims), *(float(c) for c in consts),
        int(bool(learn_scale)), int(count), *adam_scalars(hyper),
        None if phase_times is None else phase_times.data_ptr(), int(stream))


# (m, ds, h, cd, ss, n_enc, n_dec, sample_scale, likelihood): the sizes the
# library's functions take after (method, uni, has_masks, b)
SHAPE_ARGS = ("i32", "i32s", "i32", "i32", "i32s", "i32", "i32", "i32",
              "i32")


def _generic_library():
    from ._build import load_kernel

    lib = load_kernel("generic_step")
    if lib.generic_step_launch.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        i64 = ctypes.c_longlong
        shape = argtypes_of([("", k) for k in SHAPE_ARGS])
        lead = [i32] * 4  # method, uni, has_masks, b
        lib.generic_step_launch.argtypes = (
            [ptr] * 3 + argtypes_of([("xs", "ptrs")])
            + [ptr, i32, ptr, i64, i32, ptr, i32, i32, i32] + shape
            + [f32] * 3 + [i32, ptr])
        lib.generic_step_launch.restype = i32
        lib.generic_epoch_launch.argtypes = argtypes_of(EPOCH_ARGS)
        lib.generic_epoch_launch.restype = i32
        lib.generic_step_workspace_floats.argtypes = lead + shape
        lib.generic_step_workspace_floats.restype = i64
        lib.generic_step_param_floats.argtypes = shape
        lib.generic_step_param_floats.restype = i64
        lib.generic_step_max_depth.argtypes = []
        lib.generic_step_max_depth.restype = i32
        lib.generic_step_max_mods.argtypes = []
        lib.generic_step_max_mods.restype = i32
        lib.generic_step_phases.argtypes = [i32] * 3
        lib.generic_step_phases.restype = i32
        lib.generic_step_barriers.argtypes = [i32] * 4
        lib.generic_step_barriers.restype = i32
        lib.generic_step_grid_blocks.argtypes = lead + shape
        lib.generic_step_grid_blocks.restype = i32
        lib.generic_step_tables_in_device_memory.argtypes = lead + shape
        lib.generic_step_tables_in_device_memory.restype = i32
        lib.generic_step_error_string.argtypes = [i32]
        lib.generic_step_error_string.restype = ctypes.c_char_p
    return lib


def _shape(dims: GenericDims) -> tuple:
    """The kernel's sizes (:data:`SHAPE_ARGS`): the modality count, the
    widths, the depths, the scale mode and the likelihood's index."""
    return (dims.m, tuple(dims.ds), dims.h, dims.cd, tuple(dims.ss),
            dims.n_enc, dims.n_dec, int(dims.sample_scale),
            LIKELIHOODS.index(dims.likelihood))


def _phase_sizes(dims: GenericDims) -> tuple:
    return dims.n_enc, dims.n_dec, LIKELIHOODS.index(dims.likelihood)


def _lead(method: str, has_masks: bool, dims: GenericDims,
          unimodal_elbos: bool) -> tuple:
    """(method, uni, has_masks, b): what the library's size functions take
    before :func:`_shape`."""
    return (METHODS.index(method),
            int(latent_multi.with_unimodal_elbos(method, unimodal_elbos)),
            int(bool(has_masks)), dims.b)


def _checked_library(p, dims: GenericDims):
    """The library, once the kernel's caps and layout agree with ``dims``
    and ``p`` (a size past a cap raises, naming its ROADMAP item)."""
    lib = _generic_library()
    item = "(ROADMAP Queue 2 item 2)"
    if max(dims.n_enc, dims.n_dec) > lib.generic_step_max_depth():
        raise ValueError(f"generic_step takes at most "
                         f"{lib.generic_step_max_depth()} hidden layers "
                         f"{item}")
    if dims.m > lib.generic_step_max_mods():
        raise ValueError(f"generic_step takes at most "
                         f"{lib.generic_step_max_mods()} modalities {item}")
    if lib.generic_step_param_floats(*_shape(dims)) != p.numel():
        raise ValueError("generic_step: the kernel's layout disagrees with "
                         "params.generic_shapes")
    if lib.generic_step_phases(*_phase_sizes(dims)) != len(phases(dims)):
        raise ValueError("generic_step: the kernel's phase list disagrees "
                         "with fused_generic.phases")
    return lib


def launch_geometry(dims: GenericDims, device, method: str,
                    has_masks: bool = False,
                    unimodal_elbos: bool = True) -> Dict[str, int]:
    """Of the persistent kernel at these sizes on ``device``: the blocks of
    its cooperative grid, its phases, the grid barriers of one step with
    and without the in-kernel Adam update, and whether its problem tables
    outgrow shared memory and live in device memory."""
    lib = _generic_library()
    args = _lead(method, has_masks, dims, unimodal_elbos) + _shape(dims)
    with torch.cuda.device(device):
        blocks = lib.generic_step_grid_blocks(*args)
    if blocks < 0:
        raise RuntimeError("generic_step: "
                           + lib.generic_step_error_string(-blocks).decode())
    sizes = _phase_sizes(dims)
    return {"grid_blocks": blocks,
            "phases": lib.generic_step_phases(*sizes),
            "barriers_per_step_adam": lib.generic_step_barriers(*sizes, 1),
            "barriers_per_step": lib.generic_step_barriers(*sizes, 0),
            "tables_in_device_memory":
                bool(lib.generic_step_tables_in_device_memory(*args))}


def _check_batches(name: str, device, xs, dims: GenericDims, lead=()):
    if len(xs) != dims.m:
        raise ValueError(f"{name}: {len(xs)} batches for {dims.m} "
                         f"modalities")
    for x, d in zip(xs, dims.ds):
        if lead:
            check_stack(name, device, x, lead + (dims.b, d))
        else:
            check_inputs(name, device, [(x, (dims.b, d))])
            if not x.is_contiguous():
                raise ValueError(f"{name} takes contiguous batches")


def _launch_generic(method: str, p, xs, noise, dims: GenericDims,
                    consts: FusedConsts, learn_scale: bool, masks, metrics,
                    grads, unimodal_elbos: bool) -> None:
    device = p.device
    b = dims.b
    n_metrics = latent_multi.n_step_metrics(dims.m, method, unimodal_elbos)
    width = latent_multi.noise_width(method, dims.cd, dims.ss,
                                     unimodal_elbos)
    check_inputs("generic_step", device, [
        (p, (flat_size(dims),)), (grads, (flat_size(dims),)),
        (metrics, (n_metrics,)), (noise, (b, width))])
    _check_batches("generic_step", device, xs, dims)
    _check_masks("generic_step", method, dims, masks, unimodal_elbos)
    mask_ptr, mask_stride, ld_mask = None, 0, 0
    if masks is not None:
        if (masks.device != device or masks.dtype != torch.float32
                or masks.stride(2) != 1):
            raise ValueError("generic_step takes float32 masks with "
                             "contiguous rows on the params' device")
        mask_ptr, mask_stride, ld_mask = (masks.data_ptr(), masks.stride(0),
                                          masks.stride(1))
    lib = _checked_library(p, dims)
    lead = _lead(method, masks is not None, dims, unimodal_elbos)
    work = workspace(lib, "generic_step", device, *lead, *_shape(dims))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.generic_step_launch(
            p.data_ptr(), grads.data_ptr(), metrics.data_ptr(),
            tuple(x.data_ptr() for x in xs), noise.data_ptr(),
            noise.stride(0), mask_ptr, mask_stride, ld_mask, work.data_ptr(),
            lead[0], lead[1], b, *_shape(dims), *(float(c) for c in consts),
            int(bool(learn_scale)), stream)
    if rc != 0:
        raise RuntimeError("generic_step launch failed: "
                           + lib.generic_step_error_string(rc).decode())
    KERNEL_LAUNCHES["generic_step"] += 1
    KERNEL_STEPS["generic_step"] += 1


def _check_epoch_stacks(p, xs, noise, masks, dims: GenericDims,
                        method: str, unimodal_elbos: bool) -> None:
    """The stacked inputs of a group of steps: contiguous float32 on the
    params' device, ``xs[e] [n, B, d_e]``, ``noise [n, B, w]``, ``masks [n,
    n_masks, B, hidden]`` or None."""
    n, b = int(xs[0].shape[0]), dims.b
    _check_batches("generic_step", p.device, xs, dims, (n,))
    width = latent_multi.noise_width(method, dims.cd, dims.ss,
                                     unimodal_elbos)
    check_stack("generic_step", p.device, noise, (n, b, width))
    if masks is not None:
        check_stack("generic_step", p.device, masks, (
            n, n_dropout_masks(method, 1.0, dims.n_enc, dims.n_dec, dims.m,
                               unimodal_elbos), b, dims.h))


def _launch_generic_epoch(method: str, p, mu, nu, count, xs, noise,
                          dims: GenericDims, consts: FusedConsts,
                          hyper: AdamHyper, learn_scale: bool, masks,
                          phase_times, unimodal_elbos: bool):
    """ONE launch for the whole group of steps (its stacks checked by the
    caller); returns ``metrics [n, n_metrics]`` in the step's order."""
    device = p.device
    n = int(xs[0].shape[0])
    check_inputs("generic_step", device, [
        (t, (flat_size(dims),)) for t in (p, mu, nu)])
    check_phase_times("generic_step", device, phase_times, n,
                      len(phases(dims)))
    metrics = torch.empty(
        n, latent_multi.n_step_metrics(dims.m, method, unimodal_elbos),
        dtype=torch.float32, device=device)
    if n == 0:
        return metrics
    grads = torch.empty_like(p)
    lib = _checked_library(p, dims)
    work = workspace(lib, "generic_step", device,
                     *_lead(method, masks is not None, dims, unimodal_elbos),
                     *_shape(dims))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.generic_epoch_launch(*pack_epoch_args(
            p, mu, nu, grads, metrics, xs, noise, masks, work, method, dims,
            consts, learn_scale, count, hyper, stream, phase_times,
            unimodal_elbos))
    if rc != 0:
        raise RuntimeError("generic_step epoch launch failed: "
                           + lib.generic_step_error_string(rc).decode())
    KERNEL_LAUNCHES["generic_step"] += 1
    KERNEL_STEPS["generic_step"] += n
    return metrics


def generic_step_flat(method: str, p, xs, noise, dims: GenericDims,
                      consts: FusedConsts, learn_scale: bool = True,
                      dropout_masks=None, *, unimodal_elbos: bool = True):
    """One step on a flat params buffer of the general layout, ``xs`` the
    modalities' batches in model order: ``(metrics, grads)``, ``grads`` a
    new flat buffer. The kernel for CUDA tensors, the plain version for CPU
    tensors."""
    _check_sizes("generic_step", method, dims)
    if p.device.type == "cuda":
        metrics = torch.empty(
            latent_multi.n_step_metrics(dims.m, method, unimodal_elbos),
            dtype=torch.float32, device=p.device)
        grads = torch.empty_like(p)
        _launch_generic(method, p, xs, noise, dims, consts, learn_scale,
                        dropout_masks, metrics, grads, unimodal_elbos)
        return metrics, grads
    if p.device.type == "cpu":
        _, metrics, g = generic_fwd_bwd_reference(
            method, flat_views(p, dims), xs, noise, dims, consts,
            learn_scale, dropout_masks, unimodal_elbos=unimodal_elbos)
        return metrics, flatten_named(g, dims)
    raise ValueError(f"generic_step: no kernel for {p.device}")


def metric_permutation(model, method: str, unimodal_elbos: bool = True):
    """Indices that take a step's metric vector to the order of
    :func:`generic_metric_names`."""
    step_names = latent_multi.step_metric_names(
        [m.name for m in model.modalities], method, unimodal_elbos)
    return [step_names.index(n)
            for n in generic_metric_names(model, method, unimodal_elbos)]


def generic_epoch_flat(method: str, p, mu, nu, count: int, xs, noise,
                       dims: GenericDims, consts: FusedConsts,
                       hyper: AdamHyper, learn_scale: bool = True,
                       masks=None, order=None, phase_times=None, *,
                       unimodal_elbos: bool = True):
    """``n`` steps on flat buffers, each followed by Adam at
    ``t = count + step + 1``; ``p``, ``mu`` and ``nu`` are updated in place.
    ``xs`` the modalities' stacks ``[n, B, d_e]`` in model order, ``noise
    [n, B, noise_width]``, ``masks [n, n_masks, B, hidden]`` or None.
    Returns ``metrics [n, n_metrics]`` on the buffers' device, the columns
    permuted by ``order`` (:func:`metric_permutation`) when given. On CUDA
    tensors the whole group is ONE launch of the persistent kernel (stacks
    contiguous float32 on the params' device, else it raises); on CPU
    tensors the host loops the plain step and the plain Adam.
    ``phase_times`` (tracing, the kernel only): an int64 ``[n,
    len(phases(dims)) + 1]`` tensor that takes the device's clock at the
    start of each step and after each phase."""
    _check_sizes("generic_step", method, dims)
    if p.device.type not in ("cuda", "cpu"):
        raise ValueError(f"generic_step: no kernel for {p.device}")
    _check_epoch_stacks(p, xs, noise, masks, dims, method, unimodal_elbos)
    if p.device.type == "cuda":
        out = _launch_generic_epoch(method, p, mu, nu, count, xs, noise,
                                    dims, consts, hyper, learn_scale, masks,
                                    phase_times, unimodal_elbos)
    else:
        if phase_times is not None:
            raise ValueError("generic_step: phase_times traces the kernel; "
                             "the plain version has no phases")
        steps = []
        for i in range(noise.shape[0]):
            metrics, grads = generic_step_flat(
                method, p, [x[i] for x in xs], noise[i], dims, consts,
                learn_scale, None if masks is None else masks[i],
                unimodal_elbos=unimodal_elbos)
            adam_update(p, mu, nu, grads, count + i + 1, hyper)
            steps.append(metrics)
        out = torch.stack(steps)
    if order is not None:
        out = out[:, torch.as_tensor(order, device=out.device)]
    return out
