"""Train steps of complete batches for architectures outside the split
layout: a hand-written CUDA layer-stack kernel and its plain PyTorch version.

Counterpart of ``multivae_tpu/ops/fused_generic.py``. The TPU kernel
(``make_generic_fused_epoch``) traces ``jax.value_and_grad`` of the real
``model.apply`` + ``total_loss`` into its body, for any architecture. CUDA
cannot trace a model into a kernel, so the port writes the step by hand
with the depths as arguments: :func:`generic_fwd_bwd_reference` (plain) and
``csrc/generic_step.cu`` (kernel) compute the loss of one full complete
batch, its metric families and the gradient of every parameter, for
encoders of ``n_enc >= 1`` hidden layers, decoders of ``n_dec >= 0`` hidden
layers, each output-scale mode (a learned or a frozen per-feature
``out_logvar``, or the per-sample ``out_heads`` projection to
``loc | logvar``) and each likelihood of ``LIKELIHOODS`` (:func:`output_nll`;
bernoulli and categorical read the location as logits and leave the
log-variance an exact zero gradient). A style width of 0 is a modality
without style latents: the unfactorized latent has no style heads, noise or
KL, and its decoders read the content latent alone. Between the stacks
stands the method's latent math, which is the method step's
(:func:`.fused_methods.latent_fwd_bwd`, ``csrc/latent_common.cuh``). The
kernel is persistent: on CUDA tensors :func:`generic_epoch_flat` runs a
whole group of steps with Adam inside in ONE cooperative launch (the TPU
kernel's epoch contract), and one step is the same kernel with ``n = 1``
and Adam off.

The envelope (:func:`supports_generic_fused`): two modalities, every
modality present, the methods of ``PORTED_METHODS`` (poe with its unimodal
ELBOs) and 1-4 / 0-4 hidden layers. The TPU kernel also serves other
modality counts and deeper stacks; those raise ``NotImplementedError`` in
the trainer.

Params, gradients and the Adam moments are flat buffers in the general
layout (:func:`multivae_tpu_torch.params.generic_shapes`).

Noise ``[B, noise_width]``: ``cd | s1 | s2``; poe appends the unimodal draws
``cd | s1`` and ``cd | s2`` (a style width of 0 has no columns). Dropout masks
are pre-scaled keep masks ``[n_masks, B, hidden]`` (values in
``{0, 1 / (1 - rate)}``), one per hidden layer and pass, multiplied in after
the ReLU, in this order: the main pass's encoder 1 layers ``0 .. n_enc - 1``, encoder 2 layers,
decoder 1 layers ``0 .. n_dec - 1``, decoder 2 layers; then for poe the
unimodal re-runs' masks in the same order (``2 (n_enc + n_dec)`` masks per
pass). Under dropout poe's unimodal ELBOs re-encode and decode with their own
masks; without it they reuse the main pass's encodings and decode their own
latents.

A step's metric vector is in the order of
:func:`.fused_methods.method_metric_names` (the shared metrics kernel's; a
style family without style latents holds 0); :func:`generic_epoch_flat`
returns the rows of :func:`generic_metric_names`, the TPU kernel's
(``loss``, then the other families ``total_loss`` emits, sorted by name).
On CUDA tensors a step launches the kernel, on CPU tensors it runs the
plain version; a kernel that does not build or launch raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from ..params import GenericDims, flat_size, flat_views, flatten_named
from .adam import AdamHyper, adam_scalars, adam_update
from .fused_methods import (
    METHODS,
    latent_fwd_bwd,
    method_metric_names,
    n_method_metrics,
    step_noise_width,
)
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
MAX_DEPTH = 4  # hidden layers per network (kMaxDepth of generic_step.cu)

# launches of each kernel in this module; a caller resets and reads it
KERNEL_LAUNCHES: Dict[str, int] = {"generic_step": 0}
# train steps run by those launches (one launch may run a group of steps)
KERNEL_STEPS: Dict[str, int] = {"generic_step": 0}


def envelope_gaps(cfg, model) -> list:
    """What keeps ``(cfg, model)`` outside the step's envelope, each with
    its ROADMAP item (empty inside it)."""
    item = "(ROADMAP Queue 2 item 2)"
    out = []
    if len(model.modalities) != 2:
        out.append(f"{len(model.modalities)} modalities: the generic step "
                   f"for a modality count other than 2 {item}")
    if cfg.method not in PORTED_METHODS:
        out.append(f"method={cfg.method!r}: not finished in the generic "
                   f"step {item}")
    if cfg.method == "poe" and not cfg.poe_unimodal_elbos:
        out.append(f"poe without its unimodal ELBOs in the generic step "
                   f"{item}")
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


def generic_metric_names(model, method: str) -> Tuple[str, ...]:
    """Scalar families per step in the TPU kernel's order: ``loss``, then
    the other keys of ``total_loss`` sorted. A modality without style
    latents has no style families, as there."""
    absent = {f"{k}/{m.name}_style"
              for m, has in zip(model.modalities, styled(model)) if not has
              for k in ("kld_style", "latent_mu", "latent_logvar")}
    names = [n for n in method_metric_names(model, method)
             if n not in absent]
    return ("loss",) + tuple(sorted(n for n in names if n != "loss"))


def n_dropout_masks(method: str, rate: float, n_enc: int, n_dec: int) -> int:
    """Keep masks streamed per complete step: one per hidden layer of every
    network and pass."""
    if rate <= 0.0:
        return 0
    return 2 * (n_enc + n_dec) * (2 if method == "poe" else 1)


# ------------------------------------------------------------ plain version
class StackNets:
    """Layer stacks of any depth as :func:`.fused_methods.latent_fwd_bwd`
    takes its networks, on the named tensors of the general layout; ``g``
    holds every tensor's gradient (forward and hand-derived backward, no
    autograd). ``masks [n_masks, B, hidden]`` or None, in the module's
    order."""

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
        n_enc, n_dec = self.dims.n_enc, self.dims.n_dec
        idx = (p * 2 * (n_enc + n_dec) + (2 * n_enc if dec else 0)
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
        cd = self.dims.cd
        s = (self.dims.s1, self.dims.s2)[e]
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
        s = (self.dims.s1, self.dims.s2)[e]
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


def _check_masks(name: str, method: str, dims: GenericDims, masks):
    want = 2 * (dims.n_enc + dims.n_dec) * (2 if method == "poe" else 1)
    if masks is not None and tuple(masks.shape) != (want, dims.b, dims.h):
        raise ValueError(f"{name}: {method} at depths ({dims.n_enc}, "
                         f"{dims.n_dec}) takes dropout masks "
                         f"{(want, dims.b, dims.h)}, got "
                         f"{tuple(masks.shape)}")


def generic_fwd_bwd_reference(method: str, sp, x1, x2, noise,
                              dims: GenericDims, consts: FusedConsts,
                              learn_scale: bool = True, dropout_masks=None):
    """Plain PyTorch version of the kernel: ``(loss, metrics[17 | 19],
    grads)`` of ``total_loss`` of the model on a complete batch, forward
    and hand-derived backward in tensor ops; ``sp`` and ``grads`` are dicts
    of the general layout's tensors."""
    if method not in PORTED_METHODS:
        raise ValueError(f"unknown method {method!r}")
    _check_masks("generic_fwd_bwd_reference", method, dims, dropout_masks)
    nets = StackNets(sp, (x1, x2), dims, learn_scale, dropout_masks)
    loss, metrics = latent_fwd_bwd(method, nets, noise, dims.b, dims.cd,
                                   dims.s1, dims.s2, consts)
    return loss, metrics, nets.g


# ------------------------------------------------------------------ kernel
# The C arguments of ``generic_epoch_launch`` in order: (name, kind), kinds
# as in ``fused_step.EPOCH_ARGS``.
EPOCH_ARGS = (
    ("params", "ptr"), ("mu", "ptr"), ("nu", "ptr"), ("grads", "ptr"),
    ("metrics", "ptr"), ("x1s", "ptr"), ("x2s", "ptr"), ("noise", "ptr"),
    ("masks", "ptr"), ("work", "ptr"),
    ("n", "i32"), ("method", "i32"), ("b", "i32"), ("d1", "i32"),
    ("d2", "i32"), ("h", "i32"), ("cd", "i32"), ("s1", "i32"), ("s2", "i32"),
    ("n_enc", "i32"), ("n_dec", "i32"), ("sample_scale", "i32"),
    ("likelihood", "i32"), ("beta", "f32"), ("beta_style", "f32"),
    ("beta_content", "f32"),
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


def pack_epoch_args(p, mu, nu, grads, metrics, x1s, x2s, noise, masks, work,
                    method: str, dims: GenericDims, consts: FusedConsts,
                    learn_scale: bool, count: int, hyper: AdamHyper,
                    stream: int, phase_times=None) -> tuple:
    """The arguments of ``generic_epoch_launch`` in :data:`EPOCH_ARGS`
    order (``masks`` None becomes a null pointer). Pure: it reads only
    addresses and shapes."""
    return (
        p.data_ptr(), mu.data_ptr(), nu.data_ptr(), grads.data_ptr(),
        metrics.data_ptr(), x1s.data_ptr(), x2s.data_ptr(),
        noise.data_ptr(), None if masks is None else masks.data_ptr(),
        work.data_ptr(), int(x1s.shape[0]), METHODS.index(method), dims.b,
        dims.d1, dims.d2, dims.h, dims.cd, dims.s1, dims.s2, dims.n_enc,
        dims.n_dec, int(dims.sample_scale),
        LIKELIHOODS.index(dims.likelihood), *(float(c) for c in consts),
        int(bool(learn_scale)), int(count), *adam_scalars(hyper),
        None if phase_times is None else phase_times.data_ptr(), int(stream))


def _generic_library():
    from ._build import load_kernel

    lib = load_kernel("generic_step")
    if lib.generic_step_launch.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        i64 = ctypes.c_longlong
        lib.generic_step_launch.argtypes = (
            [ptr] * 6 + [i32, ptr, i64, i32, ptr] + [i32] * 12 + [f32] * 3
            + [i32, ptr])
        lib.generic_step_launch.restype = i32
        lib.generic_epoch_launch.argtypes = argtypes_of(EPOCH_ARGS)
        lib.generic_epoch_launch.restype = i32
        lib.generic_step_workspace_floats.argtypes = [i32] * 13
        lib.generic_step_workspace_floats.restype = i64
        lib.generic_step_param_floats.argtypes = [i32] * 10
        lib.generic_step_param_floats.restype = i64
        lib.generic_step_max_depth.argtypes = []
        lib.generic_step_max_depth.restype = i32
        lib.generic_step_phases.argtypes = [i32] * 3
        lib.generic_step_phases.restype = i32
        lib.generic_step_barriers.argtypes = [i32] * 4
        lib.generic_step_barriers.restype = i32
        lib.generic_step_grid_blocks.argtypes = [i32] * 13
        lib.generic_step_grid_blocks.restype = i32
        lib.generic_step_error_string.argtypes = [i32]
        lib.generic_step_error_string.restype = ctypes.c_char_p
    return lib


def _shape(dims: GenericDims) -> tuple:
    """The kernel's sizes: widths, depths, scale mode, likelihood index."""
    return (dims.d1, dims.d2, dims.h, dims.cd, dims.s1, dims.s2,
            dims.n_enc, dims.n_dec, int(dims.sample_scale),
            LIKELIHOODS.index(dims.likelihood))


def _phase_sizes(dims: GenericDims) -> tuple:
    return dims.n_enc, dims.n_dec, LIKELIHOODS.index(dims.likelihood)


def _checked_library(p, dims: GenericDims):
    """The library, once the kernel's depth limit and layout agree with
    ``dims`` and ``p``."""
    lib = _generic_library()
    if max(dims.n_enc, dims.n_dec) > lib.generic_step_max_depth():
        raise ValueError(f"generic_step takes at most "
                         f"{lib.generic_step_max_depth()} hidden layers")
    if lib.generic_step_param_floats(*_shape(dims)) != p.numel():
        raise ValueError("generic_step: the kernel's layout disagrees with "
                         "params.generic_shapes")
    if lib.generic_step_phases(*_phase_sizes(dims)) != len(phases(dims)):
        raise ValueError("generic_step: the kernel's phase list disagrees "
                         "with fused_generic.phases")
    return lib


def launch_geometry(dims: GenericDims, device, method: str,
                    has_masks: bool = False) -> Dict[str, int]:
    """Of the persistent kernel at these sizes on ``device``: the blocks of
    its cooperative grid, its phases and the grid barriers of one step with
    and without the in-kernel Adam update."""
    lib = _generic_library()
    with torch.cuda.device(device):
        blocks = lib.generic_step_grid_blocks(
            METHODS.index(method), int(has_masks), dims.b, *_shape(dims))
    if blocks < 0:
        raise RuntimeError("generic_step: "
                           + lib.generic_step_error_string(-blocks).decode())
    sizes = _phase_sizes(dims)
    return {"grid_blocks": blocks,
            "phases": lib.generic_step_phases(*sizes),
            "barriers_per_step_adam": lib.generic_step_barriers(*sizes, 1),
            "barriers_per_step": lib.generic_step_barriers(*sizes, 0)}


def _launch_generic(method: str, p, x1, x2, noise, dims: GenericDims,
                    consts: FusedConsts, learn_scale: bool, masks, metrics,
                    grads) -> None:
    device = p.device
    b = dims.b
    check_inputs("generic_step", device, [
        (p, (flat_size(dims),)), (grads, (flat_size(dims),)),
        (metrics, (n_method_metrics(method),)),
        (x1, (b, dims.d1)), (x2, (b, dims.d2)),
        (noise, (b, step_noise_width(method, dims)))])
    for t in (x1, x2):
        if not t.is_contiguous():
            raise ValueError("generic_step takes contiguous batches")
    _check_masks("generic_step", method, dims, masks)
    mask_ptr, mask_stride, ld_mask = None, 0, 0
    if masks is not None:
        if (masks.device != device or masks.dtype != torch.float32
                or masks.stride(2) != 1):
            raise ValueError("generic_step takes float32 masks with "
                             "contiguous rows on the params' device")
        mask_ptr, mask_stride, ld_mask = (masks.data_ptr(), masks.stride(0),
                                          masks.stride(1))
    lib = _checked_library(p, dims)
    shape = _shape(dims)
    method_idx = METHODS.index(method)
    work = workspace(lib, "generic_step", device, method_idx,
                     int(masks is not None), b, *shape)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.generic_step_launch(
            p.data_ptr(), grads.data_ptr(), metrics.data_ptr(),
            x1.data_ptr(), x2.data_ptr(), noise.data_ptr(), noise.stride(0),
            mask_ptr, mask_stride, ld_mask, work.data_ptr(), method_idx, b,
            *shape, *(float(c) for c in consts), int(bool(learn_scale)),
            stream)
    if rc != 0:
        raise RuntimeError("generic_step launch failed: "
                           + lib.generic_step_error_string(rc).decode())
    KERNEL_LAUNCHES["generic_step"] += 1
    KERNEL_STEPS["generic_step"] += 1


def _check_epoch_stacks(p, x1s, x2s, noise, masks, dims: GenericDims,
                        method: str) -> None:
    """The stacked inputs of a group of steps: contiguous float32 on the
    params' device, ``x1s [n, B, d1]``, ``x2s [n, B, d2]``, ``noise [n, B,
    w]``, ``masks [n, n_masks, B, hidden]`` or None."""
    n, b = int(x1s.shape[0]), dims.b
    check_stack("generic_step", p.device, x1s, (n, b, dims.d1))
    check_stack("generic_step", p.device, x2s, (n, b, dims.d2))
    check_stack("generic_step", p.device, noise,
                (n, b, step_noise_width(method, dims)))
    if masks is not None:
        check_stack("generic_step", p.device, masks, (
            n, n_dropout_masks(method, 1.0, dims.n_enc, dims.n_dec), b,
            dims.h))


def _launch_generic_epoch(method: str, p, mu, nu, count, x1s, x2s, noise,
                          dims: GenericDims, consts: FusedConsts,
                          hyper: AdamHyper, learn_scale: bool, masks,
                          phase_times=None):
    """ONE launch for the whole group of steps (its stacks checked by the
    caller); returns ``metrics [n, 17 | 19]`` in the step's order."""
    device = p.device
    n, b = int(x1s.shape[0]), dims.b
    check_inputs("generic_step", device, [
        (t, (flat_size(dims),)) for t in (p, mu, nu)])
    check_phase_times("generic_step", device, phase_times, n,
                      len(phases(dims)))
    metrics = torch.empty(n, n_method_metrics(method), dtype=torch.float32,
                          device=device)
    if n == 0:
        return metrics
    grads = torch.empty_like(p)
    lib = _checked_library(p, dims)
    work = workspace(lib, "generic_step", device, METHODS.index(method),
                     int(masks is not None), b, *_shape(dims))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.generic_epoch_launch(*pack_epoch_args(
            p, mu, nu, grads, metrics, x1s, x2s, noise, masks, work, method,
            dims, consts, learn_scale, count, hyper, stream, phase_times))
    if rc != 0:
        raise RuntimeError("generic_step epoch launch failed: "
                           + lib.generic_step_error_string(rc).decode())
    KERNEL_LAUNCHES["generic_step"] += 1
    KERNEL_STEPS["generic_step"] += n
    return metrics


def generic_step_flat(method: str, p, x1, x2, noise, dims: GenericDims,
                      consts: FusedConsts, learn_scale: bool = True,
                      dropout_masks=None):
    """One step on a flat params buffer of the general layout:
    ``(metrics[17 | 19], grads)``, ``grads`` a new flat buffer. The kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if method not in PORTED_METHODS:
        raise ValueError(f"unknown method {method!r}")
    if p.device.type == "cuda":
        metrics = torch.empty(n_method_metrics(method), dtype=torch.float32,
                              device=p.device)
        grads = torch.empty_like(p)
        _launch_generic(method, p, x1, x2, noise, dims, consts, learn_scale,
                        dropout_masks, metrics, grads)
        return metrics, grads
    if p.device.type == "cpu":
        _, metrics, g = generic_fwd_bwd_reference(
            method, flat_views(p, dims), x1, x2, noise, dims, consts,
            learn_scale, dropout_masks)
        return metrics, flatten_named(g, dims)
    raise ValueError(f"generic_step: no kernel for {p.device}")


def metric_permutation(model, method: str):
    """Indices that take a step's metric vector to the order of
    :func:`generic_metric_names`."""
    step_names = method_metric_names(model, method)
    return [step_names.index(n) for n in generic_metric_names(model, method)]


def generic_epoch_flat(method: str, p, mu, nu, count: int, x1s, x2s, noise,
                       dims: GenericDims, consts: FusedConsts,
                       hyper: AdamHyper, learn_scale: bool = True,
                       masks=None, order=None, phase_times=None):
    """``n`` steps on flat buffers, each followed by Adam at
    ``t = count + step + 1``; ``p``, ``mu`` and ``nu`` are updated in place.
    ``noise [n, B, noise_width]``, ``masks [n, n_masks, B, hidden]`` or
    None. Returns ``metrics [n, 17 | 19]`` on the buffers' device, the
    columns permuted by ``order`` (:func:`metric_permutation`) when given.
    On CUDA tensors the whole group is ONE launch of the persistent kernel
    (stacks contiguous float32 on the params' device, else it raises); on
    CPU tensors the host loops the plain step and the plain Adam.
    ``phase_times`` (tracing, the kernel only): an int64 ``[n,
    len(phases(dims)) + 1]`` tensor that takes the device's clock at the
    start of each step and after each phase."""
    if method not in PORTED_METHODS:
        raise ValueError(f"unknown method {method!r}")
    if p.device.type not in ("cuda", "cpu"):
        raise ValueError(f"generic_step: no kernel for {p.device}")
    _check_epoch_stacks(p, x1s, x2s, noise, masks, dims, method)
    if p.device.type == "cuda":
        out = _launch_generic_epoch(method, p, mu, nu, count, x1s, x2s,
                                    noise, dims, consts, hyper, learn_scale,
                                    masks, phase_times)
    else:
        if phase_times is not None:
            raise ValueError("generic_step: phase_times traces the kernel; "
                             "the plain version has no phases")
        steps = []
        for i in range(x1s.shape[0]):
            metrics, grads = generic_step_flat(
                method, p, x1s[i], x2s[i], noise[i], dims, consts,
                learn_scale, None if masks is None else masks[i])
            adam_update(p, mu, nu, grads, count + i + 1, hyper)
            steps.append(metrics)
        out = torch.stack(steps)
    if order is not None:
        out = out[:, torch.as_tensor(order, device=out.device)]
    return out
