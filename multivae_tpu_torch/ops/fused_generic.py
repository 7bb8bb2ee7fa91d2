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
layers and each output-scale mode (a learned or a frozen per-feature
``out_logvar``, or the per-sample ``out_heads`` projection to
``loc | logvar``). Between the stacks stands the method's latent math, which
is the method step's (:func:`.fused_methods.latent_fwd_bwd`,
``csrc/latent_common.cuh``). The epoch loop stays on the host: one step
launch chain and one ``csrc/flat_adam.cu`` launch per step.

The envelope (:func:`supports_generic_fused`): two modalities, a factorized
representation with both style dims > 0, the normal likelihood, every
modality present, and the methods of ``PORTED_METHODS``. The TPU kernel
also serves the other likelihoods, an unfactorized latent and other
modality counts; those raise ``NotImplementedError`` in the trainer.

Params, gradients and the Adam moments are flat buffers in the general
layout (:func:`multivae_tpu_torch.params.generic_shapes`).

Noise ``[B, noise_width]``: ``cd | s1 | s2``; poe appends the unimodal draws
``cd | s1`` and ``cd | s2``. Dropout masks are pre-scaled keep masks
``[n_masks, B, hidden]`` (values in ``{0, 1 / (1 - rate)}``), one per hidden
layer and pass, multiplied in after the ReLU, in this order: the main pass's
encoder 1 layers ``0 .. n_enc - 1``, encoder 2 layers, decoder 1 layers
``0 .. n_dec - 1``, decoder 2 layers; then for poe the unimodal re-runs'
masks in the same order (``2 (n_enc + n_dec)`` masks per pass). Under
dropout poe's unimodal ELBOs re-encode and decode with their own masks;
without it they reuse the main pass's encodings and decode their own
latents.

A step's metric vector is in the order of
:func:`.fused_methods.method_metric_names` (the shared metrics kernel's);
:func:`generic_epoch_flat` returns the rows in the order of
:func:`generic_metric_names`, the TPU kernel's (``loss``, then the other
families sorted by name). On CUDA tensors a step launches the kernel, on CPU
tensors it runs the plain version; a kernel that does not build or launch
raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..params import GenericDims, flat_size, flat_views, flatten_named
from .adam import AdamHyper, adam_update
from .fused_methods import (
    METHODS,
    latent_fwd_bwd,
    method_metric_names,
    n_method_metrics,
)
from .fused_step import LOG2PI, FusedConsts, check_inputs, workspace

PORTED_METHODS = METHODS
MAX_DEPTH = 4  # hidden layers per network (kMaxDepth of generic_step.cu)

# launches of each kernel in this module; a caller resets and reads it
KERNEL_LAUNCHES: Dict[str, int] = {"generic_step": 0}


def envelope_gaps(cfg, model) -> list:
    """What keeps ``(cfg, model)`` outside the step's envelope, each with
    its ROADMAP item (empty inside it)."""
    item = "(ROADMAP Queue 2 item 2)"
    out = []
    if len(model.modalities) != 2:
        out.append(f"{len(model.modalities)} modalities: the generic step "
                   f"for a modality count other than 2 {item}")
    if cfg.likelihood != "normal":
        out.append(f"likelihood={cfg.likelihood!r}: the generic step's "
                   f"other likelihoods {item}")
    if not (cfg.factorized_representation
            and all(m.style_dim > 0 for m in model.modalities)):
        out.append(f"an unfactorized latent: the generic step without "
                   f"style latents {item}")
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


def generic_metric_names(model, method: str) -> Tuple[str, ...]:
    """Scalar families per step in the TPU kernel's order: ``loss``, then
    the other keys of ``total_loss`` sorted."""
    names = method_metric_names(model, method)
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
        r = x - loc
        iv = torch.exp(-lv)
        nll = torch.sum(0.5 * LOG2PI + 0.5 * lv
                        + 0.5 * torch.square(r) * iv) / self.b
        return nll, (z, h, acts, r, iv)

    def decode_bwd(self, e: int, cache):
        net = f"dec{e + 1}"
        z, h, acts, r, iv = cache
        g_out = -r * iv / self.b
        g_lv = (0.5 - 0.5 * torch.square(r) * iv) / self.b
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
def _generic_library():
    from ._build import load_kernel

    lib = load_kernel("generic_step")
    if lib.generic_step_launch.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        i64 = ctypes.c_longlong
        lib.generic_step_launch.argtypes = (
            [ptr] * 6 + [i32, ptr, i64, i32, ptr] + [i32] * 11 + [f32] * 3
            + [i32, ptr])
        lib.generic_step_launch.restype = i32
        lib.generic_step_workspace_floats.argtypes = [i32] * 12
        lib.generic_step_workspace_floats.restype = i64
        lib.generic_step_param_floats.argtypes = [i32] * 9
        lib.generic_step_param_floats.restype = i64
        lib.generic_step_max_depth.argtypes = []
        lib.generic_step_max_depth.restype = i32
        lib.generic_step_error_string.argtypes = [i32]
        lib.generic_step_error_string.restype = ctypes.c_char_p
    return lib


def _launch_generic(method: str, p, x1, x2, noise, dims: GenericDims,
                    consts: FusedConsts, learn_scale: bool, masks, metrics,
                    grads) -> None:
    device = p.device
    b = dims.b
    width = dims.cd + dims.s1 + dims.s2
    if method == "poe":
        width += 2 * dims.cd + dims.s1 + dims.s2
    check_inputs("generic_step", device, [
        (p, (flat_size(dims),)), (grads, (flat_size(dims),)),
        (metrics, (n_method_metrics(method),)),
        (x1, (b, dims.d1)), (x2, (b, dims.d2)), (noise, (b, width))])
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
    lib = _generic_library()
    shape = (dims.d1, dims.d2, dims.h, dims.cd, dims.s1, dims.s2,
             dims.n_enc, dims.n_dec, int(dims.sample_scale))
    if max(dims.n_enc, dims.n_dec) > lib.generic_step_max_depth():
        raise ValueError(f"generic_step takes at most "
                         f"{lib.generic_step_max_depth()} hidden layers")
    if lib.generic_step_param_floats(*shape) != p.numel():
        raise ValueError("generic_step: the kernel's layout disagrees with "
                         "params.generic_shapes")
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
                       masks=None, order=None):
    """``n`` steps on flat buffers, each followed by Adam at
    ``t = count + step + 1``; ``p``, ``mu`` and ``nu`` are updated in place.
    ``noise [n, B, noise_width]``, ``masks [n, n_masks, B, hidden]`` or
    None. Returns ``metrics [n, 17 | 19]`` on the buffers' device, the
    columns permuted by ``order`` (:func:`metric_permutation`) when
    given."""
    steps = []
    for i in range(x1s.shape[0]):
        metrics, grads = generic_step_flat(
            method, p, x1s[i], x2s[i], noise[i], dims, consts, learn_scale,
            None if masks is None else masks[i])
        adam_update(p, mu, nu, grads, count + i + 1, hyper)
        steps.append(metrics)
    out = torch.stack(steps)
    if order is not None:
        out = out[:, torch.as_tensor(order, device=out.device)]
    return out
