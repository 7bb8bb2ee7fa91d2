"""Flat Adam over the train state: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``multivae_tpu/train/train_step.py:26-63`` (``FlatAdamState``,
``flat_adam``) and of the Adam bodies of the TPU epoch kernels
(``ops/fused_step.py:615-626``, ``ops/fused_presence.py:287-297``). The
state is ``(count, mu, nu)`` with ``mu`` and ``nu`` flat float32 buffers in
the split layout (:func:`multivae_tpu_torch.params.flat_views`), beside a
flat params buffer of the same layout. :func:`adam_update` updates params,
``mu`` and ``nu`` in place (the JAX package returns new arrays; the port
keeps one set of buffers). On a CUDA tensor it launches
``csrc/flat_adam.cu``, on a CPU tensor it runs :func:`adam_update_reference`;
a kernel that does not build or launch raises. The element update itself is
``csrc/adam_common.cuh``: the persistent step kernels (``mopoe_step.cu``,
``method_step.cu``, ``presence_step.cu``, ``generic_step.cu``) run the same
body as the last phase of every step of a launch, so an epoch through them
launches no ``flat_adam`` and ends with the same bits.

The bias correction is the TPU kernels' ``1 - exp(t log b)``, for the
general step too (``flat_adam`` writes ``1 - b ** t``, the same number to a
float32 rounding).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple

import torch

# launches of each kernel in this module; a caller resets and reads it
KERNEL_LAUNCHES: Dict[str, int] = {"flat_adam": 0}

ADAM_EPS = 1e-8


class AdamState(NamedTuple):
    """Adam's step count and moments (``FlatAdamState`` of the JAX package,
    in the split layout)."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


class AdamHyper(NamedTuple):
    lr: float
    b1: float
    b2: float
    eps: float = ADAM_EPS


def adam_hyper(cfg) -> AdamHyper:
    """Adam's hyperparameters of a config (``experiment.py:267-271``)."""
    return AdamHyper(cfg.initial_learning_rate, cfg.beta_1, cfg.beta_2)


def init_adam_state(params: torch.Tensor) -> AdamState:
    """Zero moments beside a flat params buffer."""
    return AdamState(0, torch.zeros_like(params), torch.zeros_like(params))


@torch.no_grad()
def adam_update_reference(p, mu, nu, g, t: int, hyper: AdamHyper) -> None:
    """Plain PyTorch version of the kernel: one Adam update at step ``t``
    (``count + step + 1``), in place."""
    lr, b1, b2, eps = hyper
    tt = torch.tensor(float(t), dtype=torch.float32, device=p.device)
    bc1 = 1.0 - torch.exp(tt * math.log(b1))
    bc2 = 1.0 - torch.exp(tt * math.log(b2))
    mu.copy_(b1 * mu + (1.0 - b1) * g)
    nu.copy_(b2 * nu + (1.0 - b2) * torch.square(g))
    p.copy_(p - lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps))


def adam_scalars(hyper: AdamHyper):
    """The eight scalars the kernels take, in their argument order: ``lr,
    b1, b2, 1 - b1, 1 - b2, log b1, log b2, eps`` (Python floats; ctypes
    rounds each to float32 once, as the TPU kernels' constants are)."""
    lr, b1, b2, eps = hyper
    return (lr, b1, b2, 1.0 - b1, 1.0 - b2, math.log(b1), math.log(b2), eps)


def _adam_library():
    from ._build import load_kernel

    lib = load_kernel("flat_adam")
    if lib.flat_adam_launch.argtypes is None:
        ptr, f32 = ctypes.c_void_p, ctypes.c_float
        lib.flat_adam_launch.argtypes = (
            [ptr] * 4 + [ctypes.c_longlong, ctypes.c_longlong]
            + [f32] * 8 + [ptr])
        lib.flat_adam_launch.restype = ctypes.c_int
        lib.flat_adam_error_string.argtypes = [ctypes.c_int]
        lib.flat_adam_error_string.restype = ctypes.c_char_p
    return lib


def _launch_adam(p, mu, nu, g, t: int, hyper: AdamHyper) -> None:
    for x in (p, mu, nu, g):
        if x.device != p.device:
            raise ValueError(f"flat_adam: a buffer is on {x.device}, the "
                             f"params on {p.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"flat_adam takes float32, got {x.dtype}")
        if x.dim() != 1 or x.numel() != p.numel():
            raise ValueError(f"flat_adam takes flat buffers of "
                             f"{p.numel()} floats, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("flat_adam takes contiguous buffers")
    lib = _adam_library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = lib.flat_adam_launch(
            p.data_ptr(), mu.data_ptr(), nu.data_ptr(), g.data_ptr(),
            p.numel(), int(t), *adam_scalars(hyper), stream)
    if rc != 0:
        raise RuntimeError("flat_adam launch failed: "
                           + lib.flat_adam_error_string(rc).decode())
    KERNEL_LAUNCHES["flat_adam"] += 1


def adam_update(p, mu, nu, g, t: int, hyper: AdamHyper) -> None:
    """One Adam update at step ``t`` of flat buffers, in place: the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if p.device.type == "cuda":
        _launch_adam(p, mu, nu, g, t, hyper)
    elif p.device.type == "cpu":
        adam_update_reference(p, mu, nu, g, t, hyper)
    else:
        raise ValueError(f"flat_adam: no kernel for {p.device}")
