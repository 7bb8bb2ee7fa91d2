"""The bfloat16 branch of the step kernels' products (``precision =
"bfloat16"``): where the plain versions round, and how.

Counterpart of the ``matmul_bf16`` branch of the JAX package's step
kernels: ``_cast`` / ``dot`` / ``dot_bt`` / ``dot_nt`` in
``multivae_tpu/ops/fused_step.py::_fwd_bwd`` and ``dot`` in
``fused_methods.py::method_loss_split`` and
``fused_presence.py::presence_loss_split``. Every product there casts both
operands to bfloat16 and accumulates in float32
(``preferred_element_type=float32``). Two rounding schemes follow, read
off ``jax.make_jaxpr`` of the kernels' bodies (``tests/test_torch_port_bf16.py
::test_jaxpr_rounding_points`` counts them):

* **Scheme A, the hand backward** (``_fwd_bwd``: TPU kernels #2, #3, #6;
  ``fused_step.fwd_bwd_reference``). Every product of the forward and of
  the backward rounds both operands to bfloat16 (round to nearest even) and
  keeps the float32 result: :func:`dot`. In the jaxpr: two
  ``convert_element_type[bfloat16]`` before each ``dot_general``, none
  after. A sum of products (``g_h = sum_k g_k W_k^T``, ``g_zc``) adds the
  float32 results.
* **Scheme B, in-kernel autodiff** (``jax.value_and_grad`` of
  ``method_loss_split`` / ``presence_loss_split``: #4, #5, #7;
  ``fused_methods.method_fwd_bwd_reference``,
  ``fused_presence.presence_fwd_bwd_reference``). The forward products are
  scheme A's (:func:`dot`): the data ``x``, the hidden activations, the
  latent samples ``zs`` / ``zc`` and every weight enter as bfloat16. Each
  forward product's transpose multiplies the float32 cotangent by the
  OTHER operand as bfloat16, accumulates in float32 and rounds the result
  to bfloat16 before it is widened back (a ``dot_general`` with one f32
  and one bf16 operand, then ``convert_element_type[bfloat16]``, then
  ``convert_element_type[float32]``): :func:`dot_ct`. The plain version
  sums these products in float64 and rounds the sum to float32, then to
  bfloat16: the float32 sum's exact value, in no order of its own. The
  kernels sum in float32, as the TPU kernel does, in their tile's order;
  wherever a sum lies within its float32 round-off of a bfloat16 rounding
  boundary (about one output in a thousand for a 256-row weight gradient)
  the two part by a whole bfloat16 step. That is the noise of a float32
  order, not a rounding point: a check reads its reach off the plain
  version with every float32 result moved within its round-off bound
  (:func:`roundoff_moved`). So every weight
  gradient (``dW = round(round(A)^T G)``) and every activation gradient
  that leaves a product (``g_zs``, ``g_zc``, ``g_h``) is bfloat16-valued.
  Where one float32 tensor feeds several products (an encoder's four heads
  into ``g_h``, the two decoders into ``g_zc``, poe's unimodal decode into
  ``dWds`` / ``dWdc`` and its re-encoding into ``dWh`` and the head
  weights), each product's gradient is rounded on its own and the rounded
  values are added in float32. Bias gradients are sums of float32
  cotangents and are not rounded; nor is anything elementwise (the
  latents, the ReLU and keep masks, the loss).

Any precision other than ``"bfloat16"`` is float32, as in the JAX package
(:func:`cfg_bf16`).
"""

from __future__ import annotations

import contextlib

import torch

# (generator, sign) of :func:`roundoff_moved` while it is active
_MOVED = []


def cfg_bf16(cfg) -> bool:
    """Whether ``cfg`` trains the step kernels' products in bfloat16: the
    JAX package's rule, ``getattr(cfg, "precision", "float32") ==
    "bfloat16"``."""
    return getattr(cfg, "precision", "float32") == "bfloat16"


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest, ties to even, as XLA's
    ``convert_element_type``) and widened back to float32."""
    return t.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def roundoff_moved(seed: int, sign: int = 0):
    """Within it, the float32 result of every bfloat16 product of the plain
    versions (before any rounding to bfloat16 that follows) moves by the
    round-off bound of a float32 sum of its k terms in any order, ``k
    2^-24 sum |a_i b_i|``: up or down per element at random from ``seed``
    (``sign`` 0) or all one way (``sign`` +1 / -1). What comes out is the function as a
    float32 sum in some order might compute it: a check reads from it how
    far float32 round-off reaches through the bfloat16 roundings (a value
    that lies within its round-off of a rounding boundary rounds either
    way). The float32 branch is not touched."""
    _MOVED.append((torch.Generator().manual_seed(seed), sign))
    try:
        yield
    finally:
        _MOVED.pop()


def _moved(r: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``r = a @ b`` moved as :func:`roundoff_moved` says, if it is
    active."""
    if not _MOVED:
        return r
    gen, sign = _MOVED[-1]
    bound = (a.abs() @ b.abs()) * (a.shape[-1] * 2.0 ** -24)
    if sign:
        return r + sign * bound
    up = torch.rand(r.shape, generator=gen).to(r.device) < 0.5
    return torch.where(up, r + bound, r - bound)


def dot(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``a @ b``; under ``bf16`` of the rounded operands, the float32
    result kept (scheme A, and scheme B's forward)."""
    if not bf16:
        return a @ b
    a, b = round_bf16(a), round_bf16(b)
    return _moved(a @ b, a, b)


def dot_ct(a: torch.Tensor, b: torch.Tensor, bf16: bool,
           cotangent: str) -> torch.Tensor:
    """``a @ b`` where operand ``cotangent`` (``"a"`` or ``"b"``) is a
    float32 cotangent: under ``bf16`` the other operand is rounded, the sum
    taken in float64 and the result rounded to float32, then to bfloat16
    (scheme B's backward products)."""
    if not bf16:
        return a @ b
    if cotangent == "a":
        b = round_bf16(b)
    elif cotangent == "b":
        a = round_bf16(a)
    else:
        raise ValueError(f"cotangent is 'a' or 'b', got {cotangent!r}")
    a, b = a.double(), b.double()
    return round_bf16(_moved(a @ b, a, b).float())
