"""The bfloat16 branch of the step kernels (``precision="bfloat16"``)
against the JAX package's ``matmul_bf16`` branch.

The JAX kernels run on the CPU as the JAX package's own tests run them: the
Pallas bodies in interpret mode (``fused_loss_and_grads``, ``fused_epoch``,
the method, presence and row-slice bodies) and ``jax.value_and_grad`` of
the functions those bodies differentiate (``method_loss_split``,
``presence_loss_split``), each with ``matmul_bf16=True``; the port's plain
bf16 versions take the same numpy-seeded inputs, noise and masks. Sizes: the
port tests' (widths 3 / 12, hidden 16, latent 4, styles 2 / 3, B = 12 and a
partial 7); the row slices at ``test_torch_port_sharded.py``'s (B = 48,
widths 7 / 36, hidden 32, 4 shards).

The ratio rule (:func:`hold`): for the loss, each metric and each gradient
tensor, the norm of the port's difference from the JAX bf16 output is at
most ``RATIO`` = 0.1 times the norm of the JAX bf16 output's difference from
the JAX f32 output on the same inputs. A rounding point in the wrong place
gives a ratio near 1. Where the bf16 branch moves a value by no more than
``ROUNDOFF`` = 1e-5 of its size (float32 round-off: a metric that the
rounding does not reach, a gradient that is 0), the port matches the JAX
bf16 output to ``ROUNDOFF`` of that size. Scheme B rounds every weight
gradient to bfloat16, so an element of one may differ by a bfloat16 step
where the two sums (XLA's float32 one and the port's float64 one) land on
either side of a rounding boundary: where a weight gradient fails the rule
with them in, such ties (elements more than 2^-12 and at most two bfloat16
steps of their size apart), at most one or 10 % of the tensor, are left
out of its ratio (:func:`hold`). A metric (the loss too) and a bias hold by
the rule alone. Planted faults (a float32 loss, an unrounded product on a
bias gradient's path, a rounded bias gradient) fall outside it. Epochs are
held step by step along the port's trajectory by the same rule, and the
trainer epoch step by step along it too.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from multivae_tpu.data import MissingModalitySampler as JaxSampler
from multivae_tpu.ops import fused_methods as jax_fm
from multivae_tpu.ops import fused_presence as jax_fp
from multivae_tpu.ops import fused_sharded as jax_fsh
from multivae_tpu.ops import fused_step as jax_fs
from multivae_tpu.train import trainer as jax_trainer
from multivae_tpu_torch import params as bridge
from multivae_tpu_torch import workflows
from multivae_tpu_torch.data import make_synthetic_cohort
from multivae_tpu_torch.ops import adam as adam_ops
from multivae_tpu_torch.ops import bf16 as bf16_ops
from multivae_tpu_torch.ops import (
    fused_methods,
    fused_presence,
    fused_sharded,
    fused_step,
)
from multivae_tpu_torch.train import routes, trainer
from multivae_tpu_torch.train.config import Config
from multivae_tpu_torch.train.experiment import MultimodalExperiment
from multivae_tpu_torch.utils.filehandling import create_dir_structure

pytestmark = pytest.mark.driver  # cross-framework parity pins

DIMS, HIDDEN, CD, STYLE = (3, 12), 16, 4, (2, 3)
B, B_ODD = 12, 7
CONSTS = (1.3, 0.7, 1.2)  # beta, beta_style, beta_content
HYPER = adam_ops.AdamHyper(2e-3, 0.9, 0.999)
RATE = 0.2
RATIO, ROUNDOFF = 0.1, 1e-5
TIES = 0.1  # the share of a tensor's elements that may be rounding ties
METHODS = ("joint_elbo", "moe", "jsd", "poe")
CASES = [(m, masked) for masked in (False, True) for m in METHODS]
CASE_IDS = [f"{m}{'-masks' if k else ''}" for m, k in CASES]


def dims(b=B, d=DIMS, h=HIDDEN, cd=CD, style=STYLE):
    return bridge.FusedDims(b=b, d1=d[0], d2=d[1], h=h, cd=cd, s1=style[0],
                            s2=style[1])


def split_np(seed, d=None, scale=0.3):
    d = d or dims()
    rng = np.random.default_rng(seed)
    sp = {n: (scale * rng.normal(size=s)).astype(np.float32)
          for n, s in bridge.split_shapes(d).items()}
    sp["dec1_olv"] = np.full_like(sp["dec1_olv"], -1.0)
    sp["dec2_olv"] = np.full_like(sp["dec2_olv"], -0.5)
    return sp


def t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def bf16_ties(got, want):
    """Elements where ``got`` differs from ``want`` by more than float32
    noise (2^-12 of ``want``) and at most two bfloat16 steps of its size
    (see the module docstring)."""
    got, want = (np.asarray(a, np.float64).reshape(-1) for a in (got, want))
    _, exp = np.frexp(want)
    step = np.ldexp(1.0, exp - 8)  # one bfloat16 step
    diff = np.abs(got - want)
    return (want != 0) & (diff > step / 16) & (diff <= 2 * step)


def is_weight(label: str) -> bool:
    """A weight gradient (``enc1_Wh``, ``dec2_Wds``, ...): scheme B rounds
    it to bfloat16, so it alone may hold rounding ties."""
    return "_W" in label


def hold(got, want16, want32, label=""):
    """The ratio rule on one tensor; returns the ratio (0 where the bf16
    branch moves the value by round-off only). Rounding ties (see the
    module docstring) are left out of a weight gradient's ratio where the
    rule fails with them in; a metric or a bias holds by the rule alone."""
    got, w16, w32 = (np.asarray(a, np.float64) for a in (got, want16, want32))
    d = np.linalg.norm(got - w16)
    ref = np.linalg.norm(w16 - w32)
    size = np.linalg.norm(w16)
    if ref <= ROUNDOFF * size:
        assert d <= ROUNDOFF * size, (label, d, size)
        return 0.0
    if d > RATIO * ref and is_weight(label):
        ties = bf16_ties(got, w16)
        assert ties.sum() <= max(1, TIES * ties.size), (label, d / ref)
        d = np.linalg.norm((got - w16).reshape(-1)[~ties])
    assert d <= RATIO * ref, (label, d / ref)
    return d / ref


def hold_step(got_metrics, got_grads, want16, want32):
    """``(metrics, grads dict)`` of the port against the JAX bf16 and f32
    ``(metrics, grads dict)``: every metric (the loss is metric 0) and every
    split tensor by the ratio rule."""
    (m16, g16), (m32, g32) = want16, want32
    got_metrics = np.asarray(got_metrics)
    assert got_metrics.shape == np.shape(m16)
    for i in range(len(m16)):
        hold(got_metrics[i], m16[i], m32[i], f"metric {i}")
    for name in bridge.SPLIT_NAMES:
        hold(got_grads[name], g16[name], g32[name], name)


def method_batch(method, masked, b, seed, steps=None, fd=None):
    """``(x1, x2, noise, masks)`` of the method step at the sizes ``fd``
    (default :func:`dims`) with ``b`` rows; masks ``[(steps,) n_masks, b,
    hidden]`` or None."""
    fd = (fd or dims())._replace(b=b)
    rng = np.random.default_rng(seed)
    lead = () if steps is None else (steps,)
    f = lambda *s: rng.normal(size=lead + s).astype(np.float32)
    width = fused_methods.step_noise_width(method, fd)
    x1, x2, noise = f(b, fd.d1), f(b, fd.d2), f(b, width)
    masks = None
    if masked:
        n = fused_methods.n_dropout_masks(method, RATE)
        keep = rng.random(size=lead + (n, b, fd.h)) < 1.0 - RATE
        masks = (keep / (1.0 - RATE)).astype(np.float32)
    return x1, x2, noise, masks


def jax_method(method, sp, batch, b, bf16, learn_scale=True, d=None,
               row_offset=0, b_total=None, consts=CONSTS):
    """``(metrics, grads)`` of ``jax.value_and_grad(method_loss_split)``
    (the body of ``_method_epoch_kernel``) with ``matmul_bf16=bf16``."""
    x1, x2, noise, masks = batch
    jd = jax_fs.FusedDims(*(d or dims(b)))

    def loss_fn(p):
        return jax_fm.method_loss_split(
            method, jd, jax_fs.FusedConsts(*consts), learn_scale, bf16, p,
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(noise),
            dropout_masks=None if masks is None else tuple(
                jnp.asarray(m) for m in masks),
            row_offset=row_offset, b_total=b_total)

    (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(j(sp))
    return (np.stack([np.asarray(m) for m in metrics]),
            {k: np.asarray(v) for k, v in grads.items()})


# ------------------------------------------------------------ the rounding
def test_round_bf16_rounds_ties_to_even_as_xla():
    """``round_bf16`` is XLA's ``convert_element_type`` to bfloat16 and
    back, bit for bit, on exact ties (the dropped half is exactly 0x8000:
    to even, up and down) and their neighbours."""
    mantissas = np.arange(0, 1 << 16, 97, dtype=np.uint32)
    bits = np.concatenate([
        (np.uint32(0x3F800000) | (m << np.uint32(16)) | np.uint32(0x8000))
        for m in (mantissas & np.uint32(0x7F),)])
    bits = np.concatenate([bits, bits + 1, bits - 1,
                           bits | np.uint32(0x80000000)])
    x = bits.view(np.float32)
    got = bf16_ops.round_bf16(torch.from_numpy(x)).numpy().view(np.uint32)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32)).view(np.uint32)
    np.testing.assert_array_equal(got, want)
    ties = x[:len(x) // 4]
    # a tie rounds to the even neighbour: the kept low bit is 0
    kept = bf16_ops.round_bf16(torch.from_numpy(ties)).numpy().view(
        np.uint32)
    assert not (kept & np.uint32(0x10000)).any()


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e4, 1e30])
def test_round_bf16_matches_xla_on_random_values(scale):
    x = (scale * np.random.default_rng(int(np.log10(scale)) + 40).normal(
        size=4096)).astype(np.float32)
    got = bf16_ops.round_bf16(torch.from_numpy(x)).numpy().view(np.uint32)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32)).view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_products_round_where_the_schemes_say():
    a = torch.from_numpy(np.random.default_rng(1).normal(
        size=(5, 9)).astype(np.float32))
    b = torch.from_numpy(np.random.default_rng(2).normal(
        size=(9, 4)).astype(np.float32))
    r = bf16_ops.round_bf16
    torch.testing.assert_close(bf16_ops.dot(a, b, False), a @ b, rtol=0,
                               atol=0)
    torch.testing.assert_close(bf16_ops.dot(a, b, True), r(a) @ r(b),
                               rtol=1e-6, atol=1e-6)
    for ct in ("a", "b"):
        out = bf16_ops.dot_ct(a, b, True, ct)
        torch.testing.assert_close(out, r(out), rtol=0, atol=0)
        want = (a.double() @ r(b).double() if ct == "a"
                else r(a).double() @ b.double())
        torch.testing.assert_close(out, r(want.float()), rtol=0, atol=0)


def test_roundoff_moved_moves_bf16_products_by_their_bound():
    """Inside ``roundoff_moved`` every bf16 product's float32 result moves
    by ``k 2^-24 sum |a_i b_i|`` (all up, all down, or either way per
    element), before ``dot_ct`` rounds it; the float32 branch and anything
    outside stay as they were."""
    a = torch.from_numpy(np.random.default_rng(3).normal(
        size=(6, 11)).astype(np.float32))
    b = torch.from_numpy(np.random.default_rng(4).normal(
        size=(11, 5)).astype(np.float32))
    r = bf16_ops.round_bf16
    exact = r(a) @ r(b)
    bound = (r(a).abs() @ r(b).abs()) * (11 * 2.0 ** -24)
    before = bf16_ops.dot(a, b, True)
    for sign in (1, -1):
        with bf16_ops.roundoff_moved(0, sign):
            torch.testing.assert_close(bf16_ops.dot(a, b, True),
                                       exact + sign * bound, rtol=1e-6,
                                       atol=1e-7)
            assert torch.equal(bf16_ops.dot(a, b, False), a @ b)
            out = bf16_ops.dot_ct(a, b, True, "a")
            assert torch.equal(out, r(out))
    with bf16_ops.roundoff_moved(5):
        moved = bf16_ops.dot(a, b, True)
    up, down = moved == exact + bound, moved == exact - bound
    assert bool((up | down).all()) and bool(up.any()) and bool(down.any())
    assert torch.equal(bf16_ops.dot(a, b, True), before)
    with pytest.raises(ValueError, match="cotangent"):
        bf16_ops.dot_ct(a, b, True, "c")
    cfg = lambda p: type("Cfg", (), {"precision": p})()
    assert bf16_ops.cfg_bf16(cfg("bfloat16"))
    assert not any(bf16_ops.cfg_bf16(cfg(p)) for p in ("float32", "float16",
                                                       "bf16", None))
    assert not bf16_ops.cfg_bf16(object())


LAYOUT = ("transpose", "reshape", "squeeze", "broadcast_in_dim")


def _jaxpr_dots(closed):
    """Every ``dot_general`` of a jaxpr (sub-jaxprs too) with its operand
    dtypes and the primitives that consume its output, past layout-only
    steps (a weight gradient is transposed before it is converted)."""
    out = []

    def walk(jaxpr):
        users = {}
        for eqn in jaxpr.eqns:
            for v in eqn.invars:
                if hasattr(v, "count"):
                    users.setdefault(v, []).append(eqn)
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                ins = tuple(str(v.aval.dtype) for v in eqn.invars)
                var = eqn.outvars[0]
                while (len(users.get(var, [])) == 1
                       and users[var][0].primitive.name in LAYOUT):
                    var = users[var][0].outvars[0]
                after = [(u.primitive.name, str(u.params.get(
                    "new_dtype", ""))) for u in users.get(var, [])]
                out.append((ins, str(eqn.outvars[0].aval.dtype), after))
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(closed.jaxpr)
    return out


@pytest.mark.parametrize("method,masked", CASES, ids=CASE_IDS)
def test_jaxpr_rounding_points_scheme_b(method, masked):
    """In ``value_and_grad(method_loss_split, matmul_bf16=True)`` every
    forward product takes two bf16 operands and keeps f32; every backward
    product takes the f32 cotangent and one bf16 operand, and its result
    goes straight to a ``convert_element_type`` to bfloat16 (scheme B)."""
    sp = split_np(1)
    batch = method_batch(method, masked, B, 2)
    x1, x2, noise, masks = batch
    jd = jax_fs.FusedDims(*dims())

    def loss_fn(p):
        return jax_fm.method_loss_split(
            method, jd, jax_fs.FusedConsts(*CONSTS), True, True, p,
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(noise),
            dropout_masks=None if masks is None else tuple(
                jnp.asarray(m) for m in masks))[0]

    dots = _jaxpr_dots(jax.make_jaxpr(jax.value_and_grad(loss_fn))(j(sp)))
    fwd = [d for d in dots if d[0] == ("bfloat16", "bfloat16")]
    bwd = [d for d in dots if sorted(d[0]) == ["bfloat16", "float32"]]
    assert len(fwd) + len(bwd) == len(dots)
    assert all(out == "float32" for _, out, _ in dots)
    assert all(after == [("convert_element_type", "bfloat16")]
               for _, _, after in bwd)
    assert not any(("convert_element_type", "bfloat16") in after
                   for _, _, after in fwd)
    # each forward product has a weight gradient; the hidden layers' have
    # no input gradient (the data is not differentiated), the others one
    enc = 2 * (2 if method == "poe" and masked else 1)
    heads = 4 * enc
    dec = 4 * (2 if method == "poe" else 1)
    assert len(fwd) == enc + heads + dec
    assert len(bwd) == 2 * len(fwd) - enc


def test_jaxpr_rounding_points_scheme_a():
    """``_fwd_bwd`` with ``matmul_bf16=True``: every product, forward and
    backward, takes two bf16 operands and keeps its f32 result (scheme
    A)."""
    sp = split_np(1)
    x1, x2, noise, _ = method_batch("joint_elbo", False, B, 3)
    s1 = STYLE[0]
    dots = _jaxpr_dots(jax.make_jaxpr(
        lambda p: jax_fs._fwd_bwd(
            jax_fs.FusedDims(*dims()), jax_fs.FusedConsts(*CONSTS), True,
            True, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(noise[:, :CD]),
            jnp.asarray(noise[:, CD:CD + s1]), jnp.asarray(noise[:, CD + s1:]),
            p))(j(sp)))
    assert len(dots) == 14 + 26
    for ins, out, after in dots:
        assert ins == ("bfloat16", "bfloat16") and out == "float32"
        assert ("convert_element_type", "bfloat16") not in after


# --------------------------------------------- the MoPoE step (#2, #3)
def jax_mopoe(sp, x1, x2, noise, b, bf16, learn_scale=True, consts=CONSTS):
    """``fused_loss_and_grads`` (TPU kernel #2, interpret mode)."""
    jd = jax_fs.FusedDims(*dims(b))
    s1 = STYLE[0]
    _, grads, metrics = jax_fs.fused_loss_and_grads(
        jax_fs.join_params(j(sp), jd), jnp.asarray(x1), jnp.asarray(x2),
        jnp.asarray(noise[:, :CD]), jnp.asarray(noise[:, CD:CD + s1]),
        jnp.asarray(noise[:, CD + s1:]), jd, jax_fs.FusedConsts(*consts),
        learn_scale=learn_scale, interpret=True, matmul_bf16=bf16)
    split = jax_fs.split_params(grads, jd)
    return np.asarray(metrics), {k: np.asarray(v) for k, v in split.items()}


@pytest.mark.parametrize("learn_scale", [True, False])
@pytest.mark.parametrize("b", [B, B_ODD])
def test_mopoe_step_matches_jax_kernel(b, learn_scale):
    sp = split_np(5)
    x1, x2, noise, _ = method_batch("joint_elbo", False, b, 6 + b)
    launches = dict(fused_step.KERNEL_LAUNCHES)
    tx = [torch.from_numpy(a) for a in (x1, x2)]
    loss, metrics, grads = fused_step.loss_and_grads(
        t(sp), *tx, *fused_step.split_noise(torch.from_numpy(noise), dims(b)),
        dims(b), fused_step.FusedConsts(*CONSTS), learn_scale, bf16=True)
    assert fused_step.KERNEL_LAUNCHES == launches  # plain on the CPU
    assert float(loss) == float(metrics[0])
    hold_step(metrics, grads, jax_mopoe(sp, x1, x2, noise, b, True,
                                        learn_scale),
              jax_mopoe(sp, x1, x2, noise, b, False, learn_scale))


def test_fused_epoch_matches_jax_kernel_step_by_step():
    """``fused_epoch(bf16=True)`` (TPU kernel #3's contract) against
    ``fused_epoch(interpret=True, matmul_bf16=True)``: the whole epoch's
    metrics by the ratio rule, and every step of the port's trajectory held
    to the JAX kernel from the port's own state."""
    n = 3
    sp = split_np(7)
    zeros = {k: np.zeros_like(v) for k, v in sp.items()}
    x1s, x2s, noise, _ = method_batch("joint_elbo", False, B, 8, steps=n)
    s1 = STYLE[0]
    cut = lambda a: (a[..., :CD], a[..., CD:CD + s1], a[..., CD + s1:])
    got = fused_step.fused_epoch(
        t(sp), t(zeros), t(zeros), 0, torch.from_numpy(x1s),
        torch.from_numpy(x2s), *map(torch.from_numpy, cut(noise)), dims(),
        fused_step.FusedConsts(*CONSTS), HYPER, True, bf16=True)
    want = {bf: jax_fs.fused_epoch(
        j(sp), j(zeros), j(zeros), 0, jnp.asarray(x1s), jnp.asarray(x2s),
        *map(jnp.asarray, cut(noise)), jax_fs.FusedDims(*dims()),
        jax_fs.FusedConsts(*CONSTS), tuple(HYPER), learn_scale=True,
        interpret=True, matmul_bf16=bf) for bf in (True, False)}
    for i in range(n):
        for k in range(fused_step.N_METRICS):
            hold(got[3][i, k], want[True][3][i, k], want[False][3][i, k],
                 f"metric {k} of step {i}")
    # step by step along the port's trajectory
    p = bridge.flatten_split(t(sp))
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    for i in range(n):
        state = {k: v.numpy().copy() for k, v in
                 bridge.flat_views(p, dims()).items()}
        metrics = fused_step.epoch_flat(
            p, mu, nu, i, torch.from_numpy(x1s[i:i + 1]),
            torch.from_numpy(x2s[i:i + 1]), torch.from_numpy(noise[i:i + 1]),
            dims(), fused_step.FusedConsts(*CONSTS), HYPER, True, bf16=True)
        _, step_m, step_g = fused_step.fwd_bwd_reference(
            t(state), torch.from_numpy(x1s[i]), torch.from_numpy(x2s[i]),
            *fused_step.split_noise(torch.from_numpy(noise[i]), dims()),
            dims(), fused_step.FusedConsts(*CONSTS), True, bf16=True)
        torch.testing.assert_close(metrics[0], step_m, rtol=0, atol=0)
        hold_step(step_m, step_g,
                  jax_mopoe(state, x1s[i], x2s[i], noise[i], B, True),
                  jax_mopoe(state, x1s[i], x2s[i], noise[i], B, False))
    for got_t, want_t in zip((p, mu, nu), got[:3]):
        torch.testing.assert_close(got_t, bridge.flatten_split(want_t),
                                   rtol=0, atol=0)


# -------------------------------------------------- the method step (#5)
@pytest.mark.parametrize("b", [B, B_ODD])
@pytest.mark.parametrize("method,masked", CASES, ids=CASE_IDS)
def test_method_step_matches_jax_autodiff(method, masked, b):
    sp = split_np(METHODS.index(method) + 10)
    batch = method_batch(method, masked, b, 20 + b)
    x1, x2, noise, masks = batch
    launches = dict(fused_methods.KERNEL_LAUNCHES)
    metrics, grads = fused_methods.method_step_flat(
        method, bridge.flatten_split(t(sp)), torch.from_numpy(x1),
        torch.from_numpy(x2), torch.from_numpy(noise), dims(b),
        fused_step.FusedConsts(*CONSTS), True,
        None if masks is None else torch.from_numpy(masks), bf16=True)
    assert fused_methods.KERNEL_LAUNCHES == launches  # plain on the CPU
    hold_step(metrics, bridge.flat_views(grads, dims(b)),
              jax_method(method, sp, batch, b, True),
              jax_method(method, sp, batch, b, False))


# ---------------------------------------- planted faults the rule catches
# The port's plain bf16 step with one rounding point moved, held to the JAX
# kernels: the ratio rule refuses the tensor the fault reaches first.
FAULT_ROUTES = ("mopoe",) + METHODS


def port_step(route, bf16=True):
    """``(metrics, grads dict)`` of the port's plain step of ``route``
    (``"mopoe"``, the MoPoE step, or a method) and the JAX kernel's bf16
    and f32 ``(metrics, grads)`` on the same inputs at B = 12."""
    if route == "mopoe":
        sp = split_np(5)
        x1, x2, noise, _ = method_batch("joint_elbo", False, B, 6 + B)
        _, metrics, grads = fused_step.loss_and_grads(
            t(sp), torch.from_numpy(x1), torch.from_numpy(x2),
            *fused_step.split_noise(torch.from_numpy(noise), dims()),
            dims(), fused_step.FusedConsts(*CONSTS), True, bf16=bf16)
        want = [jax_mopoe(sp, x1, x2, noise, B, bf) for bf in (True, False)]
        return (metrics, grads), want
    sp = split_np(METHODS.index(route) + 10)
    batch = method_batch(route, False, B, 20 + B)
    x1, x2, noise, _ = batch
    metrics, grads = fused_methods.method_step_flat(
        route, bridge.flatten_split(t(sp)), torch.from_numpy(x1),
        torch.from_numpy(x2), torch.from_numpy(noise), dims(),
        fused_step.FusedConsts(*CONSTS), True, None, bf16=bf16)
    want = [jax_method(route, sp, batch, B, bf) for bf in (True, False)]
    return (metrics, bridge.flat_views(grads, dims())), want


@pytest.mark.parametrize("route", FAULT_ROUTES)
def test_planted_float32_loss_fails_the_ratio_rule(route):
    """The loss and metrics of the float32 forward beside the bf16
    gradients: the loss itself is outside the rule (the bf16 loss is
    inside it)."""
    (clean, grads), want = port_step(route)
    (metrics, _), _ = port_step(route, bf16=False)
    (m16, _), (m32, _) = want
    hold(np.asarray(clean)[0], m16[0], m32[0], "metric 0")
    with pytest.raises(AssertionError):
        hold(np.asarray(metrics)[0], m16[0], m32[0], "metric 0")
    with pytest.raises(AssertionError):
        hold_step(metrics, grads, *want)


@pytest.mark.parametrize("route", FAULT_ROUTES)
def test_planted_unrounded_bias_path_fails_the_ratio_rule(route, monkeypatch):
    """The products into an encoder's hidden-layer gradient ``g_h`` (the
    path of its bias gradient ``enc_bh``) without their rounding: scheme
    A's ``g W^T`` with the weight not rounded, scheme B's with the result
    not rounded. ``enc1_bh`` is outside the rule (inside it without the
    fault)."""
    (_, clean), want = port_step(route)
    (_, g16), (_, g32) = want
    hold(clean["enc1_bh"], g16["enc1_bh"], g32["enc1_bh"], "enc1_bh")
    if route == "mopoe":
        dot = fused_step.dot

        def faulty(a, b, bf16):
            if bf16 and b.shape[-1] == HIDDEN and not b.is_contiguous():
                return bf16_ops.round_bf16(a) @ b  # g W^T, W not rounded
            return dot(a, b, bf16)
        monkeypatch.setattr(fused_step, "dot", faulty)
    else:
        dot_ct = fused_methods.dot_ct

        def faulty(a, b, bf16, cotangent):
            if bf16 and cotangent == "a" and b.shape[-1] == HIDDEN:
                return a @ bf16_ops.round_bf16(b)  # g W^T not rounded
            return dot_ct(a, b, bf16, cotangent)
        monkeypatch.setattr(fused_methods, "dot_ct", faulty)
    (_, grads), _ = port_step(route)
    with pytest.raises(AssertionError):
        hold(grads["enc1_bh"], g16["enc1_bh"], g32["enc1_bh"], "enc1_bh")


@pytest.mark.parametrize("route", FAULT_ROUTES)
def test_planted_rounded_bias_gradient_fails_the_ratio_rule(route):
    """A bias gradient (a float32 sum of cotangents) rounded to bfloat16
    as if it left a product: outside the rule."""
    (_, grads), want = port_step(route)
    (_, g16), (_, g32) = want
    hold(grads["enc2_bclv"], g16["enc2_bclv"], g32["enc2_bclv"], "enc2_bclv")
    got = bf16_ops.round_bf16(grads["enc2_bclv"])
    assert not torch.equal(got, grads["enc2_bclv"])
    with pytest.raises(AssertionError):
        hold(got, g16["enc2_bclv"], g32["enc2_bclv"], "enc2_bclv")


def jax_method_epoch(method, sp, count, x1s, x2s, noise, masks, bf16):
    """``build_method_epoch``'s ``pallas_call`` (interpret mode) from zero
    moments with the noise and the masks as inputs: ``(params, metrics)``."""
    n = len(jax_fs.SPLIT_NAMES)
    n_steps, b = x1s.shape[:2]
    jd = jax_fs.FusedDims(*dims(b))
    n_met = fused_methods.n_method_metrics(method)
    n_masks = 0 if masks is None else masks.shape[1]
    kernel = partial(jax_fm._method_epoch_kernel, method, jd,
                     jax_fs.FusedConsts(*CONSTS), True, bf16, tuple(HYPER),
                     n_met, n_masks)
    whole = pl.BlockSpec(memory_space=pltpu.VMEM)
    stream = lambda w: pl.BlockSpec((1, b, w), lambda i: (i, 0, 0))
    names = jax_fs.SPLIT_NAMES
    outs = pl.pallas_call(
        kernel, grid=(n_steps,),
        out_shape=([jax.ShapeDtypeStruct((n_steps, n_met), jnp.float32)]
                   + [jax.ShapeDtypeStruct(sp[nm].shape, jnp.float32)
                      for nm in names] * 3),
        in_specs=([stream(DIMS[0]), stream(DIMS[1]),
                   stream(noise.shape[2])] + [stream(HIDDEN)] * n_masks
                  + [pl.BlockSpec(memory_space=pltpu.SMEM)]
                  + [whole] * (3 * n)),
        out_specs=([pl.BlockSpec(memory_space=pltpu.SMEM)]
                   + [whole] * (3 * n)),
        interpret=True,
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",)),
    )(jnp.asarray(x1s), jnp.asarray(x2s), jnp.asarray(noise),
      *[jnp.asarray(masks[:, i]) for i in range(n_masks)],
      jnp.asarray(count, jnp.int32).reshape(1, 1),
      *[jnp.asarray(sp[nm]) for nm in names],
      *[jnp.zeros_like(jnp.asarray(sp[nm])) for nm in names] * 2)
    return dict(zip(names, outs[1:1 + n])), np.asarray(outs[0])


@pytest.mark.parametrize("method,masked", CASES, ids=CASE_IDS)
def test_method_epoch_matches_jax_pallas_body(method, masked):
    """A 2-step ``method_epoch(bf16=True)`` at the partial row count: its
    metrics against the TPU kernel's body in interpret mode by the ratio
    rule; each step of the port's trajectory held to ``method_loss_split``
    from the port's own state."""
    n = 2
    sp = split_np(30 + METHODS.index(method))
    zeros = {k: np.zeros_like(v) for k, v in sp.items()}
    x1s, x2s, noise, masks = method_batch(method, masked, B_ODD, 31, steps=n)
    got = fused_methods.method_epoch(
        method, t(sp), t(zeros), t(zeros), 0, torch.from_numpy(x1s),
        torch.from_numpy(x2s), torch.from_numpy(noise), dims(B_ODD),
        fused_step.FusedConsts(*CONSTS), HYPER, True,
        None if masks is None else torch.from_numpy(masks), bf16=True)
    want = {bf: jax_method_epoch(method, sp, 0, x1s, x2s, noise, masks, bf)
            for bf in (True, False)}
    for i in range(n):
        for k in range(got[3].shape[1]):
            hold(got[3][i, k], want[True][1][i, k], want[False][1][i, k],
                 f"metric {k} of step {i}")
    p = bridge.flatten_split(t(sp))
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    for i in range(n):
        state = {k: v.numpy().copy() for k, v in
                 bridge.flat_views(p, dims(B_ODD)).items()}
        step = (x1s[i], x2s[i], noise[i], None if masks is None else masks[i])
        m, g = fused_methods.method_step_flat(
            method, p, *map(torch.from_numpy, step[:3]), dims(B_ODD),
            fused_step.FusedConsts(*CONSTS), True,
            None if masks is None else torch.from_numpy(step[3]), bf16=True)
        adam_ops.adam_update(p, mu, nu, g, i + 1, HYPER)
        hold_step(m, bridge.flat_views(g, dims(B_ODD)),
                  jax_method(method, state, step, B_ODD, True),
                  jax_method(method, state, step, B_ODD, False))
    for got_t, want_t in zip((p, mu, nu), got[:3]):
        torch.testing.assert_close(got_t, bridge.flatten_split(want_t),
                                   rtol=0, atol=0)


# ------------------------------------------------ the presence step (#4)
def presence_batch(method, masked, mod_idx, b, seed, steps=None):
    rng = np.random.default_rng(seed)
    lead = () if steps is None else (steps,)
    width = (CD + STYLE[mod_idx]) * (2 if method == "poe" else 1)
    x = rng.normal(size=lead + (b, DIMS[mod_idx])).astype(np.float32)
    noise = rng.normal(size=lead + (b, width)).astype(np.float32)
    masks = None
    if masked:
        n = fused_presence.n_presence_masks(method, RATE)
        keep = rng.random(size=lead + (n, b, HIDDEN)) < 1.0 - RATE
        masks = (keep / (1.0 - RATE)).astype(np.float32)
    return x, noise, masks


def jax_presence(method, mod_idx, sp, batch, b, bf16, consts=CONSTS):
    """``jax.value_and_grad(presence_loss_split)`` (the body of
    ``_presence_epoch_kernel``) with ``matmul_bf16=bf16``."""
    x, noise, masks = batch
    jd = jax_fs.FusedDims(*dims(b))

    def loss_fn(p):
        return jax_fp.presence_loss_split(
            method, jd, jax_fs.FusedConsts(*consts), True, bf16, mod_idx, p,
            jnp.asarray(x), jnp.asarray(noise),
            dropout_masks=None if masks is None else tuple(
                jnp.asarray(m) for m in masks))

    (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(j(sp))
    return (np.stack([np.asarray(m) for m in metrics]),
            {k: np.asarray(v) for k, v in grads.items()})


@pytest.mark.parametrize("mod_idx", [0, 1])
@pytest.mark.parametrize("method,masked", CASES, ids=CASE_IDS)
def test_presence_step_matches_jax_autodiff(method, masked, mod_idx):
    sp = split_np(40 + METHODS.index(method))
    batch = presence_batch(method, masked, mod_idx, B, 41 + mod_idx)
    x, noise, masks = batch
    launches = dict(fused_presence.KERNEL_LAUNCHES)
    metrics, grads = fused_presence.presence_step_flat(
        bridge.flatten_split(t(sp)), torch.from_numpy(x),
        torch.from_numpy(noise), dims(), fused_step.FusedConsts(*CONSTS),
        True, mod_idx, method,
        None if masks is None else torch.from_numpy(masks), bf16=True)
    assert fused_presence.KERNEL_LAUNCHES == launches  # plain on the CPU
    grads = bridge.flat_views(grads, dims())
    absent = str(2 - mod_idx)  # enc2_*, dec2_* for mod_idx 0
    assert not any(grads[k].any() for k in grads if k[3] == absent)
    hold_step(metrics, grads,
              jax_presence(method, mod_idx, sp, batch, B, True),
              jax_presence(method, mod_idx, sp, batch, B, False))


@pytest.mark.parametrize("method,masked", [("joint_elbo", False),
                                           ("poe", True)])
def test_presence_epoch_steps_match_jax_autodiff(method, masked):
    """A 2-step ``presence_epoch(bf16=True)`` at a partial row count, each
    step of its trajectory held to ``presence_loss_split`` from the port's
    own state, and the epoch equal to those steps with Adam."""
    n, mod_idx = 2, 0
    sp = split_np(50)
    zeros = {k: np.zeros_like(v) for k, v in sp.items()}
    xs, noise, masks = presence_batch(method, masked, mod_idx, B_ODD, 51,
                                      steps=n)
    got = fused_presence.presence_epoch(
        t(sp), t(zeros), t(zeros), 0, torch.from_numpy(xs),
        torch.from_numpy(noise), dims(B_ODD), fused_step.FusedConsts(*CONSTS),
        HYPER, True, mod_idx, method,
        None if masks is None else torch.from_numpy(masks), bf16=True)
    p = bridge.flatten_split(t(sp))
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    for i in range(n):
        state = {k: v.numpy().copy() for k, v in
                 bridge.flat_views(p, dims(B_ODD)).items()}
        step = (xs[i], noise[i], None if masks is None else masks[i])
        m, g = fused_presence.presence_step_flat(
            p, torch.from_numpy(xs[i]), torch.from_numpy(noise[i]),
            dims(B_ODD), fused_step.FusedConsts(*CONSTS), True, mod_idx,
            method, None if masks is None else torch.from_numpy(masks[i]),
            bf16=True)
        adam_ops.adam_update(p, mu, nu, g, i + 1, HYPER)
        torch.testing.assert_close(got[3][i], m, rtol=0, atol=0)
        hold_step(m, bridge.flat_views(g, dims(B_ODD)),
                  jax_presence(method, mod_idx, state, step, B_ODD, True),
                  jax_presence(method, mod_idx, state, step, B_ODD, False))
    for got_t, want_t in zip((p, mu, nu), got[:3]):
        torch.testing.assert_close(got_t, bridge.flatten_split(want_t),
                                   rtol=0, atol=0)


# ------------------------------------------------ the row slices (#6, #7)
SB, SDIMS, SHIDDEN, SCD, SSTYLE = 48, (7, 36), 32, 6, (3, 5)


def sdims(b=SB):
    return dims(b, d=SDIMS, h=SHIDDEN, cd=SCD, style=SSTYLE)


@pytest.mark.parametrize("method,masked", CASES, ids=CASE_IDS)
def test_slices_match_jax_pallas_bodies(method, masked):
    """Every shard of 4 of the port's plain bf16 row-slice step against
    ``_dp_loss_and_grads`` / ``_dp_method_loss_and_grads`` (the TPU
    kernels' bodies, interpret mode, ``matmul_bf16``) with the same
    ``row_offset`` and ``b_total``."""
    n_dev = 4
    local = SB // n_dev
    sp = split_np(60 + METHODS.index(method), sdims(), scale=0.1)
    x1, x2, noise, masks = method_batch(method, masked, SB, 61, fd=sdims())
    consts = jax_fs.FusedConsts(*CONSTS)
    hand = method == "joint_elbo" and not masked
    cd, s1 = SCD, SSTYLE[0]
    for k in range(n_dev):
        rows, offset = slice(k * local, (k + 1) * local), k * local
        jd = jax_fs.FusedDims(*sdims(local))
        jx1, jx2, jn = (jnp.asarray(a[rows]) for a in (x1, x2, noise))
        want = {}
        for bf in (True, False):
            if hand:
                mvec, grads = jax_fsh._dp_loss_and_grads(
                    j(sp), jx1, jx2, jn[:, :cd], jn[:, cd:cd + s1],
                    jn[:, cd + s1:], offset, jd, SB, consts, True, True, bf)
            else:
                jmasks = [] if masks is None else [jnp.asarray(m[rows])
                                                   for m in masks]
                mvec, grads = jax_fsh._dp_method_loss_and_grads(
                    j(sp), jx1, jx2, jn, jmasks, offset, method, jd, SB,
                    consts, True, True, bf,
                    fused_methods.n_method_metrics(method))
            want[bf] = (np.asarray(mvec), {n: np.asarray(v)
                                           for n, v in grads.items()})
        p = bridge.flatten_split(t(sp))
        tx1, tx2, tn = (torch.from_numpy(a[rows]) for a in (x1, x2, noise))
        fs_consts = fused_step.FusedConsts(*CONSTS)
        if hand:
            m, g = fused_step.slice_step_flat(
                p, tx1, tx2, *fused_step.split_noise(tn, sdims(local)),
                sdims(local), fs_consts, True, offset, SB, bf16=True)
        else:
            m, g = fused_methods.slice_method_step_flat(
                method, p, tx1, tx2, tn, sdims(local), fs_consts, True,
                None if masks is None else torch.from_numpy(masks[:, rows]),
                offset, SB, bf16=True)
        hold_step(m, bridge.flat_views(g, sdims(local)), want[True],
                  want[False])


# --------------------------------------------------------- the trainer
DATA_DIMS, BATCH = (3, 12), 12


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cohort"))
    # 64 complete train subjects (5 full + 1 partial batch of 12), 20
    # clinical-only (1 full + 1 partial), 16 test
    make_synthetic_cohort(d, n_subjects=100, n_scores=DATA_DIMS[0],
                          n_rois=DATA_DIMS[1], missing_rate=0.2, seed=1)
    return d


def make_cfg(datasetdir, outdir="", **kw):
    base = dict(dataset="synthetic", datasetdir=datasetdir,
                dir_experiment=outdir, input_dim=list(DATA_DIMS),
                class_dim=CD, style_dim=list(STYLE), hidden_dim=HIDDEN,
                batch_size=BATCH, end_epoch=1, initial_learning_rate=2e-3,
                seed=7, beta_style=0.7, beta_content=1.2,
                precision="bfloat16")
    base.update(kw)
    return Config(**base).derive()


def make_exp(datasetdir, **kw):
    exp = MultimodalExperiment(make_cfg(datasetdir, **kw), "cpu")
    exp.set_datasets()
    exp.set_optimizers()
    return exp


class Recorder:
    """Wraps the three step modules' epoch functions: each call's
    module, ``bf16`` flag and row count, and the steps of the plain
    epochs (the state before each step and the step's gradient)."""

    def __init__(self, monkeypatch):
        self.calls, self.steps = [], []
        for mod, name in ((fused_step, "epoch_flat"),
                          (fused_methods, "method_epoch_flat"),
                          (fused_presence, "presence_epoch_flat")):
            monkeypatch.setattr(mod, name, self.wrap(mod, getattr(mod,
                                                                  name)))
            real = mod.adam_update

            def adam(p, mu, nu, g, t, hyper, _real=real):
                self.steps.append((p.clone(), g.clone()))
                _real(p, mu, nu, g, t, hyper)
            monkeypatch.setattr(mod, "adam_update", adam)

    def wrap(self, mod, fn):
        def call(*args, **kwargs):
            bf16 = bool(kwargs.get("bf16", False))
            self.calls.append((mod.__name__.rsplit(".", 1)[1], bf16))
            return fn(*args, **kwargs)
        return call


def rows(data):
    return len(next(iter(data.values())))


def test_trainer_epoch_matches_jax_kernels_step_by_step(cohort, monkeypatch):
    """One port trainer epoch of the flagship architecture at small width
    with ``precision="bfloat16"``, held step by step along its own
    trajectory to the JAX kernels' bf16 branch: the full complete batches
    to ``_fwd_bwd`` (TPU kernel #3's body, scheme A), the partial complete
    batch to ``method_loss_split`` (#5; the JAX group policy never takes
    #3), the clinical-only batches to ``presence_loss_split`` (#4), in the
    JAX sampler's order and group order."""
    rec = Recorder(monkeypatch)
    exp = make_exp(cohort, method="joint_elbo")
    cfg = exp.cfg
    steps = trainer.train_one_epoch(exp, 0, None,
                                    trainer.epoch_generator(cfg, 0, 0), 0)
    assert rec.calls[0] == ("fused_step", True)
    assert all(bf for _, bf in rec.calls)
    assert ("fused_methods", True) in rec.calls

    ds = exp.dataset_train
    batches = [ds.gather(i)[0] for i in
               JaxSampler(ds, batch_size=BATCH, seed=cfg.seed)]
    names = list(exp.mod_names)
    is_full = [rows(b) == BATCH and all(m in b for m in names)
               for b in batches]
    emitted = ([b for b, f in zip(batches, is_full) if f]
               + [b for b, f in zip(batches, is_full) if not f])
    n_full = sum(is_full)
    noise = trainer.draw_noise(
        trainer.epoch_generator(cfg, 0, 0),
        [(rows(b), trainer.batch_noise_width(cfg, exp.models[0], b))
         for b in emitted], "cpu")
    groups = {}
    for i, b in enumerate(emitted[n_full:]):
        groups.setdefault((tuple(sorted(b)), rows(b)), []).append(n_full + i)
    order = list(range(n_full))
    for key in jax_trainer.canonical_group_order(groups, names, BATCH):
        order += groups[key]
    kinds = {(len(emitted[i]), rows(emitted[i]) == BATCH) for i in order}
    assert kinds == {(1, True), (1, False), (2, True), (2, False)}
    assert steps == len(order) == len(rec.steps)

    consts = (cfg.beta, cfg.beta_style, cfg.beta_content)
    for i, (p_before, g) in zip(order, rec.steps):
        data, eps = emitted[i], noise[i].numpy()
        b = rows(data)
        sp = {k: v.numpy() for k, v in
              bridge.flat_views(p_before, dims(b)).items()}
        gv = bridge.flat_views(g, dims(b))
        if len(data) == 2 and b == BATCH:
            want = [jax_mopoe(sp, data[names[0]], data[names[1]], eps, b,
                              bf, consts=consts) for bf in (True, False)]
        elif len(data) == 2:
            want = [jax_method("joint_elbo", sp, (data[names[0]],
                                                  data[names[1]], eps, None),
                               b, bf, consts=consts) for bf in (True, False)]
        else:
            mod_idx = names.index(next(iter(data)))
            want = [jax_presence("joint_elbo", mod_idx, sp,
                                 (data[names[mod_idx]], eps, None), b, bf,
                                 consts) for bf in (True, False)]
        for name in bridge.SPLIT_NAMES:
            hold(gv[name], want[0][1][name], want[1][1][name], name)


def test_trainer_routes_under_bf16(cohort, monkeypatch):
    """Under bf16 every group of a poe + dropout epoch takes the method or
    the presence step in bf16; a partial complete ``joint_elbo`` group
    takes the method step (under f32 the MoPoE step)."""
    rec = Recorder(monkeypatch)
    exp = make_exp(cohort, method="poe", dropout_rate=0.2)
    trainer.train_one_epoch(exp, 0, None,
                            trainer.epoch_generator(exp.cfg, 0, 0), 0)
    assert {m for m, _ in rec.calls} == {"fused_methods", "fused_presence"}
    assert all(bf for _, bf in rec.calls)
    exp = make_exp(cohort, method="joint_elbo")
    model = exp.models[0]
    for precision, want in (("bfloat16", ("fused_methods", True)),
                            ("float32", ("fused_step", False))):
        rec.calls.clear()
        cfg = make_cfg(cohort, precision=precision)
        fn = trainer.make_group_fused_epoch(cfg, model, (
            tuple(sorted(exp.mod_names)), 7))
        x = {m: torch.zeros(1, 7, d) for m, d in zip(exp.mod_names,
                                                     DATA_DIMS)}
        p = exp.params[0].clone()
        state = adam_ops.init_adam_state(p)
        fn(p, state, x, torch.zeros(1, 7, CD + sum(STYLE)))
        assert rec.calls == [want]


def test_float16_and_other_precisions_train_float32(cohort):
    """Only ``"bfloat16"`` turns the branch on, as in the JAX package: a
    ``float16`` epoch is the ``float32`` epoch, bit for bit."""
    runs = {}
    for precision in ("float32", "float16"):
        exp = make_exp(cohort, method="moe", precision=precision)
        trainer.train_one_epoch(exp, 0, None,
                                trainer.epoch_generator(exp.cfg, 0, 0), 0)
        runs[precision] = exp.params[0]
    torch.testing.assert_close(runs["float16"], runs["float32"], rtol=0,
                               atol=0)
    exp = make_exp(cohort, method="moe")
    trainer.train_one_epoch(exp, 0, None,
                            trainer.epoch_generator(exp.cfg, 0, 0), 0)
    assert not torch.equal(exp.params[0], runs["float32"])
    assert routes.Routes(exp.cfg, exp.models[0]).gaps == []


@pytest.mark.parametrize("kw", [
    dict(num_hidden_layer_decoder=1),
    dict(fused_training=False),
], ids=["layer-stack", "autograd"])
def test_routes_without_a_bf16_branch_read_no_precision(cohort, kw):
    """The layer-stack step (#8) and the autograd step read no precision:
    a bf16 epoch is the f32 epoch, bit for bit."""
    runs = []
    for precision in ("bfloat16", "float32"):
        exp = make_exp(cohort, precision=precision, **kw)
        trainer.train_one_epoch(exp, 0, None,
                                trainer.epoch_generator(exp.cfg, 0, 0), 0)
        runs.append(exp.params[0])
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


def test_data_parallel_remainders_stay_float32(cohort, monkeypatch):
    """Under ``data_parallel > 1`` the full complete batches take the
    row-slice steps in bf16 and every other group stays f32, as the JAX
    package runs them on its XLA step."""
    rec = Recorder(monkeypatch)
    slices = []
    real = fused_sharded.slice_method_step_flat

    def record_slice(*args, **kwargs):
        slices.append(kwargs.get("bf16", args[-1] if len(args) > 11
                                 else False))
        return real(*args, **kwargs)

    monkeypatch.setattr(fused_sharded, "slice_method_step_flat",
                        record_slice)
    exp = make_exp(cohort, method="moe", data_parallel=2)
    dp = routes.Routes(exp.cfg, exp.models[0], exp.device)
    trainer.train_one_epoch(exp, 0, None,
                            trainer.epoch_generator(exp.cfg, 0, 0), 0, 1, dp)
    assert slices and all(slices)
    assert rec.calls and not any(bf for _, bf in rec.calls)


def test_ensemble_member_bf16_prefix(cohort, monkeypatch):
    """The ensemble runner's member epoch with ``bf16_full = k``: its first
    ``k`` full complete batches in bf16, the others and every other group
    in f32."""
    rec = Recorder(monkeypatch)
    exp = make_exp(cohort, method="joint_elbo")
    full, general = trainer.epoch_batches(exp, 0, 0)
    assert len(full) == 5
    trainer.enqueue_train_epoch(exp, 0, trainer.epoch_generator(exp.cfg, 0,
                                                                0), 0,
                                batches=(full, general), bf16_full=2)
    assert rec.calls[:2] == [("fused_step", True), ("fused_step", False)]
    assert not any(bf for _, bf in rec.calls[2:])
    assert len(rec.steps) == len(full) + len(general)


def test_resume_carries_bf16_over(cohort, tmp_path):
    """``precision`` is a field of ``flags.json``: a resumed bf16 run goes
    on in bf16 and ends where the uninterrupted one does, bit for bit."""
    ends = {}
    for name, epochs in (("straight", 2), ("split", 1)):
        outdir = str(tmp_path / name)
        exp = MultimodalExperiment(make_cfg(cohort, outdir, method="poe",
                                            end_epoch=epochs), "cpu")
        create_dir_structure(exp.cfg)
        exp.set_datasets()
        exp.set_optimizers()
        trainer.run_epochs(exp, use_tensorboard=False, progress=False)
        run = exp.cfg.str_experiment
        if name == "split":
            flags = Config.load(str(tmp_path / name / run / "flags.json"))
            assert flags.precision == "bfloat16"
            workflows.resume_exp("synthetic", cohort, outdir, run, 2,
                                 use_tensorboard=False, device="cpu")
        with np.load(tmp_path / name / run / "checkpoints" / "0001"
                     / "model.npz") as fh:
            ends[name] = {k: fh[k] for k in fh.files}
    for k in ends["straight"]:
        np.testing.assert_array_equal(ends["split"][k], ends["straight"][k])
