"""The one-launch epoch entry points of the port's persistent step kernels
(``fused_step.epoch_flat``, ``fused_presence.presence_epoch_flat``) on the
CPU: what they check before a launch, how the C arguments are packed, and
that a group of one step is the step followed by the Adam update.

On CUDA tensors a group of steps is ONE launch of ``csrc/mopoe_step.cu`` /
``csrc/presence_step.cu`` (``mopoe_epoch_launch``, ``presence_epoch_launch``)
with Adam inside; the packing functions are pure Python and are held here
to the ``(name, kind)`` tables the ``argtypes`` are made from. On CPU
tensors the host loops the plain step and the plain Adam; the agreement of
those loops with the JAX package's epoch kernels is in
``test_torch_port_train_step.py`` and ``test_torch_port_presence.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.ops import adam as adam_ops
from multivae_tpu_torch.ops import fused_presence, fused_step

DIMS = bridge.FusedDims(b=12, d1=3, d2=12, h=16, cd=4, s1=2, s2=3)
CONSTS = fused_step.FusedConsts(1.3, 0.7, 1.2)
HYPER = adam_ops.AdamHyper(2e-3, 0.9, 0.999)
N = bridge.flat_size(DIMS)


def state(seed=0):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy((0.3 * rng.normal(size=N)).astype(np.float32))
    mu = torch.from_numpy((0.01 * rng.normal(size=N)).astype(np.float32))
    nu = torch.from_numpy((1e-4 * rng.random(size=N)).astype(np.float32))
    return p, mu, nu


def stacks(n, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return (f(n, DIMS.b, DIMS.d1), f(n, DIMS.b, DIMS.d2),
            f(n, DIMS.b, DIMS.cd + DIMS.s1 + DIMS.s2))


def presence_stacks(n, mod_idx, method, masked, seed=2):
    rng = np.random.default_rng(seed)
    d = (DIMS.d1, DIMS.d2)[mod_idx]
    s = (DIMS.s1, DIMS.s2)[mod_idx]
    twice = 2 if method == "poe" else 1
    xs = torch.from_numpy(rng.normal(size=(n, DIMS.b, d)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(
        size=(n, DIMS.b, (DIMS.cd + s) * twice)).astype(np.float32))
    masks = None
    if masked:
        keep = rng.random(size=(n, twice, DIMS.b, DIMS.h)) < 0.8
        masks = torch.from_numpy((keep / 0.8).astype(np.float32))
    return xs, noise, masks


# ------------------------------------------------- a group of one step
@pytest.mark.parametrize("count", [0, 5])
def test_epoch_of_one_is_step_then_adam(count):
    x1s, x2s, noise = stacks(1)
    p, mu, nu = state()
    metrics = fused_step.epoch_flat(p, mu, nu, count, x1s, x2s, noise, DIMS,
                                    CONSTS, HYPER)
    q, qm, qv = state()
    m, g = fused_step.step_flat(q, x1s[0], x2s[0],
                                *fused_step.split_noise(noise[0], DIMS),
                                DIMS, CONSTS)
    adam_ops.adam_update(q, qm, qv, g, count + 1, HYPER)
    assert metrics.shape == (1, fused_step.N_METRICS)
    for got, want in ((metrics[0], m), (p, q), (mu, qm), (nu, qv)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method", fused_presence.PORTED_METHODS)
@pytest.mark.parametrize("mod_idx", [0, 1])
def test_presence_epoch_of_one_is_step_then_adam(mod_idx, method, masked):
    xs, noise, masks = presence_stacks(1, mod_idx, method, masked)
    p, mu, nu = state()
    metrics = fused_presence.presence_epoch_flat(
        p, mu, nu, 5, xs, noise, DIMS, CONSTS, HYPER, True, mod_idx, method,
        masks)
    q, qm, qv = state()
    m, g = fused_presence.presence_step_flat(
        q, xs[0], noise[0], DIMS, CONSTS, True, mod_idx, method,
        None if masks is None else masks[0])
    adam_ops.adam_update(q, qm, qv, g, 6, HYPER)
    assert metrics.shape == (1, fused_presence.n_presence_metrics(method))
    for got, want in ((metrics[0], m), (p, q), (mu, qm), (nu, qv)):
        assert torch.equal(got, want)


def test_epoch_counts_steps_only_where_it_launches():
    """On the CPU the plain versions run: neither a launch nor a step of a
    launch is counted."""
    before = (dict(fused_step.KERNEL_LAUNCHES), dict(fused_step.KERNEL_STEPS),
              dict(fused_presence.KERNEL_LAUNCHES),
              dict(fused_presence.KERNEL_STEPS),
              dict(adam_ops.KERNEL_LAUNCHES))
    fused_step.epoch_flat(*state(), 0, *stacks(2), DIMS, CONSTS, HYPER)
    xs, noise, _ = presence_stacks(2, 0, "joint_elbo", False)
    fused_presence.presence_epoch_flat(*state(), 0, xs, noise, DIMS, CONSTS,
                                       HYPER, True, 0)
    assert before == (fused_step.KERNEL_LAUNCHES, fused_step.KERNEL_STEPS,
                      fused_presence.KERNEL_LAUNCHES,
                      fused_presence.KERNEL_STEPS, adam_ops.KERNEL_LAUNCHES)
    assert set(fused_step.KERNEL_STEPS) == set(fused_step.KERNEL_LAUNCHES)
    assert set(fused_presence.KERNEL_STEPS) == set(
        fused_presence.KERNEL_LAUNCHES)


# ----------------------------------------------- what a launch refuses
def bad_stack(kind, t):
    if kind == "strided":
        return torch.cat([t, t], dim=-1)[..., :t.shape[-1]]
    if kind == "dtype":
        return t.double()
    if kind == "device":
        return t.to("meta")
    return t[:, :-1]  # shape


BAD = [("strided", ValueError, "contiguous"), ("dtype", TypeError, "float32"),
       ("device", ValueError, "is on"), ("shape", ValueError, "shape")]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["x1s", "x2s", "noise"])
@pytest.mark.parametrize("kind,error,match", BAD, ids=[b[0] for b in BAD])
def test_epoch_refuses_a_bad_stack(kind, error, match, which):
    args = list(stacks(2))
    args[which] = bad_stack(kind, args[which])
    p, mu, nu = state()
    with pytest.raises(error, match=match):
        fused_step.epoch_flat(p, mu, nu, 0, *args, DIMS, CONSTS, HYPER)
    assert torch.equal(p, state()[0])  # nothing ran


@pytest.mark.parametrize("which", [0, 1, 2], ids=["xs", "noise", "masks"])
@pytest.mark.parametrize("kind,error,match", BAD, ids=[b[0] for b in BAD])
def test_presence_epoch_refuses_a_bad_stack(kind, error, match, which):
    args = list(presence_stacks(2, 1, "poe", True))
    args[which] = bad_stack(kind, args[which])
    p, mu, nu = state()
    with pytest.raises(error, match=match):
        fused_presence.presence_epoch_flat(
            p, mu, nu, 0, args[0], args[1], DIMS, CONSTS, HYPER, True, 1,
            "poe", args[2])
    assert torch.equal(p, state()[0])


def test_epochs_have_no_kernel_for_other_devices():
    meta = torch.empty(N, device="meta")
    x = torch.empty((1, DIMS.b, 1), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_step.epoch_flat(meta, meta, meta, 0, x, x, x, DIMS, CONSTS,
                              HYPER)
    with pytest.raises(ValueError, match="no kernel"):
        fused_presence.presence_epoch_flat(meta, meta, meta, 0, x, x, DIMS,
                                           CONSTS, HYPER, True, 0)


def test_presence_epoch_checks_mod_idx_and_method():
    xs, noise, _ = presence_stacks(1, 0, "joint_elbo", False)
    with pytest.raises(ValueError, match="mod_idx"):
        fused_presence.presence_epoch_flat(*state(), 0, xs, noise, DIMS,
                                           CONSTS, HYPER, True, 2)
    with pytest.raises(ValueError, match="unknown method"):
        fused_presence.presence_epoch_flat(*state(), 0, xs, noise, DIMS,
                                           CONSTS, HYPER, True, 0, "mopoe")


# ------------------------------------------------ the C arguments' packing
KIND_OF = {"ptr": ctypes.c_void_p, "i32": ctypes.c_int,
           "i64": ctypes.c_longlong, "f32": ctypes.c_float,
           "ptrs": fused_step.PtrArray, "i32s": fused_step.IntArray}


def check_packed(table, packed, expect):
    """``packed`` against the argument table: one value per argument, a
    Python int (or None) where the table says pointer or integer, a float
    where it says f32 and a tuple of ints where it says one per modality
    (``ptrs``, ``i32s``), each accepted by its ctypes type, and the named
    values where ``expect`` gives them."""
    assert len(packed) == len(table)
    names = [name for name, _ in table]
    assert len(set(names)) == len(names)

    def is_int(v):
        return isinstance(v, int) and not isinstance(v, bool)

    for (name, kind), value in zip(table, packed):
        if kind == "f32":
            assert isinstance(value, float), name
            KIND_OF[kind](value)  # ctypes takes it
        elif kind in ("ptrs", "i32s"):
            assert isinstance(value, tuple) and value, name
            assert all(is_int(v) for v in value), name
            KIND_OF[kind].from_param(value)
        else:
            assert value is None or is_int(value), name
            KIND_OF[kind](value)
        if name in expect:
            assert value == expect[name], name
    assert fused_step.argtypes_of(table) == [KIND_OF[k] for _, k in table]


def test_mopoe_epoch_args_follow_the_table():
    p, mu, nu = state()
    x1s, x2s, noise = stacks(3)
    grads, metrics = torch.empty_like(p), torch.empty(3, 17)
    work = torch.empty(7)
    packed = fused_step.pack_epoch_args(
        p, mu, nu, grads, metrics, x1s, x2s, noise, work, DIMS, CONSTS,
        False, 5, HYPER, 1234)
    lr, b1, b2, eps = HYPER
    check_packed(fused_step.EPOCH_ARGS, packed, {
        "params": p.data_ptr(), "mu": mu.data_ptr(), "nu": nu.data_ptr(),
        "grads": grads.data_ptr(), "metrics": metrics.data_ptr(),
        "x1s": x1s.data_ptr(), "x2s": x2s.data_ptr(),
        "noise": noise.data_ptr(), "work": work.data_ptr(), "n": 3,
        "b": DIMS.b, "d1": DIMS.d1, "d2": DIMS.d2, "h": DIMS.h,
        "cd": DIMS.cd, "s1": DIMS.s1, "s2": DIMS.s2, "beta": CONSTS.beta,
        "beta_style": CONSTS.beta_style, "beta_content": CONSTS.beta_content,
        "learn_scale": 0, "count": 5, "lr": lr, "b1": b1, "b2": b2,
        "one_minus_b1": 1.0 - b1, "one_minus_b2": 1.0 - b2,
        "log_b1": np.log(b1), "log_b2": np.log(b2), "eps": eps,
        "stream": 1234})
    # pointers first, the tracing buffer and the stream last, as the C
    # signature has them
    kinds = [k for _, k in fused_step.EPOCH_ARGS]
    assert kinds[:9] == ["ptr"] * 9 and kinds[-2:] == ["ptr", "ptr"]
    assert kinds.count("ptr") == 11 and kinds.count("i64") == 1
    assert packed[-2] is None  # no tracing unless asked for
    times = torch.zeros(3, len(fused_step.PHASES) + 1, dtype=torch.int64)
    traced = fused_step.pack_epoch_args(
        p, mu, nu, grads, metrics, x1s, x2s, noise, work, DIMS, CONSTS,
        False, 5, HYPER, 1234, times)
    assert traced[-2] == times.data_ptr() and traced[:-2] == packed[:-2]


@pytest.mark.parametrize("masked", [False, True])
def test_presence_epoch_args_follow_the_table(masked):
    p, mu, nu = state()
    xs, noise, masks = presence_stacks(2, 1, "poe", masked)
    grads, metrics = torch.empty_like(p), torch.empty(2, 10)
    work = torch.empty(7)
    packed = fused_presence.pack_epoch_args(
        p, mu, nu, grads, metrics, xs, noise, masks, work, DIMS, CONSTS,
        True, 1, "poe", 9, HYPER, 0)
    check_packed(fused_presence.EPOCH_ARGS, packed, {
        "params": p.data_ptr(), "xs": xs.data_ptr(),
        "noise": noise.data_ptr(),
        "masks": masks.data_ptr() if masked else None,
        "work": work.data_ptr(), "n": 2,
        "method": fused_presence.PORTED_METHODS.index("poe"), "mod_idx": 1,
        "b": DIMS.b, "h": DIMS.h, "learn_scale": 1, "count": 9,
        "lr": HYPER.lr, "eps": HYPER.eps, "phase_times": None, "stream": 0})


def test_adam_scalars_are_the_kernels_argument_order():
    lr, b1, b2, eps = HYPER
    assert adam_ops.adam_scalars(HYPER) == (
        lr, b1, b2, 1.0 - b1, 1.0 - b2, np.log(b1), np.log(b2), eps)
    names = [n for n, _ in fused_step.EPOCH_ARGS]
    at = names.index("lr")
    assert names[at:at + 8] == ["lr", "b1", "b2", "one_minus_b1",
                                "one_minus_b2", "log_b1", "log_b2", "eps"]
    assert [n for n, _ in fused_presence.EPOCH_ARGS][-10:] == names[-10:]


def test_phase_times_trace_the_kernel_only():
    """``phase_times`` is the persistent kernels' tracing buffer: the plain
    versions on the CPU refuse it, and its stamps turn into microseconds
    per phase."""
    n = 2
    times = torch.zeros(n, len(fused_step.PHASES) + 1, dtype=torch.int64)
    with pytest.raises(ValueError, match="phase_times"):
        fused_step.epoch_flat(*state(), 0, *stacks(n), DIMS, CONSTS, HYPER,
                              True, times)
    xs, noise, _ = presence_stacks(n, 0, "joint_elbo", False)
    with pytest.raises(ValueError, match="phase_times"):
        fused_presence.presence_epoch_flat(
            *state(), 0, xs, noise, DIMS, CONSTS, HYPER, True, 0,
            phase_times=times)
    with pytest.raises(ValueError, match="int64"):
        fused_step.check_phase_times("mopoe_step", times.device,
                                     times.float(), n)
    stamps = torch.tensor([[0, 1000, 3000, 3500, 4000, 9000, 9500, 10000,
                            12000]])
    us = fused_step.phase_microseconds(stamps)
    assert us.shape == (1, len(fused_step.PHASES))
    assert us[0].tolist() == [1.0, 2.0, 0.5, 0.5, 5.0, 0.5, 0.5, 2.0]
