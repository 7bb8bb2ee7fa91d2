"""The one-launch epoch entry points of the persistent method and
layer-stack step kernels (``fused_methods.method_epoch_flat``,
``fused_generic.generic_epoch_flat``) on the CPU: what they check before a
launch, how the C arguments are packed, and that a group of one step is the
step followed by the Adam update.

On CUDA tensors a group of steps is ONE launch of ``csrc/method_step.cu`` /
``csrc/generic_step.cu`` (``method_epoch_launch``, ``generic_epoch_launch``)
with Adam inside; the packing functions are pure Python and are held here to
the ``(name, kind)`` tables the ``argtypes`` are made from. On CPU tensors
the host loops the plain step and the plain Adam, and the results must be
bit for bit the step followed by ``adam_update``. The agreement of those
loops with the JAX package's epoch kernels is in
``test_torch_port_methods.py`` and ``test_torch_port_generic.py``.
"""

import numpy as np
import pytest
import torch

from multivae_tpu_torch import params as bridge
from multivae_tpu_torch.ops import adam as adam_ops
from multivae_tpu_torch.ops import fused_generic, fused_methods, fused_step

from test_torch_port_epoch import BAD, bad_stack, check_packed

DIMS = bridge.FusedDims(b=12, d1=3, d2=12, h=16, cd=4, s1=2, s2=3)
CONSTS = fused_step.FusedConsts(1.3, 0.7, 1.2)
HYPER = adam_ops.AdamHyper(2e-3, 0.9, 0.999)
RATE = 0.2
# (n_enc, n_dec, per-sample scale): the two deep train slices' shapes
ARCHS = {"deep-A": (1, 1, True), "deep-B": (2, 1, False)}


def gdims(arch, b=DIMS.b):
    n_enc, n_dec, sample = ARCHS[arch]
    return bridge.GenericDims(b=b, d1=DIMS.d1, d2=DIMS.d2, h=DIMS.h,
                              cd=DIMS.cd, s1=DIMS.s1, s2=DIMS.s2,
                              n_enc=n_enc, n_dec=n_dec, sample_scale=sample)


def state(dims, seed=0):
    n = bridge.flat_size(dims)
    rng = np.random.default_rng(seed)
    p = torch.from_numpy((0.3 * rng.normal(size=n)).astype(np.float32))
    mu = torch.from_numpy((0.01 * rng.normal(size=n)).astype(np.float32))
    nu = torch.from_numpy((1e-4 * rng.random(size=n)).astype(np.float32))
    return p, mu, nu


def stacks(dims, method, n_masks, n, seed=1):
    """``(x1s, x2s, noise, masks)`` of ``n`` steps; masks ``[n, n_masks, B,
    hidden]`` of pre-scaled keep values, or None for ``n_masks`` 0."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    b = dims.b
    out = (f(n, b, dims.d1), f(n, b, dims.d2),
           f(n, b, fused_methods.step_noise_width(method, dims)))
    masks = None
    if n_masks:
        keep = rng.random(size=(n, n_masks, b, dims.h)) < 1.0 - RATE
        masks = torch.from_numpy((keep / (1.0 - RATE)).astype(np.float32))
    return out + (masks,)


def method_masks(method, masked):
    return fused_methods.n_dropout_masks(method, RATE if masked else 0.0)


def generic_masks(method, masked, dims):
    return fused_generic.n_dropout_masks(method, RATE if masked else 0.0,
                                         dims.n_enc, dims.n_dec)


# ------------------------------------------------- a group of one step
@pytest.mark.parametrize("count", [0, 5])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method", fused_methods.METHODS)
def test_method_epoch_of_one_is_step_then_adam(method, masked, count):
    x1s, x2s, noise, masks = stacks(DIMS, method,
                                    method_masks(method, masked), 1)
    p, mu, nu = state(DIMS)
    metrics = fused_methods.method_epoch_flat(
        method, p, mu, nu, count, x1s, x2s, noise, DIMS, CONSTS, HYPER, True,
        masks)
    q, qm, qv = state(DIMS)
    m, g = fused_methods.method_step_flat(
        method, q, x1s[0], x2s[0], noise[0], DIMS, CONSTS, True,
        None if masks is None else masks[0])
    adam_ops.adam_update(q, qm, qv, g, count + 1, HYPER)
    assert metrics.shape == (1, fused_methods.n_method_metrics(method))
    for got, want in ((metrics[0], m), (p, q), (mu, qm), (nu, qv)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("count", [0, 5])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method", ["joint_elbo", "poe"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_generic_epoch_of_one_is_step_then_adam(arch, method, masked, count):
    dims = gdims(arch)
    x1s, x2s, noise, masks = stacks(dims, method,
                                    generic_masks(method, masked, dims), 1)
    p, mu, nu = state(dims)
    names = fused_generic.method_metric_names(_Model, method)
    order = fused_generic.metric_permutation(_Model, method)
    metrics = fused_generic.generic_epoch_flat(
        method, p, mu, nu, count, x1s, x2s, noise, dims, CONSTS, HYPER, True,
        masks, order)
    q, qm, qv = state(dims)
    m, g = fused_generic.generic_step_flat(
        method, q, x1s[0], x2s[0], noise[0], dims, CONSTS, True,
        None if masks is None else masks[0])
    adam_ops.adam_update(q, qm, qv, g, count + 1, HYPER)
    assert metrics.shape == (1, len(names))
    assert torch.equal(metrics[0], m[torch.as_tensor(order)])
    for got, want in ((p, q), (mu, qm), (nu, qv)):
        assert torch.equal(got, want)


class _Modality:
    def __init__(self, name):
        self.name = name


class _Model:
    modalities = [_Modality("clinical"), _Modality("rois")]


def test_epochs_count_nothing_on_the_cpu():
    """On the CPU the plain versions run: neither a launch nor a step of a
    launch is counted, and every counted kernel has a step count."""
    before = (dict(fused_methods.KERNEL_LAUNCHES),
              dict(fused_methods.KERNEL_STEPS),
              dict(fused_generic.KERNEL_LAUNCHES),
              dict(fused_generic.KERNEL_STEPS),
              dict(adam_ops.KERNEL_LAUNCHES))
    fused_methods.method_epoch_flat("moe", *state(DIMS), 0,
                                    *stacks(DIMS, "moe", 0, 2)[:3], DIMS,
                                    CONSTS, HYPER)
    dims = gdims("deep-A")
    fused_generic.generic_epoch_flat("jsd", *state(dims), 0,
                                     *stacks(dims, "jsd", 0, 2)[:3], dims,
                                     CONSTS, HYPER)
    assert before == (fused_methods.KERNEL_LAUNCHES,
                      fused_methods.KERNEL_STEPS,
                      fused_generic.KERNEL_LAUNCHES,
                      fused_generic.KERNEL_STEPS, adam_ops.KERNEL_LAUNCHES)
    assert set(fused_methods.KERNEL_STEPS) == set(
        fused_methods.KERNEL_LAUNCHES)
    assert set(fused_generic.KERNEL_STEPS) == set(
        fused_generic.KERNEL_LAUNCHES)


# ----------------------------------------------- what a launch refuses
@pytest.mark.parametrize("which", [0, 1, 2, 3],
                         ids=["x1s", "x2s", "noise", "masks"])
@pytest.mark.parametrize("kind,error,match", BAD, ids=[b[0] for b in BAD])
def test_method_epoch_refuses_a_bad_stack(kind, error, match, which):
    args = list(stacks(DIMS, "poe", 4, 2))
    args[which] = bad_stack(kind, args[which])
    p, mu, nu = state(DIMS)
    with pytest.raises(error, match=match):
        fused_methods.method_epoch_flat("poe", p, mu, nu, 0, *args[:3], DIMS,
                                        CONSTS, HYPER, True, args[3])
    assert torch.equal(p, state(DIMS)[0])  # nothing ran


@pytest.mark.parametrize("which", [0, 1, 2, 3],
                         ids=["x1s", "x2s", "noise", "masks"])
@pytest.mark.parametrize("kind,error,match", BAD, ids=[b[0] for b in BAD])
def test_generic_epoch_refuses_a_bad_stack(kind, error, match, which):
    dims = gdims("deep-B")
    args = list(stacks(dims, "moe", generic_masks("moe", True, dims), 2))
    args[which] = bad_stack(kind, args[which])
    p, mu, nu = state(dims)
    with pytest.raises(error, match=match):
        fused_generic.generic_epoch_flat("moe", p, mu, nu, 0, *args[:3],
                                         dims, CONSTS, HYPER, True, args[3])
    assert torch.equal(p, state(dims)[0])


def test_epochs_refuse_the_wrong_mask_count():
    x1s, x2s, noise, masks = stacks(DIMS, "poe", 2, 1)  # poe takes 4
    with pytest.raises(ValueError, match="shape"):
        fused_methods.method_epoch_flat("poe", *state(DIMS), 0, x1s, x2s,
                                        noise, DIMS, CONSTS, HYPER, True,
                                        masks)
    dims = gdims("deep-A")
    x1s, x2s, noise, masks = stacks(dims, "moe", 3, 1)  # moe takes 4
    with pytest.raises(ValueError, match="shape"):
        fused_generic.generic_epoch_flat("moe", *state(dims), 0, x1s, x2s,
                                         noise, dims, CONSTS, HYPER, True,
                                         masks)


def test_epochs_check_the_method_and_the_device():
    x = stacks(DIMS, "moe", 0, 1)[:3]
    with pytest.raises(ValueError, match="unknown method"):
        fused_methods.method_epoch_flat("mopoe", *state(DIMS), 0, *x, DIMS,
                                        CONSTS, HYPER)
    dims = gdims("deep-A")
    with pytest.raises(ValueError, match="unknown method"):
        fused_generic.generic_epoch_flat("mopoe", *state(dims), 0, *x, dims,
                                         CONSTS, HYPER)
    meta = torch.empty(bridge.flat_size(DIMS), device="meta")
    xm = torch.empty((1, DIMS.b, 1), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_methods.method_epoch_flat("moe", meta, meta, meta, 0, xm, xm,
                                        xm, DIMS, CONSTS, HYPER)
    gm = torch.empty(bridge.flat_size(dims), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_generic.generic_epoch_flat("moe", gm, gm, gm, 0, xm, xm, xm,
                                         dims, CONSTS, HYPER)


def test_phase_times_trace_the_kernels_only():
    """``phase_times`` is the persistent kernels' tracing buffer: the plain
    versions on the CPU refuse it."""
    n = 2
    times = torch.zeros(n, len(fused_step.PHASES) + 1, dtype=torch.int64)
    with pytest.raises(ValueError, match="phase_times"):
        fused_methods.method_epoch_flat(
            "jsd", *state(DIMS), 0, *stacks(DIMS, "jsd", 0, n)[:3], DIMS,
            CONSTS, HYPER, True, None, times)
    dims = gdims("deep-B")
    gtimes = torch.zeros(n, len(fused_generic.phases(dims)) + 1,
                         dtype=torch.int64)
    with pytest.raises(ValueError, match="phase_times"):
        fused_generic.generic_epoch_flat(
            "jsd", *state(dims), 0, *stacks(dims, "jsd", 0, n)[:3], dims,
            CONSTS, HYPER, True, None, None, gtimes)
    with pytest.raises(ValueError, match=r"\[2, 13\]"):
        fused_step.check_phase_times("generic_step", gtimes.device,
                                     gtimes[:, :-1], n,
                                     len(fused_generic.phases(dims)))


@pytest.mark.parametrize("n_enc,n_dec", [(1, 0), (1, 1), (2, 1), (3, 2),
                                         (4, 4)])
def test_generic_phases_follow_the_depths(n_enc, n_dec):
    dims = bridge.GenericDims(b=4, d1=3, d2=5, h=8, cd=2, s1=1, s2=2,
                              n_enc=n_enc, n_dec=n_dec, sample_scale=False)
    names = fused_generic.phases(dims)
    assert len(names) == 2 * (n_enc + n_dec) + 6
    assert len(set(names)) == len(names)
    assert names[:n_enc] == tuple(f"enc {i}" for i in range(n_enc))
    assert names[n_enc:n_enc + 2] == ("heads", "latents")
    assert ("z grads" in names) == (n_dec > 0)
    assert names.index("output") < names.index("output grads") \
        < names.index("latents backward") < names.index("heads grads")
    assert names[-1].startswith("enc 0 grads")


# ------------------------------------------------ the C arguments' packing
@pytest.mark.parametrize("masked", [False, True])
def test_method_epoch_args_follow_the_table(masked):
    p, mu, nu = state(DIMS)
    x1s, x2s, noise, masks = stacks(DIMS, "poe", 4 if masked else 0, 3)
    grads, metrics = torch.empty_like(p), torch.empty(3, 19)
    work = torch.empty(7)
    packed = fused_methods.pack_epoch_args(
        p, mu, nu, grads, metrics, x1s, x2s, noise, masks, work, "poe", DIMS,
        CONSTS, False, 5, HYPER, 1234)
    lr, b1, b2, eps = HYPER
    check_packed(fused_methods.EPOCH_ARGS, packed, {
        "params": p.data_ptr(), "mu": mu.data_ptr(), "nu": nu.data_ptr(),
        "grads": grads.data_ptr(), "metrics": metrics.data_ptr(),
        "x1s": x1s.data_ptr(), "x2s": x2s.data_ptr(),
        "noise": noise.data_ptr(),
        "masks": masks.data_ptr() if masked else None,
        "work": work.data_ptr(), "n": 3,
        "method": fused_methods.METHODS.index("poe"), "b": DIMS.b,
        "d1": DIMS.d1, "d2": DIMS.d2, "h": DIMS.h, "cd": DIMS.cd,
        "s1": DIMS.s1, "s2": DIMS.s2, "beta": CONSTS.beta,
        "beta_style": CONSTS.beta_style, "beta_content": CONSTS.beta_content,
        "learn_scale": 0, "count": 5, "lr": lr, "b1": b1, "b2": b2,
        "one_minus_b1": 1.0 - b1, "one_minus_b2": 1.0 - b2,
        "log_b1": np.log(b1), "log_b2": np.log(b2), "eps": eps,
        "phase_times": None, "stream": 1234})
    # the Adam scalars, the tracing buffer and the stream close the list as
    # in the other persistent kernels' tables
    names = [n for n, _ in fused_methods.EPOCH_ARGS]
    assert names[-10:] == [n for n, _ in fused_step.EPOCH_ARGS][-10:]
    times = torch.zeros(3, len(fused_step.PHASES) + 1, dtype=torch.int64)
    traced = fused_methods.pack_epoch_args(
        p, mu, nu, grads, metrics, x1s, x2s, noise, masks, work, "poe", DIMS,
        CONSTS, False, 5, HYPER, 1234, times)
    assert traced[-2] == times.data_ptr() and traced[:-2] == packed[:-2]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_generic_epoch_args_follow_the_table(arch):
    dims = gdims(arch)
    p, mu, nu = state(dims)
    x1s, x2s, noise, masks = stacks(dims, "jsd",
                                    generic_masks("jsd", True, dims), 2)
    grads, metrics = torch.empty_like(p), torch.empty(2, 17)
    work = torch.empty(7)
    packed = fused_generic.pack_epoch_args(
        p, mu, nu, grads, metrics, x1s, x2s, noise, masks, work, "jsd", dims,
        CONSTS, True, 9, HYPER, 0)
    check_packed(fused_generic.EPOCH_ARGS, packed, {
        "params": p.data_ptr(), "x1s": x1s.data_ptr(),
        "x2s": x2s.data_ptr(), "noise": noise.data_ptr(),
        "masks": masks.data_ptr(), "work": work.data_ptr(), "n": 2,
        "method": fused_generic.METHODS.index("jsd"), "b": dims.b,
        "h": dims.h, "n_enc": dims.n_enc, "n_dec": dims.n_dec,
        "sample_scale": int(dims.sample_scale), "learn_scale": 1,
        "likelihood": 0, "count": 9, "lr": HYPER.lr, "eps": HYPER.eps,
        "phase_times": None, "stream": 0})
    # the method kernel's arguments with the depths, the scale mode and the
    # likelihood after the widths
    depth = ("n_enc", "n_dec", "sample_scale", "likelihood")
    names = [n for n, _ in fused_generic.EPOCH_ARGS]
    assert [n for n in names if n not in depth] == [
        n for n, _ in fused_methods.EPOCH_ARGS]
    assert names[names.index("s2") + 1:names.index("s2") + 5] == list(depth)
