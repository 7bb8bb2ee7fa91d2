"""The port's tracer (``multivae_tpu_torch/train/profiling.py``) on the CPU:
the trace it writes, and its summaries of a profile, which leave out the
warm-up kernels it launches at a card's window start; its spans, inside and
outside a profiler session, and a window's counts."""

import contextlib
import json
from types import SimpleNamespace

import torch

from multivae_tpu_torch.train import profiling


class _Profile:
    """A stand-in for ``torch.profiler.profile``: ``key_averages`` only."""

    def __init__(self, rows):
        self.rows = [SimpleNamespace(key=k, count=n,
                                     self_device_time_total=us)
                     for k, n, us in rows]

    def key_averages(self):
        return self.rows


WARM_UP = f"at::cuda::(anonymous namespace)::{profiling.WARM_UP_KERNEL}(long)"
ROWS = [(WARM_UP, 11, 7.0),
        ("void (anonymous namespace)::mopoe_steps_kernel<false>", 2, 353.0),
        ("Memcpy HtoD (Pageable -> Device)", 5, 40.0),
        ("aten::add_", 3, 0.0)]


def test_trace_on_cpu_writes_a_chrome_trace_of_the_block(tmp_path):
    with profiling.trace(str(tmp_path), "cpu", 3) as prof:
        torch.ones(8, 8).matmul(torch.ones(8, 8))
    path = profiling.trace_path(str(tmp_path), 3)
    assert path.endswith("epoch_0003.pt.trace.json")
    with open(path) as fh:
        names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
    assert "aten::matmul" in names
    # no warm-up on the CPU
    assert profiling.warm_up_kept(prof) == 0


def test_device_ms_by_name_leaves_out_the_warm_up_and_idle_names():
    # exact: the sums are the rows' own numbers over 1e3
    assert profiling.device_ms_by_name(_Profile(ROWS)) == {
        "void (anonymous namespace)::mopoe_steps_kernel<false>": 0.353,
        "Memcpy HtoD (Pageable -> Device)": 0.04}


def test_warm_up_kept_counts_the_warm_up_kernels_only():
    assert profiling.warm_up_kept(_Profile(ROWS)) == 11
    assert profiling.warm_up_kept(_Profile(ROWS[1:])) == 0


def _annotations(path):
    with open(path) as fh:
        return [ev for ev in json.load(fh)["traceEvents"]
                if ev.get("cat") == "user_annotation"]


def test_span_outside_a_session_is_one_shared_null_context():
    a, b = profiling.span("trainer.gather"), profiling.span("daa.fetch")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)

    @profiling.spanned("trainer.noise")
    def f(x, y=1):
        """doc"""
        return x + y
    assert f(2, y=3) == 5 and f.__name__ == "f" and f.__doc__ == "doc"


def test_spans_land_in_a_trace_block_and_in_any_profiler_session(tmp_path):
    with profiling.trace(str(tmp_path / "a"), "cpu"):
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
    spans = {ev["name"]: ev for ev in _annotations(
        profiling.trace_path(str(tmp_path / "a"), 0))}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # a torch.profiler session of its own, not the port's tracer
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.span("x") is not profiling.span("x")
        with profiling.span("own_session"):
            torch.ones(4).sum()
    prof.export_chrome_trace(str(tmp_path / "b.json"))
    assert "own_session" in {ev["name"] for ev in
                             _annotations(tmp_path / "b.json")}


def test_kernel_counters_are_the_ops_modules_own_dicts():
    from multivae_tpu_torch.ops import adam, fused_daa, fused_presence, \
        fused_step

    launches = profiling.kernel_counters("launches")
    steps = profiling.kernel_counters("steps")
    assert launches["mopoe_step"] is fused_step.KERNEL_LAUNCHES
    assert launches["flat_adam"] is adam.KERNEL_LAUNCHES
    assert launches["avatar_sweep"] is fused_daa.KERNEL_LAUNCHES
    assert steps["presence_step"] is fused_presence.KERNEL_STEPS
    assert set(steps) < set(launches)
    assert "avatar_sweep" not in steps and "flat_adam" not in steps


def test_a_window_counts_only_what_it_ran(tmp_path, monkeypatch):
    from multivae_tpu_torch.ops import fused_presence, fused_step

    # the module dicts are the process's: put them back afterwards
    for counters in (fused_step.KERNEL_LAUNCHES, fused_step.KERNEL_STEPS,
                     fused_presence.KERNEL_LAUNCHES):
        for k, v in counters.items():
            monkeypatch.setitem(counters, k, v)
    profiling.count("h2d_bytes", 1000)          # before: not in the window
    fused_step.KERNEL_LAUNCHES["mopoe_step"] += 5
    with profiling.trace(str(tmp_path), "cpu"):
        profiling.count("h2d_bytes", 24)
        profiling.count("h2d_bytes", 8)
        profiling.count("a_new_counter", 3)
        fused_step.KERNEL_LAUNCHES["mopoe_step"] += 2
        fused_step.KERNEL_STEPS["mopoe_step"] += 16
        fused_presence.KERNEL_LAUNCHES["presence_step"] += 1
    profiling.count("h2d_bytes", 77)            # after: not in it either
    got = profiling.last_counts()
    assert got["h2d_bytes"] == 32 and got["a_new_counter"] == 3
    assert got["launches.mopoe_step"] == 2 and got["steps.mopoe_step"] == 16
    assert got["launches.presence_step"] == 1
    assert got["launches.flat_adam"] == 0 and got["launches.avatar_sweep"] == 0
    # the module dicts keep counting for the process, as their readers want
    assert fused_step.KERNEL_LAUNCHES["mopoe_step"] >= 7
    # a copy: the caller cannot change the window's counts
    got["h2d_bytes"] = 0
    assert profiling.last_counts()["h2d_bytes"] == 32
    with profiling.trace(str(tmp_path), "cpu"):
        pass
    assert profiling.last_counts()["h2d_bytes"] == 0
