"""One run of one cell: set-up, the measured window, the metrics, the
comparison with the plain reference, and the result line.

:func:`run_cell` does everything but look for a card, so the tests drive
it on the CPU at a small size; ``run.py`` is the entry point that does.
The cell's pieces are found by name: ``configs/<config>.json`` (the file
``BENCHMARK.json`` names), ``traffic/<traffic>.py``,
``metrics/<metric>.py`` and ``limits/<workload>.json``.

A traffic module provides ``setup(ctx)``, ``window(state, ctx)``,
``end_to_end(state, done)``, ``counts(ctx, state, done)``,
``outputs(state)``, ``judge(ctx, outputs)`` and ``SPANS``, the program's
functions (``"module:attribute"``) that a traced run wraps in spans.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "multivae_tpu")
WINDOW_SPAN = "perfbench.window"


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ident(name: str) -> str:
    """A module name for a file named after ``name``."""
    return "m_" + "".join(ch if ch.isalnum() else "_" for ch in name)


def manifest_cell(manifest: dict, workload: str):
    """``(cell, config entry)`` of ``workload`` in the manifest."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    return cell, configs[cell["config"]]


def cell_metrics(manifest: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in manifest[kind]
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is that of JAX or the JAX
    package, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


class Ctx:
    """What a traffic module is given: the cell's config, seed, device,
    window length, trace flag and a work directory; :meth:`mark` closes a
    part of the set-up split."""

    def __init__(self, workload: str, cfg: dict, limits: dict, seed: int,
                 seconds: float, trace: bool, device, workdir: str,
                 t_start: float):
        self.workload, self.cfg, self.limits = workload, cfg, limits
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.workdir = device, workdir
        self.split: Dict[str, float] = {}
        self.notes: Dict[str, object] = {}
        self._last = t_start

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, part: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.split[part] = self.split.get(part, 0.0) + now - self._last
        self._last = now


@contextlib.contextmanager
def spans(paths):
    """Wrap each ``"module:attribute"`` function in a
    ``torch.profiler.record_function`` span named ``module.attribute``
    (the module's path less the package), restored afterwards."""
    import torch

    saved = []
    try:
        for path in paths:
            mod_name, attr = path.split(":")
            mod = importlib.import_module(mod_name)
            owner, leaf = mod, attr
            if "." in attr:
                cls, leaf = attr.split(".")
                owner = getattr(mod, cls)
            fn = getattr(owner, leaf)
            label = ".".join(mod_name.split(".")[-2:]) + "." + attr

            def wrapped(*a, _fn=fn, _label=label, **k):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **k)
            saved.append((owner, leaf, fn))
            setattr(owner, leaf, wrapped)
        yield
    finally:
        for owner, leaf, fn in reversed(saved):
            setattr(owner, leaf, fn)


class TraceView:
    """The traced window read from the profiler's Chrome trace: device
    activity, the harness's spans, kernels by name."""

    DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

    def __init__(self, path: str, warm_up_kernel: str):
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        events = [e for e in events if e.get("ph") == "X"]
        win = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no window span")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.device = []
        for e in events:
            if e.get("cat") not in self.DEVICE_CATS:
                continue
            if warm_up_kernel in e.get("name", ""):
                continue
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e.get("dur", 0.0)), self.t1)
            if b > a:
                self.device.append((a, b, e["name"],
                                    e.get("args", {}).get("correlation")))
        self.device.sort()
        self.spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in events
                      if e.get("cat") == "user_annotation"
                      and e.get("name") != WINDOW_SPAN]
        self.runtime = [(float(e["ts"]), e.get("args", {}).get("correlation"))
                        for e in events if e.get("cat") == "cuda_runtime"]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def merged(self):
        out = []
        for a, b, _, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged()) / 1e6

    def span_seconds(self, name: str) -> float:
        """Host seconds inside the spans named ``name`` (outermost)."""
        return self._union([(a, b) for a, b, n in self.spans
                            if n == name]) / 1e6

    @staticmethod
    def _union(intervals) -> float:
        total, end = 0.0, -math.inf
        for a, b in sorted(intervals):
            if b <= end:
                continue
            total += b - max(a, end)
            end = b
        return total

    def device_seconds_in(self, name: str) -> float:
        """Device seconds of the work launched inside the spans named
        ``name`` (by the launches' correlation ids)."""
        inside = [(a, b) for a, b, n in self.spans if n == name]
        ids = set()
        for ts, corr in self.runtime:
            if corr is not None and any(a <= ts <= b for a, b in inside):
                ids.add(corr)
        return sum(b - a for a, b, _, c in self.device if c in ids) / 1e6

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name holds one of
        ``names``."""
        return sum(b - a for a, b, n, _ in self.device
                   if any(k in n for k in names)) / 1e6

    def top_ops(self, n: int = 10):
        by: Dict[str, float] = {}
        for a, b, name, _ in self.device:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k[:64], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The longest gaps between device activity in the window, each
        named by the innermost span around its middle ("host" if none)."""
        edges = [self.t0] + [x for ab in self.merged() for x in ab] + [self.t1]
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b - a <= 0:
                continue
            mid = 0.5 * (a + b)
            around = [(e - s, name) for s, e, name in self.spans
                      if s <= mid <= e]
            gaps.append([min(around)[1] if around else "host",
                         (b - a) / 1e6])
        return sorted(gaps, key=lambda g: -g[1])[:n]


class LayerView:
    """What a per-layer metric reader gets: the trace, and the window's
    units and the traffic's counts (``counts``)."""

    def __init__(self, trace: Optional[TraceView], counts: dict):
        self.trace, self.counts = trace, counts


def host_line(ctx: Ctx, threads: int) -> dict:
    """The run's host facts: CPU affinity, load average, thread count, the
    set-up split and the bytes this process wrote."""
    try:
        with open("/proc/loadavg") as fh:
            load = fh.read().split()[:3]
    except OSError:
        load = []
    io = {}
    try:
        with open("/proc/self/io") as fh:
            for line in fh:
                k, v = line.split(":")
                io[k.strip()] = int(v)
    except OSError:
        pass
    return {"host": {"affinity": len(os.sched_getaffinity(0)),
                     "loadavg": load, "threads": threads,
                     "setup_split_s": ctx.split, "window": ctx.notes,
                     "write_bytes": io.get("write_bytes"),
                     "wchar": io.get("wchar")}}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, threads: int,
             cfg_overrides: Optional[dict] = None):
    """One run of ``workload``; returns ``(result, compared, host)``:
    the result line's object, the compared numbers ``[(name, value,
    limit)]`` and the host line. ``cfg_overrides`` resizes the config
    (the tests' small sizes)."""
    import torch

    manifest = load_json(root / "BENCHMARK.json")
    cell, config = manifest_cell(manifest, workload)
    cfg = load_json(root / config["file"])
    cfg.update(cfg_overrides or {})
    limits = load_json(HERE / "limits" / f"{workload}.json")
    traffic = load_module(HERE / "traffic" / f"{cell['traffic']}.py",
                          "perfbench.traffic." + _ident(cell["traffic"]))
    device = torch.device(device)
    workdir = tempfile.mkdtemp(prefix=f"perfbench-{workload}-")
    try:
        ctx = Ctx(workload, cfg, limits, seed, seconds, trace, device,
                  workdir, t_start)
        state = traffic.setup(ctx)
        setup_s = time.perf_counter() - t_start

        def timed_window():
            t0 = time.perf_counter()
            done = traffic.window(state, ctx)
            ctx.sync()
            return done, time.perf_counter() - t0

        view = None
        if trace:
            from multivae_tpu_torch.train import profiling

            trace_dir = os.path.join(workdir, "trace")
            with spans(traffic.SPANS), profiling.trace(trace_dir, device), \
                    torch.profiler.record_function(WINDOW_SPAN):
                done, wall = timed_window()
            view = TraceView(profiling.trace_path(trace_dir, 0),
                             profiling.WARM_UP_KERNEL)
            shutil.rmtree(trace_dir, ignore_errors=True)
        else:
            done, wall = timed_window()
        done["wall_s"] = wall
        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
               "count": 1,
               "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(
                   device)) if device.type == "cuda" else 0)}
        metrics = {}
        breakdown = None
        if trace:
            layer = LayerView(view, traffic.counts(ctx, state, done))
            for m in cell_metrics(manifest, workload, "per_layer"):
                reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                     "perfbench.metrics." + _ident(m["name"]))
                value = reader.read(layer)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            dev["busy_s"] = view.busy_s
            dev["window_s"] = view.window_s
            breakdown = {"device_ops": view.top_ops(),
                         "idle_gaps": view.idle_gaps()}
        else:
            values = traffic.end_to_end(state, done)
            values["setup_s"] = setup_s
            for m in cell_metrics(manifest, workload, "end_to_end"):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        outputs = traffic.outputs(state)
        del state
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        compared = traffic.judge(ctx, outputs)
        correct = all(math.isfinite(v) and v <= lim for _, v, lim in compared)
        result = {"correct": bool(correct), "attempted": done["attempted"],
                  "failed": done["failed"], "metrics": metrics,
                  "device": dev}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["compared"] = {n: {"value": v, "limit": lim}
                              for n, v, lim in compared}
        return result, compared, host_line(ctx, threads)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def emit(result: dict, compared, host: dict) -> int:
    """Print the host line, the result line (stdout's last) and the
    compared numbers (stderr's last lines); 1 if a forbidden module is
    loaded (then no result), else 0."""
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 1
    print(json.dumps(host), flush=True)
    print(json.dumps(result), flush=True)
    for name, value, limit in compared:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0
