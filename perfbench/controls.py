#!/usr/bin/env python3
"""The readings the comparison's limits are set from, at a cell's own
size on the card: for each seed, the program's numbers (a sound run) and
those of the plain reference put in the program's place with each fault
the comparison has to catch (``control_readings`` of the cell's traffic).

    python3 perfbench/controls.py --workload <name> --seeds 1 2 3 ...

Prints one JSON line per seed. Set-up is the cell's (a DAA warm-up call
of one round), and the window is of zero seconds: one epoch, the one the
train cell's comparison follows, or one call.
"""

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell, config = harness.manifest_cell(manifest, args.workload)
    cfg = harness.load_json(ROOT / config["file"])
    cfg.update(daa_warmup_rounds=1)
    traffic = harness.load_module(
        harness.HERE / "traffic" / f"{cell['traffic']}.py",
        "perfbench.traffic." + harness._ident(cell["traffic"]))
    device = torch.device(args.device)
    for seed in args.seeds:
        workdir = tempfile.mkdtemp(prefix="perfbench-controls-")
        try:
            ctx = harness.Ctx(args.workload, cfg, {}, seed, 0.0, False,
                              device, workdir, time.perf_counter())
            state = traffic.setup(ctx)
            traffic.window(state, ctx)  # zero seconds: one epoch or call
            out = traffic.outputs(state)
            del state
            gc.collect()
            readings = traffic.control_readings(ctx, out)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "readings": readings}), flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
