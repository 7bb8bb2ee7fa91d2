#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card of this machine.

    python3 perfbench/run.py --threads N --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Prints, as the last lines of standard output, a line of host facts and the
result line (JSON); as the last lines of standard error, each number the
comparison with the plain reference decided ``correct`` by, beside its
limit. Exits non-zero, printing no result, without a CUDA card, or when a
module of JAX or the JAX package is loaded once the window has closed.

The thread pools of OpenMP, MKL, OpenBLAS and torch are fixed to
``--threads`` before numpy or torch is imported: the host paces these
workloads, and pools sized by the library on shared cores make its runs
spread. The program's kernel builds stay in ``build/`` of the checkout.
"""

import argparse
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--threads", type=int, required=True,
                    help="thread count of every pool, at least 1")
    args = ap.parse_args(argv)
    if args.threads < 1:
        ap.error("--threads must be at least 1")
    return args


def main(argv=None) -> int:
    args = parse(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(args.threads)
    cache = os.path.join(ROOT, "build", "perfbench-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    if not os.path.isfile(os.path.join(ROOT, "BENCHMARK.json")):
        print("perfbench: no BENCHMARK.json at the checkout's root",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(args.threads)
    from perfbench import harness

    manifest = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, _ = harness.manifest_cell(manifest, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from pathlib import Path

    result, compared, host = harness.run_cell(
        Path(ROOT), args.workload, args.seed, args.seconds,
        bool(args.trace), "cuda:0", T_START, args.threads)
    return harness.emit(result, compared, host)


if __name__ == "__main__":
    sys.exit(main())
