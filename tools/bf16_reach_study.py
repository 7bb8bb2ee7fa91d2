"""How the bf16 check of ``chip_smoke.py`` (``judge_bf16``: the ratio rule,
then the round-off reach) treats float32 order noise and planted rounding
faults, on the CPU at the flagship widths.

The "kernel" is the port's plain bf16 version with every bfloat16 product
summed in float32 over a random permutation of its k: the same function in
another float32 order, which is what the card's kernels differ from the
plain version by. Each step of every route of ``chip_smoke.all_routes`` (B
= 256 and 64) is judged as the card judges a kernel; the planted faults
(the float32 loss and metrics, every decoder output rounded before the
loss, every bias gradient rounded) must be refused.

    python3 tools/bf16_reach_study.py [--seeds 20] [--fault-seeds 4]

Prints the count of tensor checks, those outside the ratio rule, those
outside the reach too (0 expected), the largest distance / reach, and how
many steps each fault was refused in.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from multivae_tpu_torch.ops import bf16 as bf16_ops  # noqa: E402
from multivae_tpu_torch.ops import fused_methods as fm  # noqa: E402
from multivae_tpu_torch.ops import fused_step as fs  # noqa: E402
from multivae_tpu_torch.params import flat_views  # noqa: E402


@contextlib.contextmanager
def permuted_sums(seed: int):
    """Every bf16 product of the plain versions summed in float32 over a
    random permutation of k (scheme B's backward rounded after it)."""
    gen = torch.Generator().manual_seed(seed)
    dot, dot_ct = bf16_ops.dot, bf16_ops.dot_ct
    r = bf16_ops.round_bf16

    def product(a, b):
        perm = torch.randperm(a.shape[-1], generator=gen)
        return a[..., perm] @ b[perm]

    def pdot(a, b, bf16):
        return product(r(a), r(b)) if bf16 else dot(a, b, bf16)

    def pdot_ct(a, b, bf16, cotangent):
        if not bf16:
            return dot_ct(a, b, bf16, cotangent)
        a, b = (a, r(b)) if cotangent == "a" else (r(a), b)
        return r(product(a, b))
    saved = fs.dot, fm.dot, fm.dot_ct
    fs.dot = fm.dot = pdot
    fm.dot_ct = pdot_ct
    try:
        yield
    finally:
        fs.dot, fm.dot, fm.dot_ct = saved


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--fault-seeds", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    consts = fs.FusedConsts(1.0, 0.7, 1.2)
    checks = outside_ratio = outside = 0
    worst = (0.0, "")
    refused = {}
    for seed in range(args.seeds):
        for b in (256, 64):
            _, dims, p, _, _, _ = cs.train_setup("cpu", b, 100 + seed)
            gen = torch.Generator().manual_seed(7 + seed)
            for r in cs.all_routes():
                if b == 64 and r.kind == "presence":
                    continue
                route = cs.Route(r.kind, r.method, r.mod_idx, r.masked,
                                 bf16=True)
                f32 = cs.Route(r.kind, r.method, r.mod_idx, r.masked)
                inp = route.inputs(dims, gen, "cpu")

                def plain(bf16):
                    return (route if bf16 else f32).step(
                        "plain", p, inp, dims, consts)
                with permuted_sums(10_000 + seed):
                    ker = plain(True)
                _, verdict = cs.judge_bf16(ker, plain, dims)
                for name, (rule, d, _, reach) in verdict.items():
                    checks += 1
                    if rule not in ("ratio", "round-off"):
                        outside_ratio += 1
                        worst = max(worst, (d / reach if reach else 0.0,
                                            f"{route.name} B={b} {name}"))
                    outside += rule is None
                if seed >= args.fault_seeds:
                    continue
                (m16, g16), (m32, _) = plain(True), plain(False)
                with cs.rounded_decoder_outputs(dims):
                    faults = {"float32 loss and metrics": (m32, g16),
                              "decoder outputs rounded": plain(True)}
                g = g16.clone()
                for name, view in flat_views(g, dims).items():
                    if "_b" in name:
                        view.copy_(bf16_ops.round_bf16(view))
                faults["bias gradients rounded"] = (m16, g)
                for fault, out in faults.items():
                    _, verdict = cs.judge_bf16(out, plain, dims)
                    hit = any(v[0] is None for v in verdict.values())
                    n, total = refused.get(fault, (0, 0))
                    refused[fault] = (n + hit, total + 1)
    print(f"tensor checks {checks}; outside the ratio rule {outside_ratio}; "
          f"outside the round-off reach too {outside}; largest distance / "
          f"reach {worst[0]:.3f} ({worst[1]})")
    for fault, (n, total) in refused.items():
        print(f"planted fault {fault}: refused in {n} of {total} steps")


if __name__ == "__main__":
    main()
