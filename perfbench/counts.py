"""Operations and bytes of the work a cell asks for, from the config's
shapes, whatever implements it.

Training (the arithmetic of ``chip_smoke.py``'s ``step_flops`` and
``generic_flops``, which ``bench.py``'s ``flops_per_step`` also counts at
6 per multiply-add): per row and present modality, 4 per multiply-add of
an encoder's first layer (its forward and weight gradient; nothing takes
the gradient of the data) and 6 per multiply-add of every other product
(forward, weight gradient, the gradient of its input). The flagship step
at B = 256 is 195.3 MFLOP.

The DAA (``chip_smoke.py``'s sweep bound): 2 per multiply-add of the
forward products a cell needs, the clinical encoder's hidden layers and
content heads and the ROI decoder's mean; the ROI encoder once per round.

Peaks: one H100 SXM's data sheet, float32 outside the tensor cores
(every product of the port's kernels is a float32 FMA) and HBM3.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

from .weights import leaf_shapes, mod_names, style_dims

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12


def n_params(cfg: dict) -> int:
    return sum(math.prod(s) for s, _ in leaf_shapes(cfg).values())


def _dec_widths(cfg: dict, d: int, s: int, loc_only: bool):
    out = d if (loc_only or not cfg["learn_output_sample_scale"]) else 2 * d
    return ([s + cfg["class_dim"]] + [cfg["hidden_dim"]]
            * cfg["num_hidden_layer_decoder"] + [out])


def step_flops(cfg: dict, rows: int, present: Iterable[str]) -> float:
    """Matmul FLOPs of one training step on a batch of ``rows`` rows with
    the modalities ``present``."""
    h, cd = cfg["hidden_dim"], cfg["class_dim"]
    passes = 2 if cfg["method"] == "poe" else 1
    per_row = 0
    for m, d, s in zip(mod_names(cfg), cfg["input_dim"], style_dims(cfg)):
        if m not in present:
            continue
        enc = (4 * d * h + 6 * h * h * (cfg["num_hidden_layer_encoder"] - 1)
               + 6 * h * (2 * cd + 2 * s))
        w = _dec_widths(cfg, d, s, False)
        dec = 6 * sum(a * b for a, b in zip(w[:-1], w[1:]))
        per_row += passes * (enc + dec)
    return float(per_row * rows)


def step_bytes(cfg: dict, batches) -> float:
    """Least bytes of a stretch of steps: the parameters and Adam's two
    moments read and written once, each batch's data and noise read once.
    ``batches``: ``[(rows, present)]``."""
    total = 6 * 4 * n_params(cfg)
    names = mod_names(cfg)
    for rows, present in batches:
        width = cfg["class_dim"] + sum(
            s for m, s in zip(names, style_dims(cfg)) if m in present)
        feats = sum(d for m, d in zip(names, cfg["input_dim"])
                    if m in present)
        total += 4 * rows * (feats + width)
    return float(total)


def bound_s(flops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    return max(flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES_S)


def _fwd_enc(cfg: dict, d: int, s: int, content_only: bool) -> int:
    h, cd = cfg["hidden_dim"], cfg["class_dim"]
    heads = 2 * cd if content_only else 2 * cd + 2 * s
    return 2 * (d * h + h * h * (cfg["num_hidden_layer_encoder"] - 1)
                + h * heads)


def _fwd_dec(cfg: dict, d: int, s: int, loc_only: bool) -> int:
    w = _dec_widths(cfg, d, s, loc_only)
    return 2 * sum(a * b for a, b in zip(w[:-1], w[1:]))


def sweep_cell_flops(cfg: dict) -> Tuple[float, float]:
    """``(FLOPs per row of a cell, FLOPs of the ROI encoder per row)`` of
    the avatar sweep."""
    (d1, d2), (s1, s2) = cfg["input_dim"][:2], style_dims(cfg)[:2]
    return (float(_fwd_enc(cfg, d1, s1, True) + _fwd_dec(cfg, d2, s2, True)),
            float(_fwd_enc(cfg, d2, s2, False)))


def sweep_kernel_bound_s(cfg: dict) -> float:
    """The least time of one round's sweep as the sweep kernel takes it
    (the cells' products; the weights, cells, noise and ROI posteriors
    read once, the avatars written once)."""
    b, p, s = cfg["daa_n_subjects"], cfg["daa_n_samples"], cfg["n_scores"]
    (d1, d2), (s1, s2) = cfg["input_dim"][:2], style_dims(cfg)[:2]
    h, cd = cfg["hidden_dim"], cfg["class_dim"]
    rows = p * s * b
    flops = rows * sweep_cell_flops(cfg)[0]
    weights = d1 * h + h + h * 2 * cd + 2 * cd + (s2 + cd) * d2 + d2
    n_bytes = 4 * (weights + rows * (d1 + cd + s2 + d2)
                   + b * 2 * (cd + s2))
    return bound_s(flops, n_bytes)


def daa_round_flops(cfg: dict, closed_form: bool) -> float:
    """Model FLOPs of one round: the reconstruction (one forward of the
    ``B`` subjects in closed form, ``M`` otherwise) and the sweep."""
    b, p, s = cfg["daa_n_subjects"], cfg["daa_n_samples"], cfg["n_scores"]
    fwd = sum(_fwd_enc(cfg, d, st, False) + _fwd_dec(cfg, d, st, False)
              for d, st in zip(cfg["input_dim"], style_dims(cfg)))
    recon = b * fwd * (1 if closed_form else cfg["daa_M"])
    cell, rois_enc = sweep_cell_flops(cfg)
    return float(recon + p * s * b * cell + b * rois_enc)
