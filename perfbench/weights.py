"""Model weights made from the seed on the device.

The benchmark draws every weight itself, in one call of a generator on the
device, and hands the same tensors to the program (copied into its model)
and to the plain reference. The law is torch ``nn.Linear``'s default,
``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for weights and biases; a
per-feature output log-variance starts at ``initial_out_logvar``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

MOD_NAMES = ("clinical", "rois")


def mod_names(cfg: dict) -> List[str]:
    n = len(cfg["input_dim"])
    return [MOD_NAMES[m] if m < len(MOD_NAMES) else f"mod{m}"
            for m in range(n)]


def style_dims(cfg: dict) -> List[int]:
    if not cfg["factorized_representation"]:
        return [0] * len(cfg["input_dim"])
    return list(cfg["style_dim"])


def leaf_shapes(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """``{parameter name: (shape, fan_in)}`` in the model's naming
    (``enc_<mod>.hidden_<i>.weight`` ...); ``fan_in`` 0 marks the
    constant output log-variance."""
    h, cd = cfg["hidden_dim"], cfg["class_dim"]
    out = {}

    def linear(name, n_in, n_out):
        out[name + ".weight"] = ((n_out, n_in), n_in)
        out[name + ".bias"] = ((n_out,), n_in)

    for name, d, s in zip(mod_names(cfg), cfg["input_dim"], style_dims(cfg)):
        width = d
        for i in range(cfg["num_hidden_layer_encoder"]):
            linear(f"enc_{name}.hidden_{i}", width, h)
            width = h
        linear(f"enc_{name}.heads", width, 2 * cd + 2 * s)
        width = cd + s
        for i in range(cfg["num_hidden_layer_decoder"]):
            linear(f"dec_{name}.hidden_{i}", width, h)
            width = h
        if cfg["learn_output_sample_scale"]:
            linear(f"dec_{name}.out_heads", width, 2 * d)
        else:
            linear(f"dec_{name}.out_mu", width, d)
            out[f"dec_{name}.out_logvar"] = ((1, d), 0)
    return out


def make_weights(cfg: dict, seed: int, device) -> Dict[str, "torch.Tensor"]:
    """Every leaf of the model, float32 on ``device``, from one uniform
    draw of a generator on that device seeded with ``seed``."""
    import torch

    shapes = leaf_shapes(cfg)
    total = sum(math.prod(s) for s, fan in shapes.values() if fan)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, (shape, fan_in) in shapes.items():
        if not fan_in:
            out[name] = torch.full(shape, float(cfg["initial_out_logvar"]),
                                   device=device)
            continue
        n = math.prod(shape)
        bound = 1.0 / math.sqrt(fan_in)
        out[name] = ((2.0 * u[off:off + n] - 1.0) * bound).view(shape)
        off += n
    return out
