"""Method-dispatched complete-batch epochs.

Counterpart of ``multivae_tpu/ops/fused_methods.py:62-139``. The TPU kernel
``_method_epoch_kernel`` trains complete batches of any row count for the
four methods (and dropout), with in-kernel autodiff. Its ``joint_elbo``
branch is the MoPoE step of :mod:`.fused_step`, which takes any row count,
so the port routes it there (``csrc/mopoe_step.cu``); the moe, jsd and poe
branches and dropout masks are not ported yet (ROADMAP Queue 2) and raise.
"""

from __future__ import annotations

import math
from typing import Tuple

METHODS = ("joint_elbo", "moe", "jsd", "poe")
PORTED_METHODS = ("joint_elbo",)


def method_metric_names(model, method: str) -> Tuple[str, ...]:
    """Scalar families per step: ``fused_step.metric_names`` plus, for poe,
    the unimodal reconstruction terms."""
    m1, m2 = (m.name for m in model.modalities)
    joint = "_".join(sorted([m1, m2]))
    names = [
        "loss", "joint_divergence",
        f"log_prob/{m1}", f"log_prob/{m2}",
        f"kld/{m1}", f"kld/{m2}", f"kld/{joint}",
        f"kld_style/{m1}_style", f"kld_style/{m2}_style",
        f"latent_mu/{m1}", f"latent_logvar/{m1}",
        f"latent_mu/{m1}_style", f"latent_logvar/{m1}_style",
        f"latent_mu/{m2}", f"latent_logvar/{m2}",
        f"latent_mu/{m2}_style", f"latent_logvar/{m2}_style",
    ]
    if method == "poe":
        names += [f"log_prob_uni/{m1}", f"log_prob_uni/{m2}"]
    return tuple(names)


def noise_width(cfg) -> int:
    """Noise columns per sample: ``cd | s1 | s2``, plus for poe one
    unimodal draw per modality."""
    cd, (s1, s2) = cfg.class_dim, cfg.style_dim
    w = cd + s1 + s2
    if cfg.method == "poe":
        w += (cd + s1) + (cd + s2)
    return w


def supports_method_fused(cfg, model, batch) -> bool:
    """The TPU kernel's eligibility (``multivae_tpu``
    ``supports_method_fused`` less its VMEM guard): the split-layout
    architecture with any of the four methods, every modality present."""
    from .fused_step import split_layout_ok

    names = [m.name for m in model.modalities]
    return (cfg.method in METHODS
            and split_layout_ok(cfg, model)
            and all(n in batch for n in names)
            and (cfg.method != "poe" or cfg.poe_unimodal_elbos))


def _uniform_bounds(b: int, k: int):
    """Row partition of a k-component uniform stratified mixture."""
    size = int(math.floor(b / k))
    return [i * size for i in range(1, k)]
