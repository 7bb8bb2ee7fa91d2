"""Command-line interface of the port: ``python -m multivae_tpu_torch
<command>``, the JAX CLI's fourteen commands in its order (train, resume,
eval, daa, anova, daa-plot-most-connected, daa-plot-score-metric, rsa,
rsa-plot, hist-plot, avatar-plot, daa-analysis, daa-robustness,
univariate-tests).

Counterpart of ``multivae_tpu/cli.py``: the workflow function's signature
drives the argument parser, so the flags are its parameters
(``--input-dims 7 444``, ``--n-validation 5``, ``--device cuda``). A list
or tuple default takes one or more values of its element's type (str
where the default is empty: ``--categorical-covs sex site``).
"""

from __future__ import annotations

import argparse
import inspect
import sys
from typing import Callable, Dict, Sequence


def _as_bool(value) -> bool:
    return str(value).lower() in ("1", "true", "yes")


def _add_args_from_signature(parser: argparse.ArgumentParser,
                             fn: Callable) -> None:
    for name, param in inspect.signature(fn).parameters.items():
        flag = "--" + name.replace("_", "-")
        default = param.default
        kw: Dict = {"required": default is inspect.Parameter.empty}
        if not kw["required"]:
            kw["default"] = default
        # PEP 563 (from __future__ import annotations) stringizes
        # annotations, so accept both forms
        ann = {int: int, float: float, str: str,
               "int": int, "float": float, "str": str}.get(param.annotation)
        if ann is not None:
            kw["type"] = ann
        elif isinstance(default, bool):
            kw["type"] = _as_bool
        elif isinstance(default, (int, float)):
            kw["type"] = type(default)
        elif isinstance(default, (list, tuple)):
            kw["nargs"] = "+"
            kw["type"] = type(default[0]) if len(default) else str
            kw["default"] = list(default)
        else:
            kw["type"] = str
        # int lists of the model's widths
        if name in ("input_dims", "style_dim"):
            kw["nargs"] = "+"
            kw["type"] = int
        # hist-plot compares cohorts: aligned str lists (one score per
        # cohort entry)
        if name in ("datasets", "datasetdirs", "scores"):
            kw["nargs"] = "+"
            kw["type"] = str
        if flag.lower() != flag:
            # e.g. --M also accepts --m
            parser.add_argument(flag, flag.lower(), dest=name, **kw)
        else:
            parser.add_argument(flag, **kw)


def _commands() -> Dict[str, Callable]:
    from . import workflows as wf
    from .analysis import avatars as av

    return {
        "train": wf.train_exp,
        "resume": wf.resume_exp,
        "eval": wf.eval_exp,
        "daa": wf.daa_exp,
        "anova": wf.anova_exp,
        "daa-plot-most-connected": wf.daa_plot_most_connected,
        "daa-plot-score-metric": wf.daa_plot_score_metric,
        "rsa": wf.rsa_exp,
        "rsa-plot": wf.rsa_plot_exp,
        "hist-plot": wf.hist_plot_exp,
        "avatar-plot": wf.avatar_plot_exp,
        "daa-analysis": av.analyze_avatars,
        "daa-robustness": av.assess_robustness,
        "univariate-tests": av.univariate_tests,
    }


def main(argv: Sequence[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="multivae_tpu_torch",
        description="PyTorch/CUDA port of the multimodal-VAE "
                    "training and interpretability workflows")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, fn in _commands().items():
        p = sub.add_parser(name, help=(fn.__doc__ or "").split("\n")[0])
        _add_args_from_signature(p, fn)
        p.set_defaults(_fn=fn)
    args = parser.parse_args(argv)
    kwargs = {k: v for k, v in vars(args).items()
              if k not in ("command", "_fn")}
    args._fn(**kwargs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
