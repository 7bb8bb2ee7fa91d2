"""Command-line interface of the port: ``python -m multivae_tpu_torch
{train,resume,eval,daa}``.

Counterpart of ``multivae_tpu/cli.py``: the workflow function's signature
drives the argument parser, so the flags are its parameters
(``--input-dims 7 444``, ``--n-validation 5``, ``--device cuda``).
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
        if name in ("input_dims", "style_dim"):
            kw["nargs"] = "+"
            kw["type"] = int
            if not kw["required"]:
                kw["default"] = list(default)
        elif isinstance(default, bool):
            kw["type"] = _as_bool
        elif isinstance(default, (int, float)):
            kw["type"] = type(default)
        elif param.annotation in (int, "int"):
            kw["type"] = int
        else:
            kw["type"] = str
        if flag.lower() != flag:
            # e.g. --M also accepts --m
            parser.add_argument(flag, flag.lower(), dest=name, **kw)
        else:
            parser.add_argument(flag, **kw)


def _commands() -> Dict[str, Callable]:
    from . import workflows as wf

    return {"train": wf.train_exp, "resume": wf.resume_exp,
            "eval": wf.eval_exp, "daa": wf.daa_exp}


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
