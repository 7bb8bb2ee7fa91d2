"""The port's CLI against the JAX package's: the fourteen commands in its
order, each with the JAX command's flags (plus ``--device`` where a model
runs) parsed alike; the counterparts of ``tests/test_analysis.py``'s CLI
tests; the four commands of the earlier slices parse exactly as they did;
each of the ten analysis and plot commands reaches its workflow with the
parsed arguments."""

import argparse
import inspect
from typing import Dict

import pytest

from multivae_tpu import cli as jax_cli
from multivae_tpu_torch import cli

pytestmark = pytest.mark.driver  # cross-framework parity pins

# the commands whose workflow runs a model: they take --device
MODEL_COMMANDS = {"train", "resume", "eval", "daa", "rsa",
                  "daa-plot-score-metric", "avatar-plot"}
NEW_COMMANDS = ("anova", "daa-plot-most-connected", "daa-plot-score-metric",
                "rsa", "rsa-plot", "hist-plot", "avatar-plot",
                "daa-analysis", "daa-robustness", "univariate-tests")


def parser_of(add_args, fn):
    p = argparse.ArgumentParser()
    add_args(p, fn)
    return p


def actions(parser) -> Dict[str, argparse.Action]:
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def type_name(action):
    t = action.type
    if t is cli._as_bool or getattr(t, "__name__", "") == "<lambda>":
        return "bool"
    return getattr(t, "__name__", str(t))


def test_cli_commands_registered_in_the_jax_order():
    assert list(cli._commands()) == list(jax_cli._commands())
    assert set(cli._commands()) == {
        "train", "resume", "eval", "daa", "anova",
        "daa-plot-most-connected", "daa-plot-score-metric", "rsa",
        "rsa-plot", "hist-plot", "avatar-plot", "daa-analysis",
        "daa-robustness", "univariate-tests"}


def test_help_lists_the_fourteen_commands(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    listed = out[out.index("{") + 1:out.index("}")].split(",")
    assert listed == list(jax_cli._commands())


@pytest.mark.parametrize("command", list(jax_cli._commands()))
def test_command_flags_equal_jax(command):
    """Same flags, defaults, nargs, required-ness and value types as the
    JAX command's, plus ``--device cuda`` where a model runs. One
    difference on purpose: a list flag whose default is empty takes str
    (the JAX CLI's int refuses ``--continuous-covs age``)."""
    ours = actions(parser_of(cli._add_args_from_signature,
                             cli._commands()[command]))
    theirs = actions(parser_of(jax_cli._add_args_from_signature,
                               jax_cli._commands()[command]))
    extra = {"device"} if command in MODEL_COMMANDS else set()
    assert set(ours) == set(theirs) | extra
    if extra:
        assert ours["device"].default == "cuda"
    for dest, want in theirs.items():
        got = ours[dest]
        assert got.option_strings == want.option_strings, dest
        assert (got.nargs, got.required) == (want.nargs, want.required), dest
        assert got.default == want.default, dest
        empty_list = isinstance(want.default, list) and not want.default
        assert type_name(got) == ("str" if empty_list else type_name(want)), \
            dest


@pytest.mark.parametrize("command", ["daa", "anova",
                                     "daa-plot-most-connected",
                                     "daa-plot-score-metric"])
def test_cli_fractional_vote_prop_parses(command):
    """``vote_prop`` is a proportion of models (``test_analysis.py``'s
    ``test_cli_fractional_vote_prop_parses``)."""
    p = parser_of(cli._add_args_from_signature, cli._commands()[command])
    ns = p.parse_args(["--dataset", "d", "--datasetdir", "x", "--outdir",
                       "o", "--run", "r", "--vote-prop", "0.67"]
                      + (["--score", "s", "--metric", "m"]
                         if command == "daa-plot-score-metric" else []))
    assert ns.vote_prop == pytest.approx(0.67)


def fake(monkeypatch, module, name, seen):
    """Replace ``module.name`` by a recorder with the real signature."""
    real = getattr(module, name)

    def record(**kw):
        seen.update(kw)
        return "done"

    record.__signature__ = inspect.signature(real)
    monkeypatch.setattr(module, name, record)


def test_hist_plot_accepts_cohort_lists(monkeypatch):
    """``test_analysis.py``'s ``test_hist_plot_accepts_cohort_lists``."""
    from multivae_tpu_torch import workflows

    seen = {}
    fake(monkeypatch, workflows, "hist_plot_exp", seen)
    cli.main(["hist-plot", "--datasets", "synthetic", "synthetic",
              "--datasetdirs", "/d1", "/d2",
              "--scores", "score_0", "score_1", "--outdir", "/o"])
    assert seen == {"datasets": ["synthetic", "synthetic"],
                    "datasetdirs": ["/d1", "/d2"],
                    "scores": ["score_0", "score_1"], "outdir": "/o"}


def test_univariate_covariates_parse_as_str_lists(monkeypatch):
    from multivae_tpu_torch.analysis import avatars

    seen = {}
    fake(monkeypatch, avatars, "univariate_tests", seen)
    cli.main(["univariate-tests", "--dataset", "synthetic", "--datasetdir",
              "/d", "--continuous-covs", "age", "--categorical-covs", "sex",
              "site"])
    assert seen["continuous_covs"] == ["age"]
    assert seen["categorical_covs"] == ["sex", "site"]
    seen.clear()
    cli.main(["univariate-tests", "--dataset", "synthetic", "--datasetdir",
              "/d"])
    assert seen["continuous_covs"] == seen["categorical_covs"] == []
    assert seen["outdir"] is None and seen["seed"] == 1037


# the argument rules of the port's CLI before the analysis commands, kept
# to show the four commands of the earlier slices parse as they did
def earlier_add_args(parser, fn):
    for name, param in inspect.signature(fn).parameters.items():
        flag = "--" + name.replace("_", "-")
        default = param.default
        kw = {"required": default is inspect.Parameter.empty}
        if not kw["required"]:
            kw["default"] = default
        if name in ("input_dims", "style_dim"):
            kw["nargs"] = "+"
            kw["type"] = int
            if not kw["required"]:
                kw["default"] = list(default)
        elif isinstance(default, bool):
            kw["type"] = cli._as_bool
        elif isinstance(default, (int, float)):
            kw["type"] = type(default)
        elif param.annotation in (int, "int"):
            kw["type"] = int
        else:
            kw["type"] = str
        if flag.lower() != flag:
            parser.add_argument(flag, flag.lower(), dest=name, **kw)
        else:
            parser.add_argument(flag, **kw)


@pytest.mark.parametrize("command", ["train", "resume", "eval", "daa"])
def test_earlier_commands_parse_as_before(command):
    fn = cli._commands()[command]
    ours = actions(parser_of(cli._add_args_from_signature, fn))
    before = actions(parser_of(earlier_add_args, fn))
    assert list(ours) == list(before)
    for dest, want in before.items():
        got = ours[dest]
        for attr in ("option_strings", "nargs", "default", "required",
                     "type"):
            assert getattr(got, attr) == getattr(want, attr), (dest, attr)


ARGV = {
    "anova": ["--n-validation", "3", "--trust-level", "0.5", "--M", "16"],
    "daa-plot-most-connected": ["--plot-associations", "true",
                                "--surface-atlas", "/a.npz"],
    "daa-plot-score-metric": ["--score", "score_0", "--metric", "area",
                              "--device", "cpu"],
    "rsa": ["--n-subjects", "40", "--sample-latents", "true", "--device",
            "cpu"],
    "rsa-plot": [],
    "hist-plot": None,
    "avatar-plot": ["--score", "score_1", "--n-frames", "8", "--device",
                    "cpu"],
    "daa-analysis": ["--val-step", "1", "--model-idx", "1",
                     "--sample-latents", "false"],
    "daa-robustness": ["--n-models-to-plot", "2", "--m", "32"],
    "univariate-tests": None,
}
WANT = {
    "anova": {"n_validation": 3, "trust_level": 0.5, "M": 16},
    "daa-plot-most-connected": {"plot_associations": True,
                                "surface_atlas": "/a.npz"},
    "daa-plot-score-metric": {"score": "score_0", "metric": "area",
                              "device": "cpu"},
    "rsa": {"n_subjects": 40, "sample_latents": True, "device": "cpu"},
    "rsa-plot": {},
    "avatar-plot": {"score": "score_1", "n_frames": 8, "device": "cpu"},
    "daa-analysis": {"val_step": 1, "model_idx": 1, "sample_latents": False},
    "daa-robustness": {"n_models_to_plot": 2, "M": 32},
}


@pytest.mark.parametrize("command", [c for c in NEW_COMMANDS
                                     if ARGV[c] is not None])
def test_new_command_reaches_its_workflow(command, monkeypatch):
    from multivae_tpu_torch import workflows
    from multivae_tpu_torch.analysis import avatars

    fn = cli._commands()[command]
    module = avatars if fn.__module__.endswith("avatars") else workflows
    seen = {}
    fake(monkeypatch, module, fn.__name__, seen)
    assert cli.main([command, "--dataset", "synthetic", "--datasetdir", "/d",
                     "--outdir", "/o", "--run", "r"] + ARGV[command]) == 0
    defaults = {k: p.default for k, p in
                inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert seen == {**defaults, "dataset": "synthetic", "datasetdir": "/d",
                    "outdir": "/o", "run": "r", **WANT[command]}
