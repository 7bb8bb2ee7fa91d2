"""``BENCHMARK.json`` against the benchmark's contract, and every piece of
a cell found by its name."""

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


@pytest.fixture(scope="module")
def manifest():
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def short_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths(manifest):
    assert set(manifest) == TOP
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(short_line(w) for w in cmd)
    assert cmd[1] == "perfbench/run.py" and (ROOT / cmd[1]).is_file()
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_names_units_and_entry_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert short_line(c["source"]) and short_line(c["why"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and short_line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            extra = {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            assert set(m) - {"workloads"} == METRIC_KEYS | extra
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_bounds_and_sources(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert short_line(m["layer"])


def test_each_per_layer_metric_moves_one_reported_metric(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        e2e = [m["name"] for m in manifest["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in manifest["per_layer"])
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_configs_are_used_and_their_files_hold_them(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        with open(ROOT / c["file"]) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])


def test_pieces_are_found_by_name(manifest):
    from perfbench import harness

    for w in manifest["workloads"]:
        traffic = harness.load_module(
            harness.HERE / "traffic" / f"{w['traffic']}.py",
            "perfbench.traffic." + harness._ident(w["traffic"]))
        for fn in ("setup", "window", "end_to_end", "counts", "outputs",
                   "judge", "control_readings"):
            assert callable(getattr(traffic, fn))
        assert (harness.HERE / "limits" / f"{w['name']}.json").is_file()
    for m in manifest["per_layer"]:
        reader = harness.load_module(
            harness.HERE / "metrics" / f"{m['name']}.py",
            "perfbench.metrics." + harness._ident(m["name"]))
        assert callable(reader.read)
        assert reader.read(harness.LayerView(None, {})) is None
