"""BENCHMARK.json against the manifest's rules, and every name it gives
against the files that the harness finds by it."""

import re

import pytest
from conftest import ROOT

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line_ok(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.rstrip("/").endswith("_torch")
    assert 1 <= len(manifest["command"]) <= 32 and all(line_ok(w) for w in manifest["command"])
    assert manifest["command"][1].startswith(tuple(p + "/" for p in manifest["paths"]))
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = manifest["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4) and line_ok(w["why"])
    assert {w["config"] for w in cells} == set(names)
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert line_ok(m["layer"])


def test_every_cell_reports_what_it_must(manifest):
    for w in manifest["workloads"]:
        e2e = {m["name"] for m in harness.resolve(manifest, w["name"], False).metrics}
        per = harness.resolve(manifest, w["name"], True).metrics
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        for m in per:
            assert m["moves"] in e2e, (w["name"], m["name"])


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_every_metric_has_its_reader(manifest, group):
    for m in manifest[group]:
        mod = harness.load_module(ROOT / "benchmark" / "metrics" / f"{m['name']}.py")
        assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"])
        if group == "per_layer":
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def test_files_under_paths_are_named_from_name_characters(manifest):
    for p in manifest["paths"]:
        for f in (ROOT / p).rglob("*"):
            rel = f.relative_to(ROOT).as_posix()
            if "__pycache__" in rel or ".pytest_cache" in rel:
                continue
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_one_layer_name_per_layer(manifest):
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
