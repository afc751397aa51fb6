"""BENCHMARK.json keeps to its contract, and every cell finds its
configuration, its traffic mix and its metric readers by name."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_cells_configs_and_metrics_line_up(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) \
        == len(cells)
    assert {w["config"] for w in cells.values()} == set(configs)
    assert sum(w["chips"] == 4 for w in cells.values()) \
        <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            cell = harness.load_cell(w)
            assert m["moves"] in {x["name"] for x in cell.end_to_end}
    for m in bench["end_to_end"]:
        for w in m.get("workloads", []):
            assert w in cells
    for c in configs.values():
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
    assert len({c["file"] for c in configs.values()}) == len(configs)


@pytest.mark.parametrize("name", [
    "grid3x3-random-32k", "a3c-convgru-5x5-2k", "grid3x3-hostloop-32k"])
def test_cell_finds_its_files_by_name(name):
    cell = harness.load_cell(name)
    assert cell.traffic["driver"] in ("sim", "learner")
    assert os.path.exists(os.path.join(ROOT, "benchmark", "drivers",
                                       cell.traffic["driver"] + ".py"))
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
    for k in cell.config["reduced"]:
        assert k in cell.config
