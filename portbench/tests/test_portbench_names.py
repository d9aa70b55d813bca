"""BENCHMARK.json keeps to the contract's names and units, and every name
in it finds its files under portbench/."""

import json
import re
from pathlib import Path

import pytest

from portbench import layout

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"])
    assert BENCH["command"][1].startswith("portbench/")


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_are_unique_and_entries_have_only_their_keys():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_and_reports_enough(cell):
    c = layout.load_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for m in c.per_layer:
        assert any(e["name"] == m["moves"] for e in c.end_to_end)
    assert c.limits["max_logit_gap"] > 0 and c.limits["mean_logit_gap"] > 0
    assert c.traffic["entry"] in ("selfspec", "autoregressive")


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(conf):
    path = REPO / conf["file"]
    assert conf["file"].startswith("portbench/configs/")
    data = json.loads(path.read_text())
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"] == []
    layout.sizes(data)                     # every size the harness reads


def test_metrics_in_workload_lists_name_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in METRICS:
        assert set(m.get("workloads", [])) <= cells
