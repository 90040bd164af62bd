"""BENCHMARK.json against the contract's shapes, and the files it names."""
import ast
import json
import re
from pathlib import Path

import pytest

from repro_torch.configs import get_config

REPO = Path(__file__).resolve().parents[2]
PB = REPO / "perfbench"
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = [e["name"] for k in ("configs", "workloads") for e in BENCH[k]]
    names += [m["name"] for m in METRICS]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len({w["name"] for w in BENCH["workloads"]}) == \
        len(BENCH["workloads"])


def test_entries_have_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    path = PB / "metrics" / f"{m['name']}.py"
    tree = ast.parse(path.read_text())
    assert any((isinstance(n, ast.FunctionDef) and n.name == "read")
               or (isinstance(n, ast.Assign)
                   and [t.id for t in n.targets] == ["read"])
               for n in tree.body)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


def test_no_reader_without_a_metric():
    names = {m["name"] for m in METRICS}
    assert {p.name[:-3] for p in (PB / "metrics").glob("*.py")} == names


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    cell = json.loads((PB / "workloads" / f"{w['name']}.json").read_text())
    lim = cell["limits"]
    assert cell["ls_rate"] > 0 and lim["ttft_ms"] > 0 and lim["tpot_ms"] > 0
    assert cell["check"]["ls_logit_gap"] > 0
    assert cell["check"]["be_logit_gap"] > 0
    mix = json.loads((PB / "traffic" / f"{w['traffic']}.json").read_text())
    assert set(mix) >= {"ls", "be"}
    assert any(c["name"] == w["config"] for c in BENCH["configs"])


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_the_programs_published_model(c):
    """Each tenant's widths are the program's configuration of the model,
    at full depth."""
    conf = json.loads((REPO / c["file"]).read_text())
    assert c["file"].startswith("perfbench/configs/")
    for cls in ("ls", "be"):
        m = conf[cls]
        cfg = get_config(m["model"])
        for k, v in m["arch"].items():
            assert getattr(cfg, k) == v, (m["model"], k)
        assert cfg.family == "dense" and cfg.layer_pattern == ("global",)


def test_per_layer_layers_are_named_once():
    """Metrics of one layer give it the same name, letter for letter."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)
    perf = (REPO / "PERF.md").read_text()
    for x in layers:
        assert x in perf, x


def _cells(m):
    return set(m.get("workloads", [w["name"] for w in BENCH["workloads"]]))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_what_its_metrics_move(w):
    """A cell reports ``setup_s``, another end-to-end metric and a
    per-layer one, and the end-to-end metric that each of its per-layer
    metrics moves."""
    name = w["name"]
    e2e = {m["name"] for m in BENCH["end_to_end"] if name in _cells(m)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if name in _cells(m)]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
