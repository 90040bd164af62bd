"""Cells, configurations, traffic mixes and metrics are data: a new one is
a new file, found by its name, with no code edited."""
import json

import pytest

from perfbench.catalog import Catalog
from perfbench.harness import run_cell
from perfbench.timeline import ls_gaps_s
from perfbench.tests import tiny

READER = '''
def read(run):
    return float(len(run.timeline.ls_due()))
'''


@pytest.fixture
def root(tmp_path):
    root = tiny.make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "ls_requests_due", "unit": "count",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["tiny.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "perfbench" / "metrics" / "ls_requests_due.py").write_text(
        READER)
    return root


def test_resolves_new_entries_by_name(root):
    cat = Catalog(root)
    assert cat.cell("tiny.cell")["cell"]["ls_rate"] == tiny.CELL["ls_rate"]
    assert cat.config("tiny")["ls"]["arch"] == tiny.ARCH_LS
    assert cat.traffic("tiny")["be"] == tiny.MIX["be"]
    names = [m["name"] for m in cat.metrics("tiny.cell", False)]
    assert "ls_requests_due" in names
    real = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    other = real["workloads"][0]["name"]
    assert "ls_requests_due" not in [m["name"] for m in
                                     cat.metrics(other, False)]
    with pytest.raises(KeyError):
        cat.cell("no.such.cell")


def test_a_run_reports_the_new_metric(root):
    res, run = run_cell(Catalog(root), "tiny.cell", 11, 1, False,
                        device="cpu")
    m = res["metrics"]
    assert m["ls_requests_due"]["value"] == len(run.timeline.ls_due()) > 0
    assert m["ls_requests_due"]["unit"] == "count"
    assert set(m) >= {"ls_ttft_p90_ms", "ls_slo_attainment", "setup_s"}
    # a loaded CPU may put no LS token's gap inside a 1 s window
    assert ("ls_tbt_p99_ms" in m) == bool(ls_gaps_s(run.timeline))
    assert res["correct"] and list(res)[-1] == "checks"
