"""The benchmark finds every configuration, traffic mix, limits file,
driver and per-layer reader by the names in BENCHMARK.json, and
BENCHMARK.json keeps to the contract's shape."""
import ast
import os
import re

import pytest

from portbench import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all("/" not in w or w.startswith("portbench") for w in BENCH["command"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert hasattr(c.driver, "run")
    assert c.limits["limits"]
    assert c.entry["chips"] == 1
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", METRICS)
def test_reader_found_by_name(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert callable(harness.reader(metric).read)
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + METRICS + \
        [m["name"] for m in BENCH["end_to_end"]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in BENCH["workloads"]] + \
            [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


def test_every_file_has_a_name_of_names():
    for path, _, files in os.walk(harness.PKG):
        for f in files:
            rel = os.path.relpath(os.path.join(path, f), harness.ROOT)
            assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel


def test_harness_has_no_table_of_names():
    """The harness's code names no workload, config, mix or metric: it
    finds them from BENCHMARK.json."""
    names = set(CELLS + METRICS + [w["config"] for w in BENCH["workloads"]]
                + [w["traffic"] for w in BENCH["workloads"]])
    for f in ("run.py", "harness.py", "trace.py", "calibrate.py"):
        with open(os.path.join(harness.PKG, f)) as fh:
            tree = ast.parse(fh.read())
        consts = {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
                  and isinstance(n.value, str)}
        assert not consts & names, (f, consts & names)
