"""BENCHMARK.json against the format and limits a benchmark file keeps, and
every entry against the files it names."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", CELLS)


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    # a full check of 24 cells (2 + 14 runs a cell, each run_seconds + 60 s,
    # 180 s a cell to compile, 1,200 s spare) fits in 43,200 seconds
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_units_better_and_sources(section):
    allowed = ({"host_clock", "device_trace"} if section == "end_to_end"
               else {"device_trace", "program_span", "program_counter",
                     "host_clock"})
    for m in BENCH[section]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in allowed


def test_end_to_end_metrics_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert names == ["setup_s", "qps", "latency_p95_ms", "recall_at_k",
                     "serve_mem_gib"]
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        if m["name"] == "setup_s":
            assert m["bound"] <= 0.25


def test_per_layer_metrics_move_qps_in_cells_that_report_it():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] == "qps"
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
        for cell in m["workloads"]:
            assert reports(cell, e2e[m["moves"]]), (m["name"], cell)
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.add(m["layer"])
    assert layers == {"engine and searcher", "collector and re-rank",
                      "CUDA kernels", "device"}
    for m in BENCH["per_layer"]:
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if reports(cell, m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(cell, m) for m in BENCH["per_layer"])


def test_workloads_are_one_card_pairs_with_a_why():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert w["config"] in configs
        assert NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        file_cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == file_cfg["reduced"]
        assert set(c["reduced"]) <= set(file_cfg) - {"n", "d"}
        assert 1 <= len(c["source"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_every_entry_resolves_to_its_files(cell):
    rc = harness.resolve(ROOT, cell)
    assert rc.driver.is_file() and rc.method.is_file()
    for name, path in rc.metrics.items():
        assert path.is_file(), name
        assert callable(harness.load_module(path, "metric").read)
    driver = harness.load_module(rc.driver, "driver")
    assert callable(driver.run_window) and callable(driver.supply)
    cfg = rc.cfg
    assert cfg["name"] == rc.cell["config"]
    assert "assumed" in cfg and set(cfg["reduced"]) <= set(cfg["assumed"])
    check = cfg["check"]
    assert check["exact_rows"] in ("all", "suffix")
    assert 0 < check["limits"]["dist_err"] < 1e-2
    assert check["limits"]["unsorted_rows"] == 0
    if check["exact_rows"] == "suffix":
        assert 0 < check["exact_tol"] <= check["limits"]["dist_err"]
        assert isinstance(check["limits"]["exact_before_estimate"], int)
    for key in ("k", "sample", "warm_calls", "chunk", "trace"):
        assert key in rc.traffic
    assert not [p for p in rc.__dict__.values() if isinstance(p, Path)
                and ROOT / "portbench" not in p.parents]


def test_files_are_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
