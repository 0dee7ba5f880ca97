"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
small cells added, so that a whole run fits in a test.

Run them from the root of the repository:

    PYTHONPATH=src:. python -m pytest -q portbench/tests
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# small cells: the real configurations and traffic at a test's size; a
# batch of 0 sends one (d,) query a call
TINY = {
    "tiny-pq.batch": ("clustered1m-pq", "tiny-pq", "tiny-batch", 8),
    "tiny-rabitq.batch": ("clustered1m-rabitq", "tiny-rabitq", "tiny-batch",
                          8),
    "tiny-pq.single": ("clustered1m-pq", "tiny-pq", "tiny-single", 0),
}


def make_root(dst: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and the benchmark's folder under
    ``dst``, with the ``TINY`` cells added by new files and entries."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    base = dst / "portbench"
    for cell, (cfg_src, cfg_name, tr_name, batch) in TINY.items():
        cfg = json.loads((base / "configs" / f"{cfg_src}.json").read_text())
        cfg.update(name=cfg_name, n=20000, d=32)
        cfg["index"]["n_clusters"] = 64
        if "pq_m" in cfg["index"]:
            cfg["index"]["pq_m"] = 8
        cfg["search"]["n_probe"] = 16
        (base / "configs" / f"{cfg_name}.json").write_text(json.dumps(cfg))
        tr = json.loads((base / "traffic" / "batch32.json").read_text())
        tr.update(k=200, chunk=64, warm_calls=1, batch=batch,
                  sample=4 if batch else 8, trace={"skip": 1, "calls": 6})
        (base / "traffic" / f"{tr_name}.json").write_text(json.dumps(tr))
        if cfg_name not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append({
                "name": cfg_name, "source": "a test's size",
                "file": f"portbench/configs/{cfg_name}.json", "reduced": [],
                "why": "a test's size"})
        bench["workloads"].append({"name": cell, "config": cfg_name,
                                   "traffic": tr_name, "chips": 1,
                                   "why": "a test's size"})
        for m in bench["per_layer"]:
            if "roofline" not in m["name"] or (
                    cfg_src, batch) == ("clustered1m-pq", 8) or (
                    "rabitq" in cfg_src and "rabitq" in m["name"]):
                m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)
