"""The GIST1M-width RaBitQ configuration (``gist1m-rabitq``: 1,000,000 x 960
under IVF1024 + 1-bit RaBitQ + BBC's greedy bounded re-rank) at a test's
size: d = 960 kept, the corpus, the clusters and k cut.  ``BENCHMARK.json``
resolves the cell at its published sizes with the per-layer set it lists
for it; a whole run on the CPU reads ``correct`` and the control is refused
by the cell's limits; a traced one leaves the two roofline shares out (no
device trace there) and reads ``certified_band_pct`` from the calls' work
counters."""
from __future__ import annotations

import io
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import control, harness
from portbench.tests.conftest import make_root
from repro_torch.index import search

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "gist1m-rabitq.batch32"
TINY = "tiny-gist-rabitq.batch"
NEW = ("rabitq_d960_scan_roofline", "straggler_pass_roofline",
       "certified_band_pct")
SEED = 2 ** 31 + 39960


def listed(cell: str) -> set[str]:
    """The per-layer metrics ``BENCHMARK.json`` has ``cell`` report."""
    return {m["name"] for m in BENCH["per_layer"]
            if cell in m.get("workloads", [cell])}


@pytest.fixture
def gist_root(tmp_path) -> Path:
    root = make_root(tmp_path)
    base = root / "portbench"
    cfg = json.loads((base / "configs" / "gist1m-rabitq.json").read_text())
    cfg.update(name="tiny-gist-rabitq", n=6000)
    cfg["index"].update(n_clusters=32, kmeans_iters=4)
    cfg["search"]["n_probe"] = 8
    (base / "configs" / "tiny-gist-rabitq.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny-gist-rabitq", "source": "a test's size",
        "file": "portbench/configs/tiny-gist-rabitq.json", "reduced": [],
        "why": "a test's size"})
    bench["workloads"].append({"name": TINY, "config": "tiny-gist-rabitq",
                               "traffic": "tiny-batch", "chips": 1,
                               "why": "a test's size"})
    for m in bench["per_layer"]:      # the cell's own set, as listed
        if m["name"] in listed(CELL):
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def _run(root, trace, seconds):
    out = io.StringIO()
    res = harness.run_cell(root, TINY, SEED, seconds, trace, device="cpu",
                           out=out)
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == res
    return res


def test_the_cell_resolves_at_its_published_sizes():
    rc = harness.resolve(ROOT, CELL)
    cfg, ix = rc.cfg, rc.cfg["index"]
    assert (cfg["n"], cfg["d"]) == (1_000_000, 960)
    assert cfg["reduced"] == ["data"] and len(cfg["source"]) <= 200
    assert "gist-960-euclidean" in cfg["source"]
    assert cfg["check"]["reference"] == "portbench/reference.py"
    assert cfg["check"]["exact_rows"] == "suffix"
    # everything but the width and the check's limits is the 128-d cell's
    rq = harness.resolve(ROOT, "clustered1m-rabitq.batch32").cfg
    for key in ("data", "queries", "index", "search", "method", "metric",
                "precision", "tf32", "n"):
        assert cfg[key] == rq[key], key
    assert ix["n_clusters"] == 1024 and cfg["search"]["eps0"] == 3.0
    assert rc.cell["chips"] == 1 and rc.cell["traffic"] == "batch32"
    assert rc.traffic["k"] == 5000 and rc.traffic["batch"] == 32
    # the per-layer set is BENCHMARK.json's, the three new metrics in it
    assert set(rc.metrics) == listed(CELL)
    assert set(NEW) <= set(rc.metrics)
    for name in NEW:
        assert callable(harness.load_module(rc.metrics[name], "metric").read)
    assert rc.method == ROOT / "portbench" / "methods" / "ivfrabitq.py"


def test_a_sound_run_at_gist_width_is_correct_and_the_control_refused(
        gist_root):
    res = _run(gist_root, trace=False, seconds=2.5)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert 0.5 < res["metrics"]["recall_at_k"]["value"] <= 1.0
    out = control.control_numbers(gist_root, TINY, 5, "cpu")
    assert any(out[name] > lim for name, lim in out["limits"].items()), out


def test_a_traced_run_reads_the_band_share_and_no_roofline_on_the_cpu(
        gist_root):
    res = _run(gist_root, trace=True, seconds=4.0)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert 0.0 <= m["certified_band_pct"]["value"] <= 100.0
    assert m["certified_band_pct"]["unit"] == "%"
    assert not {"rabitq_d960_scan_roofline",
                "straggler_pass_roofline"} & set(m)


def test_the_band_share_counts_what_the_scan_certified():
    reader = harness.load_module(
        ROOT / "portbench" / "metrics" / "certified_band_pct.py", "metric")

    def rec(reranked, second):
        return SimpleNamespace(result=search.SearchResult(
            None, None, torch.tensor(reranked), torch.tensor(second)))

    traced = [rec([10, 0], [10, 0]),           # left out: not counted
              rec([100, 60], [25, 60]), rec([40, 0], [0, 0])]
    ctx = SimpleNamespace(profile=SimpleNamespace(n_calls=2),
                          window=SimpleNamespace(traced=traced))
    assert reader.read(ctx) == pytest.approx(100.0 * (75 + 0 + 40) / 200)
    ctx.window.traced = traced[:1]
    ctx.profile.n_calls = 1
    assert reader.read(ctx) == 0.0
    ctx.profile = None                         # no trace: left out
    assert reader.read(ctx) is None
