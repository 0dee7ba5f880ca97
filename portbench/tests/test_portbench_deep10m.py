"""The deep-10M configuration (``deep10m-pq``: 10,000,000 x 96 under IVF4096
+ PQ24x4 + BBC) at a test's size: d = 96 and M = 24 kept, the corpus, the
clusters and k cut.  ``BENCHMARK.json`` resolves the cell at its published
sizes; a whole run on the CPU reads ``correct`` and the control is refused;
a traced one leaves out ``probed_work_roofline`` (no device trace there);
and the metric's count of a call's probed work, on a call built by hand, is
the three stages' bounds and nothing of the lanes no query probes."""
from __future__ import annotations

import io
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import control, harness, pass_work, roofline
from portbench.tests.conftest import make_root
from repro_torch.index import search

ROOT = Path(__file__).resolve().parents[2]
CELL = "deep10m-pq.batch32"
TINY = "tiny-deep-pq.batch"
NEW = ("probed_work_roofline",)
SEED = 2 ** 31 + 1096


@pytest.fixture
def deep_root(tmp_path) -> Path:
    root = make_root(tmp_path)
    base = root / "portbench"
    cfg = json.loads((base / "configs" / "deep10m-pq.json").read_text())
    cfg.update(name="tiny-deep-pq", n=6000)
    cfg["index"].update(n_clusters=32, kmeans_iters=4)
    cfg["search"]["n_probe"] = 8
    (base / "configs" / "tiny-deep-pq.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny-deep-pq", "source": "a test's size",
        "file": "portbench/configs/tiny-deep-pq.json", "reduced": [],
        "why": "a test's size"})
    bench["workloads"].append({"name": TINY, "config": "tiny-deep-pq",
                               "traffic": "tiny-batch", "chips": 1,
                               "why": "a test's size"})
    for m in bench["per_layer"]:      # every layer, and the cell's own
        if "roofline" not in m["name"] or CELL in m["workloads"]:
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
    assert (cfg["n"], cfg["d"]) == (10_000_000, 96)
    assert (ix["n_clusters"], ix["pq_m"], ix["pq_bits"]) == (4096, 24, 4)
    assert cfg["reduced"] == ["data"] and len(cfg["source"]) <= 200
    assert "deep-10M" in cfg["source"]
    assert cfg["check"] == {"reference": "portbench/reference.py",
                            "exact_rows": "all",
                            "limits": {"dist_err": 1e-3, "unsorted_rows": 0}}
    # everything else is the 128-d PQ cell's
    pq = harness.resolve(ROOT, "clustered1m-pq.batch32").cfg
    for key in ("data", "queries", "search", "method", "metric",
                "precision", "tf32"):
        assert cfg[key] == pq[key], key
    assert {k: v for k, v in ix.items() if k not in ("n_clusters", "pq_m")} \
        == {k: v for k, v in pq["index"].items()
            if k not in ("n_clusters", "pq_m")}
    assert rc.cell["chips"] == 1 and rc.cell["traffic"] == "batch32"
    assert rc.traffic["k"] == 5000 and rc.traffic["batch"] == 32
    # the cell reports its own metric and joins no other
    assert set(rc.metrics) == set(NEW)
    for name in NEW:
        assert callable(harness.load_module(rc.metrics[name], "metric").read)
    assert rc.method == ROOT / "portbench" / "methods" / "ivfpq.py"


def test_a_sound_run_at_deep_width_is_correct_and_the_control_refused(
        deep_root):
    res = _run(deep_root, trace=False, seconds=1.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert 0.5 < res["metrics"]["recall_at_k"]["value"] <= 1.0
    out = control.control_numbers(deep_root, TINY, 5, "cpu")
    assert out["dist_err"] > out["limits"]["dist_err"], out


def test_a_traced_run_leaves_the_new_metric_out_on_the_cpu(deep_root):
    res = _run(deep_root, trace=True, seconds=2.0)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert {"kernels_per_call", "reranked_per_query"} <= set(m)
    assert not set(NEW) & set(m)


def _engine(sizes, n_probe):
    """An IVF+PQ engine as the metric reads it: eight clusters along one
    axis at d = 96, M = 24 4-bit sub-quantizers, 128-lane tiles."""
    cent = torch.zeros(8, 96)
    cent[:, 0] = torch.tensor([0.0, 1.0, 5.0, 9.0, 20.0, 40.0, 100.0, 200.0])
    ivf = SimpleNamespace(centroids=cent, cluster_sizes=torch.tensor(sizes),
                          cap=128)
    index = SimpleNamespace(
        ivf=ivf, codes=torch.empty(0, 24, dtype=torch.uint8),
        vectors=torch.empty(0, 96),
        pq=SimpleNamespace(centroids=torch.empty(24, 16, 4)))
    return SimpleNamespace(index=index, n_probe=n_probe, m=128)


def test_the_probed_work_is_a_floor_of_the_three_stages():
    """Two queries near clusters 0 and 5 probe five clusters each, {0-4}
    and {5, 4, 3, 2, 1}, and sample their four nearest, {0-3} and {5-2};
    clusters 6 and 7 are probed by neither.  The call's work is the three
    stages' bounds at those counts, and does not grow with the lanes no
    query probes (nor with the (B, n) outputs over them)."""
    reader = harness.load_module(
        ROOT / "portbench" / "metrics" / "probed_work_roofline.py", "metric")
    qs = torch.zeros(2, 96)
    qs[:, 0] = torch.tensor([0.1, 39.0])
    res = search.SearchResult(None, None, torch.tensor([100, 80]),
                              torch.tensor([30, 5]))
    sizes = [10, 20, 30, 40, 50, 60, 70, 80]
    got = reader.call_seconds(_engine(sizes, 5), 4, qs, res)
    scan = roofline.fused_scan_work(2, 5, 24, 4, 96, 128, 210,
                                    150 + 200, 75, 70 + 75)
    sample = pass_work.sample_adc_work(2, 24, 4, 16, 4 * 128, 210,
                                       100 + 180)
    second = pass_work.second_pass_work(96, 30, 35)
    want = sum(roofline.bound(*w)[0] for w in (scan, sample, second))
    assert got == pytest.approx(want, rel=1e-12)
    # 30,000 more lanes that no query probes: the same work
    far = reader.call_seconds(_engine(sizes[:6] + [15_000, 15_000], 5), 4,
                              qs, res)
    assert far == got
