"""The GIST1M-width configuration (``clustered1m-d960-pq``) at a test's
size: d = 960 and M = 240 kept, the corpus, the clusters and k cut.  A whole
run on the CPU reads ``correct``, a traced one leaves out the two roofline
shares (no device trace there), and ``BENCHMARK.json`` resolves the cell.
The shares' yardstick (``pass_work``) is checked on small counts."""
from __future__ import annotations

import io
import json
from pathlib import Path

import pytest
import torch

from portbench import harness, pass_work, roofline
from portbench.tests.conftest import make_root
from repro_torch.index import search

ROOT = Path(__file__).resolve().parents[2]
CELL = "clustered1m-d960-pq.batch32"
TINY = "tiny-d960-pq.batch"
NEW = ("pq_sample_roofline", "second_pass_roofline")
SEED = 2 ** 31 + 960


@pytest.fixture
def d960_root(tmp_path) -> Path:
    root = make_root(tmp_path)
    base = root / "portbench"
    cfg = json.loads((base / "configs" / "clustered1m-d960-pq.json")
                     .read_text())
    cfg.update(name="tiny-d960-pq", n=6000)
    cfg["index"]["n_clusters"] = 32
    cfg["search"]["n_probe"] = 8
    (base / "configs" / "tiny-d960-pq.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny-d960-pq", "source": "a test's size",
        "file": "portbench/configs/tiny-d960-pq.json", "reduced": [],
        "why": "a test's size"})
    bench["workloads"].append({"name": TINY, "config": "tiny-d960-pq",
                               "traffic": "tiny-batch", "chips": 1,
                               "why": "a test's size"})
    for m in bench["per_layer"]:      # every layer, and the PQ shares
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


def test_the_cell_resolves_at_its_published_widths():
    rc = harness.resolve(ROOT, CELL)
    cfg = rc.cfg
    assert (cfg["n"], cfg["d"], cfg["index"]["pq_m"]) == (1000000, 960, 240)
    assert cfg["index"]["pq_bits"] == 4 and cfg["reduced"] == ["data"]
    assert cfg["check"]["reference"] == "portbench/reference.py"
    assert rc.cell["chips"] == 1 and rc.traffic["k"] == 5000
    assert set(NEW) <= set(rc.metrics)
    for name in NEW:
        assert callable(harness.load_module(rc.metrics[name], "metric").read)
    assert rc.method == ROOT / "portbench" / "methods" / "ivfpq.py"


def test_a_sound_run_at_gist_width_is_correct(d960_root):
    res = _run(d960_root, trace=False, seconds=1.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert 0.5 < res["metrics"]["recall_at_k"]["value"] <= 1.0


def test_a_traced_run_leaves_the_shares_out_on_the_cpu(d960_root):
    res = _run(d960_root, trace=True, seconds=2.0)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert {"kernels_per_call", "reranked_per_query"} <= set(m)
    assert not set(NEW) & set(m)


def test_the_shares_count_a_floor_of_the_work():
    # sample: 1,000 lanes of 240 4-bit codes, two queries' LUTs and outputs
    nbytes, ops = pass_work.sample_adc_work(2, 240, 4, 16, 512, 1000, 1500)
    assert nbytes == 1000 * 120 + 2 * 4 * 240 * 16 + 2 * 4 * 512
    assert ops == 1500 * 239
    nbytes, ops = pass_work.second_pass_work(960, 30, 50)
    assert (nbytes, ops) == (30 * 3840 + 200, 3 * 960 * 50)
    assert roofline.bound(nbytes, ops)[1] == "bytes"
    # 32 queries that gather the same 30 rows: the fp32 work bounds it
    assert roofline.bound(*pass_work.second_pass_work(960, 30, 960))[1] \
        == "operations"


def test_sample_counts_read_the_nearest_clusters():
    centroids = torch.tensor([[0.0, 0.0], [1.0, 0.0], [5.0, 0.0],
                              [9.0, 0.0], [20.0, 0.0], [40.0, 0.0]])
    sizes = torch.tensor([10, 20, 30, 40, 50, 60])
    qs = torch.tensor([[0.1, 0.0], [39.0, 0.0]])
    # the searcher's sample: each query's min(SAMPLE_TILES, n_probe)
    # nearest clusters, here the four nearest {0, 1, 2, 3} and {5, 4, 3, 2}
    assert search.SAMPLE_TILES == 4

    def sample(n_probe):
        return roofline.probe_counts(centroids, sizes, qs,
                                     min(search.SAMPLE_TILES, n_probe))

    lanes, pairs = sample(6)
    assert lanes == 210 and pairs == 100 + 180
    lanes, pairs = sample(2)
    assert (lanes, pairs) == (30 + 110, 30 + 110)
