"""The GIST1M-width configuration at Faiss's 8-bit codes
(``clustered1m-d960-pq8``, IVF1024,PQ240) at a test's size: d = 960, M =
240 and 8-bit codes kept, the corpus, the clusters and k cut.  A whole run
on the CPU reads ``correct`` and the control is refused; a traced one
leaves out the cell's metric (no device trace there); ``BENCHMARK.json`` resolves the cell; the roofline's yardstick at
8 bits is checked on small counts."""
from __future__ import annotations

import io
import json
from pathlib import Path

import pytest

from portbench import control, harness, roofline
from portbench.tests.conftest import make_root

ROOT = Path(__file__).resolve().parents[2]
CELL = "clustered1m-d960-pq8.batch32"
TINY = "tiny-d960-pq8.batch"
NEW = ("pq8_scan_roofline",)
SEED = 2 ** 31 + 968


@pytest.fixture
def pq8_root(tmp_path) -> Path:
    root = make_root(tmp_path)
    base = root / "portbench"
    cfg = json.loads((base / "configs" / "clustered1m-d960-pq8.json")
                     .read_text())
    cfg.update(name="tiny-d960-pq8", n=6000)
    cfg["index"].update(n_clusters=32, kmeans_iters=4)
    cfg["search"]["n_probe"] = 8
    (base / "configs" / "tiny-d960-pq8.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny-d960-pq8", "source": "a test's size",
        "file": "portbench/configs/tiny-d960-pq8.json", "reduced": [],
        "why": "a test's size"})
    bench["workloads"].append({"name": TINY, "config": "tiny-d960-pq8",
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


def test_the_cell_resolves_at_its_published_widths():
    rc = harness.resolve(ROOT, CELL)
    cfg = rc.cfg
    assert (cfg["n"], cfg["d"], cfg["index"]["pq_m"]) == (1000000, 960, 240)
    assert cfg["index"]["pq_bits"] == 8 and cfg["reduced"] == ["data"]
    assert cfg["index"]["n_clusters"] == 1024
    assert "IVF1024,PQ240" in cfg["source"] and len(cfg["source"]) <= 200
    assert cfg["check"] == {"reference": "portbench/reference.py",
                            "exact_rows": "all",
                            "limits": {"dist_err": 1e-3, "unsorted_rows": 0}}
    d960 = harness.resolve(ROOT, "clustered1m-d960-pq.batch32").cfg
    assert cfg["search"] == d960["search"] and cfg["data"] == d960["data"]
    assert rc.cell["chips"] == 1 and rc.cell["traffic"] == "batch32"
    assert rc.traffic["k"] == 5000 and rc.traffic["batch"] == 32
    # the cell reports its own metric and joins no other
    assert set(rc.metrics) == set(NEW)
    for name in NEW:
        assert callable(harness.load_module(rc.metrics[name], "metric").read)
    assert rc.method == ROOT / "portbench" / "methods" / "ivfpq.py"


def test_a_sound_run_at_8_bits_is_correct_and_the_control_refused(pq8_root):
    res = _run(pq8_root, trace=False, seconds=1.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert 0.5 < res["metrics"]["recall_at_k"]["value"] <= 1.0
    out = control.control_numbers(pq8_root, TINY, 5, "cpu")
    assert out["dist_err"] > out["limits"]["dist_err"], out


def test_a_traced_run_leaves_the_new_metrics_out_on_the_cpu(pq8_root):
    res = _run(pq8_root, trace=True, seconds=2.0)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert {"kernels_per_call", "reranked_per_query"} <= set(m)
    assert not set(NEW) & set(m)


def test_the_8_bit_scan_work_is_a_floor():
    """``roofline.fused_scan_work`` at 8 bits: each query's LUT (M x 256
    fp32) once, the probed lanes' codes at one byte a sub-quantizer, the
    inline rows once, 12 B of outputs a probed pair."""
    b, n_probe, m_sub, d, m = 2, 8, 240, 960, 128
    lanes, pairs, rows, pairs_pred = 1000, 1500, 30, 50
    nbytes, ops = roofline.fused_scan_work(b, n_probe, m_sub, 8, d, m, lanes,
                                           pairs, rows, pairs_pred)
    assert nbytes == (lanes * m_sub + rows * d * 4 + 4 * b * n_probe
                      + 12 * pairs + 4 * b * (m + 2)
                      + 4 * b * (m_sub * 256 + d + roofline.N_EW + 3))
    assert ops == pairs * m_sub + 3 * d * pairs_pred
    four, _ = roofline.fused_scan_work(b, n_probe, m_sub, 4, d, m, lanes,
                                       pairs, rows, pairs_pred)
    # half the code bytes and a sixteenth of the LUT bytes at 4 bits
    assert nbytes - four == lanes * m_sub // 2 + 4 * b * m_sub * 240
