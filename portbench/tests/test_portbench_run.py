"""Whole runs of small cells on the CPU (the harness's look for a card
skipped), the faults that ``correct`` has to refuse, the control, a cell
added by new files alone, and the command's exit without a card."""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import control, harness

ROOT = Path(__file__).resolve().parents[2]
E2E = ["setup_s", "qps", "latency_p95_ms", "recall_at_k", "serve_mem_gib"]
SEED = 2 ** 31 + 11


def run(root, cell, trace=False, seconds=1.0):
    out = io.StringIO()
    res = harness.run_cell(root, cell, SEED, seconds, trace, device="cpu",
                           out=out)
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == res
    return res


@pytest.mark.parametrize("cell", ["tiny-pq.batch", "tiny-rabitq.batch",
                                  "tiny-pq.single"])
def test_a_sound_run_is_correct(tiny_root, cell):
    res = run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert list(res["metrics"]) == E2E
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert 0.5 < res["metrics"]["recall_at_k"]["value"] <= 1.0


def test_a_traced_run_reports_its_layers(tiny_root):
    res = run(tiny_root, "tiny-pq.batch", trace=True, seconds=3.0)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    # the CPU has no device trace: no kernel, so no roofline share
    assert {"syncs_per_call", "kernels_per_call", "reranked_per_query",
            "device_idle_pct"} <= set(m)
    assert "fused_scan_roofline" not in m
    assert m["reranked_per_query"]["value"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


def _stale(search):
    first = []

    def broken(self, qs, pred_state=None):
        if not first:
            first.append(search(self, qs))
        return first[0]
    return broken


def _half(search):
    def broken(self, qs, pred_state=None):
        r = search(self, qs)
        if r.ids.ndim < 2:
            return r
        h = r.ids.shape[0] // 2
        ids, d = r.ids.clone(), r.dists.clone()
        ids[h:2 * h], d[h:2 * h] = ids[:h], d[:h]
        return r._replace(ids=ids, dists=d)
    return broken


def _altered(search):
    def broken(self, qs, pred_state=None):
        r = search(self, qs)
        ids = r.ids.clone()
        row = ids if ids.ndim == 1 else ids[0]
        row.copy_(row.roll(1))
        return r._replace(ids=ids)
    return broken


def _swapped(search):
    """The last two rows of every answer swapped, each with its own id."""
    def broken(self, qs, pred_state=None):
        r = search(self, qs)
        return r._replace(ids=r.ids[..., [*range(r.ids.shape[-1] - 2), -1,
                                          -2]],
                          dists=r.dists[..., [*range(r.ids.shape[-1] - 2),
                                              -1, -2]])
    return broken


def _unranked(search):
    """The second-to-last row of every answer reports a distance 0.1% off,
    as an estimate would, though the rows around it are ranked exactly."""
    def broken(self, qs, pred_state=None):
        r = search(self, qs)
        d = r.dists.clone()
        d[..., -2] *= 1.001
        return r._replace(dists=d)
    return broken


@pytest.mark.parametrize("cell,fault,check", [
    ("tiny-pq.batch", _stale, "dist_err"),
    ("tiny-pq.batch", _half, "dist_err"),
    ("tiny-pq.batch", _altered, "dist_err"),
    ("tiny-pq.batch", _swapped, "unsorted_rows"),
    ("tiny-pq.batch", _unranked, "dist_err"),
    ("tiny-rabitq.batch", _stale, "dist_err"),
    ("tiny-rabitq.batch", _half, "dist_err"),
    ("tiny-rabitq.batch", _altered, "dist_err"),
    ("tiny-rabitq.batch", _swapped, "unsorted_rows"),
    ("tiny-rabitq.batch", _unranked, "exact_before_estimate"),
    ("tiny-pq.single", _stale, "dist_err"),
    ("tiny-pq.single", _altered, "dist_err")])
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault, check,
                                            monkeypatch):
    from repro_torch.index import engine
    monkeypatch.setattr(engine.SearchEngine, "search",
                        fault(engine.SearchEngine.search))
    res = run(tiny_root, cell)
    assert not res["correct"]
    assert res["checks"][check]["value"] > res["checks"][check]["limit"]


def test_the_reference_reads_queries_and_corpus_the_program_never_held(
        tiny_root, monkeypatch):
    """A program that rounds the queries and the corpus it was handed, in
    place, is judged on the data the benchmark made."""
    from repro_torch.index import engine, search
    build, find = search.build_pq_index, engine.SearchEngine.search

    def rounding_build(x, *a, **kw):
        x.copy_(x.half().float())
        return build(x, *a, **kw)

    def rounding_search(self, qs, pred_state=None):
        qs.copy_(qs.half().float())
        return find(self, qs)
    monkeypatch.setattr(search, "build_pq_index", rounding_build)
    monkeypatch.setattr(engine.SearchEngine, "search", rounding_search)
    res = run(tiny_root, "tiny-pq.batch")
    assert not res["correct"]
    assert res["checks"]["dist_err"]["value"] > res["checks"]["dist_err"][
        "limit"]


def test_a_failing_call_is_not_correct(tiny_root, monkeypatch):
    from repro_torch.index import engine
    search = engine.SearchEngine.search
    calls = []

    def flaky(self, qs, pred_state=None):
        calls.append(1)
        if len(calls) == 5:
            raise RuntimeError("injected")
        return search(self, qs)
    monkeypatch.setattr(engine.SearchEngine, "search", flaky)
    res = run(tiny_root, "tiny-pq.batch")
    assert res["failed"] == 8 and not res["correct"]


@pytest.mark.parametrize("cell", ["tiny-pq.batch", "tiny-rabitq.batch",
                                  "tiny-pq.single"])
def test_the_control_is_refused(tiny_root, cell):
    out = control.control_numbers(tiny_root, cell, 5, "cpu")
    assert out["dist_err"] > out["limits"]["dist_err"], out


def _digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts
        and p.name != "BENCHMARK.json"}


def test_a_cell_is_added_by_new_files_alone(tiny_root):
    base = tiny_root / "portbench"
    before = _digest(tiny_root)
    cfg = json.loads((base / "configs" / "tiny-pq.json").read_text())
    cfg["name"] = "tiny-pq2"
    cfg["search"]["n_probe"] = 8
    (base / "configs" / "tiny-pq2.json").write_text(json.dumps(cfg))
    tr = json.loads((base / "traffic" / "tiny-batch.json").read_text())
    tr.update(driver="closed_batch2", batch=4)
    (base / "traffic" / "tiny-batch4.json").write_text(json.dumps(tr))
    shutil.copy(base / "drivers" / "closed_batch.py",
                base / "drivers" / "closed_batch2.py")
    (base / "metrics" / "traced_calls.py").write_text(
        "def read(ctx):\n    return len(ctx.window.traced)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-pq2", "source": "a test",
                             "file": "portbench/configs/tiny-pq2.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-pq2.b4", "config": "tiny-pq2",
                               "traffic": "tiny-batch4", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "traced_calls", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "qps",
                               "workloads": ["tiny-pq2.b4"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before
    res = run(tiny_root, "tiny-pq2.b4", trace=True, seconds=4.0)
    assert res["correct"]
    assert res["metrics"]["traced_calls"]["value"] == 6
    assert set(res["metrics"]) == {"traced_calls"}


def test_a_run_that_loaded_jax_prints_no_result(tiny_root, monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    out = io.StringIO()
    with pytest.raises(SystemExit, match="jax"):
        harness.run_cell(tiny_root, "tiny-pq.batch", SEED, 0.5, False,
                         device="cpu", out=out)
    assert out.getvalue() == ""


def test_the_command_exits_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "clustered1m-pq.batch32", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_a_run_without_the_program_prints_no_result(tiny_root):
    shutil.rmtree(tiny_root / "portbench" / "tests", ignore_errors=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys; sys.path[0:0] = ['.']\n"
            "from pathlib import Path\nfrom portbench import harness\n"
            "harness.run_cell(Path('.'), 'tiny-pq.batch', 1, 1.0, False, "
            "device='cpu')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "repro_torch" in proc.stderr


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of the main cell on the card: correct, and the
    result's keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "clustered1m-pq.batch32", "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res["metrics"]) == E2E
