"""``straggler_tiles_read_pct``: the share of the row tiles RaBitQ's masked
straggler pass staged, from the program's ``rerank.straggler_tiles_read``
and ``rerank.straggler_tiles`` counters (``portbench/counters.py``).  A
traced CPU run of the small RaBitQ cell, whose stragglers outgrow the
gather budget, reports it at the value its counters give; a program
without the masked pass's counters, a PQ cell and an untraced run leave
it out."""
from __future__ import annotations

import io
import json
from types import SimpleNamespace

import pytest

from portbench import counters, harness
from portbench.tests.conftest import ROOT

SEED = 2 ** 31 + 40
NAME = "straggler_tiles_read_pct"
READ, TILES = "rerank.straggler_tiles_read", "rerank.straggler_tiles"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def run(root, cell, trace=True):
    out = io.StringIO()
    res = harness.run_cell(root, cell, SEED, 3.0, trace, device="cpu",
                           out=out)
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == res
    return res


def reader():
    return harness.load_module(ROOT / "portbench" / "metrics" /
                               f"{NAME}.py", "metric")


def test_the_metric_is_listed_for_the_two_rabitq_cells():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == NAME]
    assert m == {"name": NAME, "unit": "%", "better": "lower",
                 "source": "program_counter",
                 "layer": "collector and re-rank", "moves": "qps",
                 "workloads": ["gist1m-rabitq.batch32",
                               "clustered1m-rabitq.batch32"]}
    assert BENCH["per_layer"][-1] is m


def test_a_traced_rabitq_run_reads_the_tiles_from_the_counters(
        tiny_root, monkeypatch, capfd):
    from repro_torch import spans
    spans.clear()
    seen = []
    real = counters.read

    def spy(ctx):
        seen.append(ctx)
        return real(ctx)
    monkeypatch.setattr(counters, "read", spy)
    res = run(tiny_root, "tiny-rabitq.batch")
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m[NAME]["unit"] == "%"
    assert f"{READ} " in capfd.readouterr().err
    c = seen[0].counts
    assert c.totals[TILES] > 0
    assert m[NAME]["value"] == 100.0 * c.totals[READ] / c.totals[TILES]
    # the dense branch in every counted call, and the tiles the probed
    # lists hold, not every tile
    assert c.totals["rerank.dense_stragglers"] == c.calls
    assert 0.0 < m[NAME]["value"] <= 100.0


def test_a_pq_run_and_an_untraced_run_leave_it_out(tiny_root):
    assert NAME not in run(tiny_root, "tiny-pq.batch")["metrics"]
    assert NAME not in run(tiny_root, "tiny-rabitq.batch",
                           trace=False)["metrics"]


def test_a_program_without_the_masked_pass_leaves_it_out(tiny_root,
                                                         monkeypatch):
    """The parent's program: the dense pass, no tile counters."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "l2_exact_batch_masked",
                        lambda x, qs, mask: ops.l2_exact_batch(x, qs))
    res = run(tiny_root, "tiny-rabitq.batch")
    assert res["correct"]
    assert NAME not in res["metrics"]
    assert "full_width_calls_pct" in res["metrics"]


@pytest.mark.parametrize("totals,want", [
    ({READ: 30, TILES: 120}, 25.0),
    ({READ: 0, TILES: 40}, 0.0),
    ({READ: 7, TILES: 7}, 100.0),
    ({TILES: 40}, None),                     # no staged count
    ({READ: 0, TILES: 0}, None),             # no tiles at all
    ({"scan.pairs_probed": 3}, None)])       # the gather branch only
def test_the_reader_is_the_tiles_read_over_the_tiles(totals, want):
    ctx = SimpleNamespace(counts=counters.Counts(calls=2, totals=totals))
    assert reader().read(ctx) == want
    assert reader().read(SimpleNamespace(counts=None)) is None
