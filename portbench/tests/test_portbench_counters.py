"""The work counters' metrics (``portbench/counters.py``,
``scan_probed_pct`` and ``full_width_calls_pct``): a traced CPU run
reports them at the values its counters give, a program without counters
leaves them out, and the program's probed pairs agree with the roofline's
own routing where no centroid distance ties at the probe boundary."""
from __future__ import annotations

import io
import json
from types import SimpleNamespace

import pytest

from portbench import counters, harness, roofline

SEED = 2 ** 31 + 23
TWO = {"scan_probed_pct", "full_width_calls_pct"}


def run(root, cell):
    out = io.StringIO()
    res = harness.run_cell(root, cell, SEED, 3.0, True, device="cpu",
                           out=out)
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == res
    return res


@pytest.mark.parametrize("cell", ["tiny-pq.batch", "tiny-rabitq.batch"])
def test_a_traced_run_reports_the_counter_metrics(tiny_root, cell,
                                                  monkeypatch, capfd):
    from repro_torch import spans
    spans.clear()
    seen = []
    real = counters.read

    def spy(ctx):
        seen.append(ctx)
        return real(ctx)
    monkeypatch.setattr(counters, "read", spy)
    res = run(tiny_root, cell)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert TWO <= set(m) and all(m[k]["unit"] == "%" for k in TWO)
    assert "portbench: counters over" in capfd.readouterr().err

    # by hand: the counters of the calls whose root lies in a counted call
    ctx = seen[0]
    base = ctx.window.profiler.kineto_results.trace_start_ns()
    kept = set()
    for r in spans.records():
        if r.name == "engine.search" and r.parent == 0:
            s, t = (r.t0_ns - base) / 1e3, (r.t1_ns - base) / 1e3
            if any(a <= s and t <= b for a, b in ctx.profile.calls):
                kept.add(r.call)
    assert len(kept) == ctx.profile.n_calls
    by_call = {c: {} for c in kept}
    for c in spans.counters():
        if c.call in kept:
            by_call[c.call][c.name] = by_call[c.call].get(c.name, 0) + c.value
    probed = sum(v["scan.pairs_probed"] for v in by_call.values())
    passed = sum(v["scan.pairs_passed"] for v in by_call.values())
    fired = sum(any(v.get(n, 0) for n in counters.FULL_WIDTH)
                for v in by_call.values())
    assert m["scan_probed_pct"]["value"] == 100.0 * probed / passed
    assert m["full_width_calls_pct"]["value"] == 100.0 * fired / len(kept)
    # 16 of 64 lists probed: a share of the lanes, not all of them
    assert 0.0 < m["scan_probed_pct"]["value"] < 100.0


def test_a_program_without_counters_leaves_the_metrics_out(tiny_root,
                                                           monkeypatch):
    from repro_torch import spans
    monkeypatch.delattr(spans, "counters")
    res = run(tiny_root, "tiny-pq.batch")
    assert res["correct"]
    assert not TWO & set(res["metrics"])
    assert "searcher_idle_ms" in res["metrics"]


def _rec(span, parent, name, t0, t1, call):
    return SimpleNamespace(call=call, span=span, parent=parent, name=name,
                           t0_ns=1000 + int(t0 * 1e3),
                           t1_ns=1000 + int(t1 * 1e3))


def _cnt(call, name, value):
    return SimpleNamespace(call=call, span=call, name=name, value=value)


def test_tally_keeps_the_counted_calls_and_counts_fall_backs_per_call():
    records = [_rec(1, 0, "engine.search", 1, 40, 1),
               _rec(2, 1, "pq.route", 2, 5, 1),
               _rec(3, 0, "engine.search", 50, 90, 3),
               # a call outside the counted intervals is not kept
               _rec(4, 0, "engine.search", 120, 130, 4)]
    counts = [_cnt(1, "scan.pairs_probed", 30),
              _cnt(1, "scan.pairs_passed", 100),
              _cnt(1, "collect.widened", 0),
              _cnt(3, "scan.pairs_probed", 10),
              _cnt(3, "scan.pairs_passed", 100),
              _cnt(3, "rerank.dense_stragglers", 1),
              _cnt(3, "select.full_width", 1),
              _cnt(4, "scan.pairs_probed", 99), _cnt(4, "collect.widened", 1)]
    c = counters.tally(records, counts, 1000, [(0.0, 45.0), (45.0, 100.0)],
                       dropped=2)
    assert c.calls == 2 and c.dropped == 2
    assert c.totals == {"scan.pairs_probed": 40, "scan.pairs_passed": 200,
                        "collect.widened": 0, "rerank.dense_stragglers": 1,
                        "select.full_width": 1}
    assert c.full_width_calls == 1
    assert counters.summary(c).endswith("recorder dropped 2")
    assert counters.tally(records, [], 1000, [(0.0, 45.0)]) is None


# The roofline's own routing (fp32 broadcast difference, ``torch.topk``)
# against the program's (``ordered_sum``, ``rb.smallest``): at seed 5 every
# query's n_probe-th and next-nearest centroids lie more than 1e-4 apart
# (checked below), so no rounding difference can swap them and the two
# must count the same pairs; near such a tie they may differ by a list.
def test_the_programs_probed_pairs_equal_the_rooflines_routing():
    import torch
    from repro_torch import spans
    from repro_torch.index import engine, search
    g = torch.Generator().manual_seed(5)
    x = torch.randn(8000, 32, generator=g)
    qs = x[:16] + 0.1 * torch.randn(16, 32, generator=g)
    n_probe = 12
    index = search.build_pq_index(x, 64, n_sub=8, n_bits=4, n_iter=4,
                                  device="cpu")
    eng = engine.SearchEngine.build(index, k=50, n_probe=n_probe,
                                    n_cand=400, use_bbc=True, fused=True,
                                    device="cpu", tuned=None)
    cent = index.ivf.centroids
    d2 = ((qs[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
    near = torch.sort(d2, dim=1).values
    assert float((near[:, n_probe] - near[:, n_probe - 1]).min()) > 1e-4
    spans.clear()
    with torch.autograd.profiler.profile(use_kineto=True):
        eng.search(qs)
    got = sum(c.value for c in spans.counters()
              if c.name == "scan.pairs_probed")
    spans.clear()
    _, pairs = roofline.probe_counts(cent, index.ivf.cluster_sizes, qs,
                                     n_probe)
    assert got == pairs
