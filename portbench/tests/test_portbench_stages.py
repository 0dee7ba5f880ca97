"""The stage metrics (``portbench/stages.py`` and its five readers): a
traced CPU run reports them and they hold the idle time of the program's
entry; device time goes to the stage that launched it; a program without
the spans leaves them out."""
from __future__ import annotations

import io
import json
import sys
from types import SimpleNamespace

import pytest

from portbench import harness, profiling, stages

SEED = 2 ** 31 + 11
FIVE = {"searcher_idle_ms", "searcher_device_ms", "collector_idle_ms",
        "collector_device_ms", "host_wait_ms"}


def run(root, cell):
    out = io.StringIO()
    res = harness.run_cell(root, cell, SEED, 3.0, True, device="cpu",
                           out=out)
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == res
    return res


def _idle_in_search(tr) -> float:
    return sum(max(0.0, min(b, t) - max(a, s)) for s, t in tr.searches
               for a, b in tr.idle_gaps())


@pytest.mark.parametrize("cell", ["tiny-pq.batch", "tiny-rabitq.batch"])
def test_a_traced_run_reports_the_stage_metrics(tiny_root, cell,
                                                monkeypatch):
    seen = []
    real = stages.read

    def spy(ctx):
        seen.append(ctx)
        return real(ctx)
    monkeypatch.setattr(stages, "read", spy)
    res = run(tiny_root, cell)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert FIVE <= set(m)
    assert all(m[k]["unit"] == "ms" and m[k]["value"] >= 0 for k in FIVE)
    # the CPU has no device: every stage's time is idle time, none device
    assert m["searcher_device_ms"]["value"] == 0.0
    assert m["collector_device_ms"]["value"] == 0.0
    assert m["searcher_idle_ms"]["value"] > 0
    assert m["collector_idle_ms"]["value"] > 0
    assert m["host_wait_ms"]["value"] > 0
    ctx = seen[0]
    st, tr = ctx.stage_times, ctx.profile
    assert st.calls == tr.n_calls and st.syncs_outside_waits == 0
    covered = (m["searcher_idle_ms"]["value"]
               + m["collector_idle_ms"]["value"]) * 1e3 * tr.n_calls
    assert covered >= 0.9 * _idle_in_search(tr)


def test_a_program_without_spans_leaves_the_metrics_out(tiny_root,
                                                        monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    res = run(tiny_root, "tiny-pq.batch")
    assert res["correct"]
    assert not FIVE & set(res["metrics"])
    assert "device_idle_pct" in res["metrics"]


CUDA, CPU = "cuda", "cpu"


def _ev(name, start, end, device=CPU, id=0, linked=0):
    return SimpleNamespace(name=name, device_type=device, id=id,
                           linked_correlation_id=linked,
                           time_range=SimpleNamespace(start=start, end=end))


def _rec(span, parent, name, t0, t1, call=1):
    # records in ns, the trace starting at 1,000 ns
    return SimpleNamespace(call=call, span=span, parent=parent, name=name,
                           t0_ns=1000 + int(t0 * 1e3),
                           t1_ns=1000 + int(t1 * 1e3))


def test_device_time_goes_to_the_stage_open_at_its_launch():
    """A kernel launched in ``pq.scan`` that runs while the host is in
    ``collect`` is the scan stage's; a copy launched inside a wait span is
    the stage's that holds the wait; the operator named by
    ``linked_correlation_id`` stands in for a missing runtime call."""
    records = [_rec(1, 0, "engine.search", 1, 99),
               _rec(2, 1, "pq.scan", 10, 40),
               _rec(3, 1, "collect", 40, 90),
               _rec(4, 3, "wait.collect_overflow", 70, 80),
               # a call outside the counted one is not kept
               _rec(5, 0, "engine.search", 120, 130, call=5)]
    events = [
        _ev("cudaLaunchKernel", 20, 21, id=7, linked=100),
        _ev("gather_kernel", 50, 60, device=CUDA, id=7, linked=100),
        _ev("cudaMemcpyAsync", 72, 73, id=8, linked=101),
        _ev("Memcpy DtoH", 74, 75, device=CUDA, id=8, linked=101),
        _ev("aten::sort", 45, 46, id=102),
        _ev("sort_kernel", 61, 69, device=CUDA, id=9, linked=102),
        _ev("fused_scan_kernel<8>", 22, 30, device=CUDA, id=10),
        _ev("cudaLaunchKernel", 15, 16, id=10),
        _ev("portbench.search", 0.5, 99.5, device=CUDA),
        _ev("cudaStreamSynchronize", 74, 79, id=11, linked=101),
    ]
    tr = profiling.Trace(
        calls=[(0.0, 100.0)], searches=[(0.5, 99.5)],
        device=[(s, t, n) for s, t, n in [(22, 30, "fused_scan_kernel<8>"),
                                          (50, 60, "gather_kernel"),
                                          (61, 69, "sort_kernel"),
                                          (74, 75, "Memcpy DtoH")]],
        host=[(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == CPU])
    st = stages.assign(records, 1000, tr, events, CUDA)
    assert st.calls == 1
    assert st.device_us == {"pq.scan": 10.0, "collect": 9.0}
    assert st.scan_us == 8.0 and st.device_total_us == 27.0
    assert st.unplaced_us == 0.0
    # idle: the device ran 22-30, 50-60, 61-69, 74-75 of the call 0-100
    assert st.idle_us["pq.scan"] == pytest.approx(30 - 8)
    assert st.idle_us["collect"] == pytest.approx((50 - 40) + (61 - 60)
                                                  + (70 - 69) + (90 - 80))
    assert st.idle_us["wait.collect_overflow"] == pytest.approx(10 - 1)
    assert st.self_us["collect"] == pytest.approx(40.0)
    assert st.wait_us == {"collect": 10.0}
    assert st.syncs_outside_waits == 0
    assert st.clock_slack_us == (0.5, 0.5)
    assert st.per_call_ms(st.device_us, "searcher") == pytest.approx(0.01)
    assert st.per_call_ms(st.self_us, "wait") == pytest.approx(0.01)
