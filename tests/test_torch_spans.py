"""The stage spans of the batched searchers (``repro_torch.spans``): off
without a profiler, one stage sequence per call under one, on the
profiler's clock, results unchanged, and a bounded buffer."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import profiler as ap  # noqa: E402
from torch.autograd.profiler import record_function  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.core import buffer as rb  # noqa: E402
from repro_torch.core import collector as col  # noqa: E402
from repro_torch.index import engine, search  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(2)

PQ_STAGES = ["engine.h2d", "pq.route", "pq.tables", "pq.sample", "pq.scan",
             "collect", "rerank.second_pass", "select"]
RABITQ_STAGES = ["engine.h2d", "rabitq.route", "rabitq.sample", "rabitq.scan",
                 "rabitq.band", "rerank.stragglers", "select"]
WAITS = {"collect": ["wait.collect_overflow"],
         "rerank.second_pass": ["wait.rerank_nonzero"],
         "rerank.stragglers": ["wait.straggler_budget"]}


@pytest.fixture(scope="module")
def data():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6000, 32, generator=g)
    qs = x[:8] + 0.01 * torch.randn(8, 32, generator=g)
    return x, qs


@pytest.fixture(scope="module")
def engines(data):
    """The two cells' forms: the fused PQ BBC batch (the CPU default is
    unfused) and the bound-fused RaBitQ batch."""
    x, _ = data
    pq = search.build_pq_index(x, 32, n_sub=8, n_bits=4, n_iter=4,
                               device="cpu")
    rq = search.build_rabitq_index(x, 32, n_iter=4, device="cpu")
    return {
        "pq": engine.SearchEngine.build(pq, k=100, n_probe=8, n_cand=800,
                                        fused=True, device="cpu", tuned=None),
        "rabitq": engine.SearchEngine.build(rq, k=100, n_probe=8, fused=True,
                                            device="cpu", tuned=None)}


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.clear()
    yield
    spans.clear()


def _by_call(recs):
    calls = {}
    for r in recs:
        calls.setdefault(r.call, []).append(r)
    return [sorted(rs, key=lambda r: r.t0_ns) for _, rs in sorted(
        calls.items())]


def test_off_without_a_profiler(engines, data):
    assert spans.span("a") is spans.span("b")
    with spans.span("a"):
        engines["pq"].search(data[1])
    assert spans.records() == [] and spans.RECORDER.dropped == 0


@pytest.mark.parametrize("kind,stages", [("pq", PQ_STAGES),
                                         ("rabitq", RABITQ_STAGES)])
def test_each_call_records_its_stages_once(engines, data, kind, stages):
    eng, qs = engines[kind], data[1]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            eng.search(qs)
    calls = _by_call(spans.records())
    assert len(calls) == 2
    for recs in calls:
        root = recs[0]
        assert root.name == "engine.search" and root.parent == 0
        assert {r.call for r in recs} == {root.call}
        assert len({r.span for r in recs}) == len(recs)
        kids = [r for r in recs if r.parent == root.span]
        assert [r.name for r in kids] == stages
        for a, b in zip(kids, kids[1:]):
            assert a.t1_ns <= b.t0_ns
        for k in kids:
            assert root.t0_ns <= k.t0_ns <= k.t1_ns <= root.t1_ns
            waits = [r.name for r in recs if r.parent == k.span]
            assert waits[:len(WAITS.get(k.name, []))] == WAITS.get(k.name, [])
            assert set(waits) <= {"wait.straggler_budget",
                                  "wait.rerank_nonzero", *WAITS.get(k.name,
                                                                    [])}
            for w in recs:
                if w.parent == k.span:
                    assert k.t0_ns <= w.t0_ns <= w.t1_ns <= k.t1_ns
        covered = sum(k.t1_ns - k.t0_ns for k in kids)
        assert covered >= 0.9 * (root.t1_ns - root.t0_ns)


@pytest.mark.parametrize("kind", ["pq", "rabitq"])
def test_results_are_bitwise_the_same_with_spans_on(engines, data, kind):
    eng, qs = engines[kind], data[1]
    off = eng.search(qs)
    with ap.profile(use_kineto=True):
        on = eng.search(qs)
    assert spans.records()
    for name, a, b in zip(off._fields, off, on):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_records_fall_inside_the_profilers_range(engines, data):
    eng, qs = engines["pq"], data[1]
    with ap.profile(use_kineto=True) as prof:
        for _ in range(3):
            with record_function("call"):
                eng.search(qs)
    base = prof.kineto_results.trace_start_ns()
    ranges = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.function_events if e.name == "call")
    roots = sorted(r for r in spans.records() if r.name == "engine.search")
    assert len(ranges) == len(roots) == 3
    for (s, t), r in zip(ranges, sorted(roots, key=lambda r: r.t0_ns)):
        assert s <= (r.t0_ns - base) / 1e3 <= (r.t1_ns - base) / 1e3 <= t
    # the spans are no profiler events
    names = {e.name for e in prof.function_events}
    assert not names & {"engine.search", "pq.scan", "collect"}


def test_a_host_tensor_sent_to_another_device_waits(engines, data):
    eng = dataclasses.replace(engines["pq"], device=torch.device("meta"))
    with ap.profile(use_kineto=True):
        out = eng._to_device(data[1].double())
        eng._to_device(out)
    assert out.device.type == "meta" and out.dtype == torch.float32
    recs = sorted(spans.records(), key=lambda r: r.t0_ns)
    assert [r.name for r in recs] == ["engine.h2d", "wait.h2d",
                                      "engine.h2d"]
    assert recs[1].parent == recs[0].span and recs[1].call == recs[0].call
    assert recs[2].call != recs[0].call


def test_records_past_capacity_are_dropped_and_counted():
    rec = spans.Recorder(capacity=3)
    with ap.profile(use_kineto=True):
        with rec.span("outer"):
            for i in range(4):
                with rec.span(f"inner{i}"):
                    pass
    got = rec.records()
    assert [r.name for r in got] == ["inner0", "inner1", "inner2"]
    assert rec.dropped == 2
    assert all(r.parent == got[0].call for r in got)
    got.clear()
    assert len(rec.records()) == 3
    rec.clear()
    assert rec.records() == [] and rec.dropped == 0


def _stage_names(fn):
    """The names of the spans ``fn`` records under a profiler, each with
    its parent's name."""
    with ap.profile(use_kineto=True):
        fn()
    recs = spans.records()
    names = {r.span: r.name for r in recs}
    return [(r.name, names.get(r.parent)) for r in recs]


@pytest.mark.parametrize("case", ["fits", "widens", "short_row"])
def test_collect_compacts_once_in_every_case(monkeypatch, case):
    """``collect`` makes one compaction and one host read whether the
    survivors fit the buffer, widen it, or fall short of k (here: a query
    with no valid lane): it has no full-width branch."""
    n, k, m = 600, 50, 16
    g = torch.Generator().manual_seed(1)
    bucket = torch.randint(1, m, (2, n), generator=g, dtype=torch.int32)
    bucket[:, :60] = 0
    if case == "widens":
        bucket[0] = 0
    valid = torch.ones(2, n, dtype=torch.bool)
    if case == "short_row":
        valid[1] = False
    dists = bucket + torch.rand(2, n, generator=g)
    hist = rb.histogram(bucket, m, valid)
    widths = []

    def compact(bucket, valid, tau, budget):
        widths.append(budget)
        return spec_compact(bucket, valid, tau, budget)

    spec_compact = ops.spec_compact_batch
    monkeypatch.setattr(ops, "spec_compact_batch", compact)
    got = _stage_names(lambda: col.collect_batch(
        dists, torch.arange(n), valid, bucket, hist, k, m))
    assert got == [("wait.collect_overflow", "collect"), ("collect", None)]
    assert widths == [n if case == "widens" else
                      rb._collect_budget(k, n, 2, m)]


@pytest.mark.parametrize("short_row", [False, True])
def test_select_full_width_span_only_on_its_branch(engines, data, short_row):
    """``select.full_width`` is recorded inside the fused RaBitQ path's
    ``select`` when a query probes fewer than k lanes, and not
    otherwise."""
    eng, qs = engines["rabitq"], data[1]
    _, lane_valid, _ = search._routing(eng.index.ivf, eng.layout, qs,
                                       eng.n_probe)
    lanes = lane_valid.sum(1)
    assert int(lanes.min()) < int(lanes.max())
    k = int(lanes.min()) + 1 if short_row else eng.k
    got = _stage_names(lambda: search.ivf_rabitq_search_batch(
        eng.index, eng.stream, qs, eng.layout, k=k, n_probe=eng.n_probe,
        use_bbc=True))
    assert ("select", None) in got
    assert (("select.full_width", "select") in got) == short_row
    assert sum(name == "select.full_width" for name, _ in got) == short_row
