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
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            eng.search(qs)
    base = prof.profiler.kineto_results.trace_start_ns()
    ops_us = [(e.time_range.start, e.time_range.end, e.name)
              for e in prof.profiler.function_events
              if e.cpu_parent is None]
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
        # the stages hold every operator of the call but the entry's own
        # ``torch.as_tensor`` (an exact check: the host time between the
        # stages varies with the machine's load)
        us = [((r.t0_ns - base) / 1e3, (r.t1_ns - base) / 1e3)
              for r in (root, *kids)]
        (r0, r1), stage_us = us[0], us[1:]
        outside = [(s, name) for s, t, name in ops_us if r0 <= s <= r1
                   and not any(a <= s and t <= b for a, b in stage_us)]
        assert [name for _, name in outside] == ["aten::to"]
        assert outside[0][0] <= stage_us[0][0]


@pytest.mark.parametrize("kind", ["pq", "rabitq"])
def test_results_are_bitwise_the_same_with_spans_on(engines, data, kind):
    eng, qs = engines[kind], data[1]
    off = eng.search(qs)
    with ap.profile(use_kineto=True):
        on = eng.search(qs)
    assert spans.records() and spans.counters()
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
    # the widened compaction is counted where it runs, in ``collect``
    assert [(c.name, c.value) for c in spans.counters()] == [
        ("collect.widened", int(case == "widens"))]


@pytest.mark.parametrize("short_row", [False, True])
def test_select_full_width_span_only_on_its_branch(engines, data, short_row):
    """``select.full_width`` is recorded (a span and a counter) inside the
    fused RaBitQ path's ``select`` when a query probes fewer than k lanes,
    and not otherwise."""
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
    # and counted there, in ``select``, once
    assert [c.value for c in spans.counters()
            if c.name == "select.full_width"] == [1] * short_row


# --------------------------------------------------------------------------
# Work counters (``spans.count``)
# --------------------------------------------------------------------------

def _counted(fn):
    """``fn()`` under a profiler, and its counters by name (summed)."""
    with ap.profile(use_kineto=True):
        out = fn()
    got = {}
    for c in spans.counters():
        got[c.name] = got.get(c.name, 0) + c.value
    return out, got


def test_count_records_nothing_without_a_profiler_or_a_span():
    with spans.span("a"):
        spans.count("n", 1)
        spans.count("t", torch.tensor([1, 2]))
    with ap.profile(use_kineto=True):
        spans.count("n", 1)          # no span open: no call to hold it
    assert spans.counters() == [] and spans.records() == []
    assert spans.RECORDER.dropped == 0


def test_counters_attach_to_the_innermost_span_and_resolve_once():
    t = torch.tensor([2, 5])
    with ap.profile(use_kineto=True):
        with spans.span("outer"):
            spans.count("n", 3)
            with spans.span("inner"):
                spans.count("t", t)
    t.add_(1)                        # read after the call, not inside it
    recs = {r.name: r for r in spans.records()}
    got = spans.counters()
    assert [(c.name, c.value, c.span, c.call) for c in got] == [
        ("n", 3, recs["outer"].span, recs["outer"].call),
        ("t", 9, recs["inner"].span, recs["outer"].call)]
    t.add_(1)                        # read once: the tensor is let go
    assert spans.counters() == got
    assert all(type(c.value) is int for c in got)


def test_counters_share_the_spans_capacity():
    rec = spans.Recorder(capacity=2)
    with ap.profile(use_kineto=True):
        with rec.span("outer"):
            rec.count("a", 1)
            rec.count("b", 2)
            rec.count("c", 3)
    assert [c.name for c in rec.counters()] == ["a", "b"]
    assert rec.records() == [] and rec.dropped == 2


@pytest.mark.parametrize("kind", ["pq", "rabitq"])
@pytest.mark.parametrize("tombstones", [False, True])
def test_scan_pairs_probed_is_the_lane_masks_bits(engines, data, kind,
                                                  tombstones):
    """``scan.pairs_probed`` resolves to the set bits of the call's own
    lane mask, on a layout with padding lanes (never probed) and under a
    tombstone mask; ``scan.pairs_passed`` to the pairs the scan walks: the
    lanes of each query's probed lists (tombstoned ones too) in the fused
    PQ scan, every (query, lane) pair in the RaBitQ scan."""
    eng, qs = engines[kind], data[1]
    n_clusters = eng.index.ivf.centroids.shape[0]
    assert int((eng.layout.cluster_of == n_clusters).sum()) > 0   # padding
    if tombstones:
        g = torch.Generator().manual_seed(3)
        eng = eng.with_live(torch.rand(data[0].shape[0], generator=g) > 0.3)
        assert not bool(eng.live.all())
    probed, lane_valid, _ = search._routing(eng.index.ivf, eng.layout, qs,
                                            eng.n_probe, eng.live)
    _, got = _counted(lambda: eng.search(qs))
    assert got["scan.pairs_probed"] == int(lane_valid.sum())
    offsets = eng.layout.offsets
    walked = int((offsets[probed + 1] - offsets[probed]).sum())
    assert walked < qs.shape[0] * eng.layout.n_flat
    assert (walked > int(lane_valid.sum())) == tombstones
    assert got["scan.pairs_passed"] == (
        walked if kind == "pq" else qs.shape[0] * eng.layout.n_flat)


def _scan_inputs(b, n, m_sub, k_codes, d, m=16):
    g = torch.Generator().manual_seed(4)
    return dict(
        codes=torch.randint(0, k_codes, (n, m_sub), generator=g,
                            dtype=torch.uint8),
        vectors=torch.randn(n, d, generator=g),
        valid=torch.rand(b, n, generator=g) > 0.5,
        luts=torch.rand(b, m_sub, k_codes, generator=g),
        qs=torch.randn(b, d, generator=g),
        d_min=torch.zeros(b), delta=torch.full((b,), 0.5),
        ew_maps=torch.zeros(b, 256, dtype=torch.int32), m=m,
        tau_pred=torch.full((b,), 2, dtype=torch.int32))


@pytest.mark.parametrize("plan", ["whole", "chunked", "rabitq"])
def test_scan_pairs_passed_is_the_grids_pairs(engines, data, plan):
    """``scan.pairs_passed`` is B x n for the whole-LUT scan, the
    chunked-LUT scan (the shapes at which the card's plan takes each) and
    the bound-fused RaBitQ scan."""
    if plan == "rabitq":
        eng, qs = engines["rabitq"], data[1]
        _, got = _counted(lambda: eng.search(qs))
        b, n = qs.shape[0], eng.layout.n_flat
    else:
        b, n = 3, 300
        m_sub, k_codes, d = (8, 16, 32) if plan == "whole" else (240, 256,
                                                                 960)
        assert ops._batch_scan_plan(b, n, m_sub, k_codes, d, 256,
                                    16).chunked == (plan == "chunked")
        kw = _scan_inputs(b, n, m_sub, k_codes, d)

        def scan():
            with spans.span("scan"):
                return ops.fused_scan_batch(**kw)
        _, got = _counted(scan)
        assert got["scan.pairs_probed"] == int(kw["valid"].sum())
    assert got["scan.pairs_passed"] == b * n


@pytest.mark.parametrize("k,dense", [(10, True), (100, False)])
def test_dense_stragglers_counted_when_the_widest_row_outgrows_the_budget(
        engines, data, k, dense):
    """``rerank.dense_stragglers`` is 1 exactly where the widest row's
    stragglers (``n_second_pass``) exceed the gather budget, so the call
    takes the dense exact pass: at every probed cluster, k = 10 leaves
    more than 2,048 stragglers and k = 100 fewer."""
    eng, qs = engines["rabitq"], data[1]
    n_probe = eng.index.ivf.centroids.shape[0]
    res, got = _counted(lambda: search.ivf_rabitq_search_batch(
        eng.index, eng.stream, qs, eng.layout, k=k, n_probe=n_probe,
        use_bbc=True))
    n_flat = eng.layout.n_flat
    budget = min(n_flat, ((max(2 * k, 2048) + 127) // 128) * 128)
    assert (int(res.n_second_pass.max()) > budget) == dense
    assert got["rerank.dense_stragglers"] == int(dense)
    assert "select.full_width" not in got


HOST_READS = ("item", "tolist", "__int__", "__float__", "__bool__")


@pytest.mark.parametrize("kind", ["pq", "rabitq"])
def test_counting_adds_no_launch_and_no_host_read(engines, data, kind,
                                                  monkeypatch):
    """A call makes the same kernel launches and host reads with the
    recorder on as off: the counters read nothing inside it."""
    eng, qs = engines[kind], data[1]
    reads = {name: 0 for name in HOST_READS}
    for name in HOST_READS:
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            reads[_name] += 1
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)

    def one_call(on: bool):
        for name in reads:
            reads[name] = 0
        launches = dict(ops.LAUNCHES)
        if on:
            with ap.profile(use_kineto=True):
                eng.search(qs)
        else:
            eng.search(qs)
        return dict(reads), {k: v - launches[k]
                             for k, v in ops.LAUNCHES.items()}

    off = one_call(False)
    on = one_call(True)
    assert spans.counters()
    assert on == off
    assert sum(off[0].values()) > 0        # the spies see the call's reads


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _launches(fn):
    before = dict(ops.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in ops.LAUNCHES.items()
                 if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pq", "rabitq", "chunked"])
def test_cuda_counters_read_the_lane_mask_and_add_no_launch(data, kind,
                                                            cuda):
    """On the card: ``scan.pairs_probed`` is the lane mask's set bits in
    the whole-LUT, chunked-LUT and RaBitQ scans, ``scan.pairs_passed`` the
    lanes the whole-LUT scan walks (each query's probed lists) and every
    pair in the other two, and a call launches the same kernels with the
    recorder on as off."""
    x, qs = (t.to(cuda) for t in data)
    if kind == "chunked":
        kw = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v
              for k, v in _scan_inputs(3, 300, 240, 256, 960).items()}

        def call():
            with spans.span("scan"):
                return ops.fused_scan_batch(**kw)
        valid = kw["valid"]
    else:
        if kind == "pq":
            ix = search.build_pq_index(x, 32, n_sub=8, n_bits=4, n_iter=4,
                                       device=cuda)
            eng = engine.SearchEngine.build(ix, k=100, n_probe=8, n_cand=800,
                                            fused=True, device=cuda,
                                            tuned=None)
        else:
            ix = search.build_rabitq_index(x, 32, n_iter=4, device=cuda)
            eng = engine.SearchEngine.build(ix, k=100, n_probe=8, fused=True,
                                            device=cuda, tuned=None)
        probed, valid, _ = search._routing(ix.ivf, eng.layout, qs,
                                           eng.n_probe)

        def call():
            return eng.search(qs)
    _launches(call)                               # builds the kernels
    _, off = _launches(call)
    (_, got), on = _launches(lambda: _counted(call))
    assert on == off and (kind != "chunked" or
                          off == {"fused_scan_chunked_batch": 1})
    assert got["scan.pairs_probed"] == int(valid.sum())
    assert got["scan.pairs_passed"] == (
        int(valid.sum()) if kind == "pq" else valid.numel())
