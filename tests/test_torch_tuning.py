"""The port's constrained tuner (``repro_torch.tuning``) against the JAX
package's on the CPU.

First the reference's ``tests/test_tuning.py`` cases on the port: the
solver on synthetic knob surfaces with known optima, the knob invariants,
the point store's round trips and nearest-cell rules, the degrade ladder
built from a frontier, and the engine's ``tuned=`` wiring on a tiny index.
Then the port against the reference: on the same samples ``solve``,
``coordinate_descent``, ``pareto_frontier`` and ``canonical_json`` give
the same bytes; ``corpus_fingerprint`` gives the same digest (for a numpy
corpus and its tensor); the repo's ``tuned_points.json`` resolves to the
same point and provenance for a grid of (method, k, target); on the
reference's own index (carried across by ``convert``) ``measure(timed=
False)`` gives the reference's recall, scanned lanes and re-rank counters
for every configuration of the cell's grid and ``tune_cell(timed=False)``
chooses the reference's knobs; the serving state, the mutable index and
the CLI consume the store as the reference's do.
"""
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic  # noqa: E402
from repro.index import engine as jengine  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro.serving.state import ServingState as JServingState  # noqa: E402
from repro.tuning import autotune as jautotune  # noqa: E402
from repro.tuning import knobs as jkn  # noqa: E402
from repro.tuning import measure as jmeasure  # noqa: E402
from repro.tuning import points as jtp  # noqa: E402
from repro.tuning import solver as jsolver  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.index import engine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import admission as adm  # noqa: E402
from repro_torch.serving import batcher as bt  # noqa: E402
from repro_torch.serving import queue as rq  # noqa: E402
from repro_torch.serving.state import ServingState  # noqa: E402
from repro_torch.tuning import autotune, measure, solver  # noqa: E402
from repro_torch.tuning import knobs as kn  # noqa: E402
from repro_torch.tuning import points as tp  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CELL = kn.Cell(method="ivfpq", k=100, n=10_000, d=32, n_clusters=64)


def sample(n_probe, recall, cost, n_cand=None, pred_count=None):
    cfg = kn.clamp(kn.KnobConfig(n_probe=n_probe, n_cand=n_cand,
                                 pred_count=pred_count), CELL)
    return measure.Sample(knobs=cfg, recall=recall, scanned=cost,
                          reranked=0.0, second_pass=0.0, cost_units=cost)


def synthetic_surface():
    """A knob surface with a KNOWN optimum: recall and cost both rise with
    n_probe; the cheapest configuration meeting recall >= 0.95 is
    n_probe=32 (recall 0.96); n_probe=16 is cheaper but infeasible."""
    return [sample(4, 0.40, 100.0), sample(8, 0.70, 200.0),
            sample(16, 0.90, 400.0), sample(32, 0.96, 800.0),
            sample(64, 0.99, 1600.0)]


# ------------------------------- solver -------------------------------------

def test_solve_known_optimum():
    best, lam, feasible = solver.solve(synthetic_surface(), target=0.95)
    assert feasible and best.knobs.n_probe == 32
    assert solver.score(best, lam, 0.95) >= solver.score(
        sample(16, 0.90, 400.0), lam, 0.95)


def test_solve_constraint_binds_not_overshoots():
    best, _, feasible = solver.solve(synthetic_surface(), target=0.85)
    assert feasible and best.knobs.n_probe == 16


def test_solve_infeasible_surfaces_flagged():
    surface = [sample(4, 0.40, 100.0), sample(8, 0.70, 200.0)]
    best, _, feasible = solver.solve(surface, target=0.95)
    assert not feasible
    assert best.knobs.n_probe == 8      # highest-recall fallback


def test_coordinate_descent_deterministic_and_finds_optimum():
    grid = {"n_probe": (4, 8, 16, 32, 64)}
    by_np = {s.knobs.n_probe: s for s in synthetic_surface()}
    calls = []

    def evaluate(cfg):
        calls.append(cfg.key())
        ref = by_np[cfg.n_probe]
        return measure.Sample(knobs=cfg, recall=ref.recall,
                              scanned=ref.scanned, reranked=0.0,
                              second_pass=0.0, cost_units=ref.cost_units)
    memos = []
    samples = None
    for _ in range(2):
        memo = solver.coordinate_descent(evaluate, CELL, grid,
                                         target=0.95, seed=7)
        memos.append(sorted(memo))
        samples = list(memo.values())
    assert memos[0] == memos[1]          # same seed -> same sweep
    assert len(set(calls)) == len(calls) // 2   # memoized within each run
    best, _, feasible = solver.solve(samples, target=0.95)
    assert feasible and best.knobs.n_probe == 32


def test_pareto_frontier_monotone():
    front = solver.pareto_frontier(synthetic_surface())
    recalls = [s.recall for s in front]
    costs = [s.cost_units for s in front]
    assert recalls == sorted(recalls, reverse=True)
    assert costs == sorted(costs, reverse=True)


def _sample_json(s):
    return json.dumps([s.knobs.key(), s.recall, s.scanned, s.reranked,
                       s.second_pass, s.cost_units])


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_solver_equals_reference_byte_for_byte(seed):
    """The same samples (a random surface over the reference's grid) and
    the same seed: the same sweep memo, the same choice and multiplier
    per target, the same frontier, the same canonical JSON of the points."""
    rng = np.random.default_rng(seed)
    cell = kn.Cell(method="ivfpq", k=200, n=20_000, d=32, n_clusters=64)
    jcell = jkn.Cell(method="ivfpq", k=200, n=20_000, d=32, n_clusters=64)
    table = {}

    def numbers(key):
        if key not in table:
            table[key] = (round(float(rng.random()), 6),
                          round(float(rng.uniform(1e3, 1e5)), 1))
        return table[key]

    def evaluator(mod_ms):
        def evaluate(cfg):
            recall, cost = numbers(cfg.key())
            return mod_ms.Sample(knobs=cfg, recall=recall, scanned=cost,
                                 reranked=0.0, second_pass=0.0,
                                 cost_units=cost)
        return evaluate

    assert kn.grid(cell) == jkn.grid(jcell)
    memo = solver.coordinate_descent(evaluator(measure), cell, kn.grid(cell),
                                     target=0.95, seed=seed)
    jmemo = jsolver.coordinate_descent(evaluator(jmeasure), jcell,
                                       jkn.grid(jcell), target=0.95,
                                       seed=seed)
    assert list(memo) == list(jmemo)
    samples = [memo[k] for k in sorted(memo)]
    jsamples = [jmemo[k] for k in sorted(jmemo)]
    assert [_sample_json(s) for s in samples] == \
        [_sample_json(s) for s in jsamples]
    points, jpoints = [], []
    for target in (0.95, 0.9, 0.8, 0.5):
        a, lam, feas = solver.solve(samples, target)
        b, jlam, jfeas = jsolver.solve(jsamples, target)
        assert (_sample_json(a), lam, feas) == (_sample_json(b), jlam, jfeas)
        points.append(tp.OperatingPoint(
            method="ivfpq", k=200, recall_target=target, knobs=a.knobs,
            recall=a.recall, cost_units=a.cost_units, feasible=feas,
            corpus={"n": 20_000}, commit="c", seed=seed))
        jpoints.append(jtp.OperatingPoint(
            method="ivfpq", k=200, recall_target=target, knobs=b.knobs,
            recall=b.recall, cost_units=b.cost_units, feasible=jfeas,
            corpus={"n": 20_000}, commit="c", seed=seed))
    assert [_sample_json(s) for s in solver.pareto_frontier(samples)] == \
        [_sample_json(s) for s in jsolver.pareto_frontier(jsamples)]
    assert tp.canonical_json(points) == jtp.canonical_json(jpoints)


# ----------------------------- knob invariants ------------------------------

def test_clamp_enforces_pool_subset_and_ranges():
    cfg = kn.clamp(kn.KnobConfig(n_probe=10_000, n_cand=50,
                                 pred_count=7), CELL)
    assert cfg.n_probe == CELL.n_clusters
    assert cfg.n_cand == CELL.k                    # raised to k
    assert CELL.k <= cfg.pred_count <= cfg.n_cand  # pool-subset contract
    assert kn.clamp(cfg, CELL) == cfg              # idempotent


def test_clamp_drops_ncand_off_pq():
    cell = kn.Cell(method="ivf", k=100, n=10_000, d=32, n_clusters=64)
    assert kn.clamp(kn.KnobConfig(n_probe=8, n_cand=500), cell).n_cand is None


def test_shard_budget_stream_clamp():
    b = kn.shard_budget("ivfrabitq", 5000, None, 8)
    assert b >= 1 and b % 128 == 0
    assert kn.shard_budget("ivfrabitq", 5000, None, 8, stream_len=37) == 37
    with pytest.raises(KeyError):
        kn.shard_budget("nope", 100, None, 8)
    for method in kn.METHODS:
        for n_shards in (1, 2, 8):
            assert kn.shard_budget(method, 5000, 40_000, n_shards) == \
                jkn.shard_budget(method, 5000, 40_000, n_shards)


# ------------------------------- point store --------------------------------

def point(method="ivfpq", k=100, target=0.95, n_probe=16, recall=0.97,
          cost=100.0, feasible=True, fp="aaa", mod=tp, kmod=kn):
    return mod.OperatingPoint(
        method=method, k=k, recall_target=target,
        knobs=kmod.KnobConfig(n_probe=n_probe), recall=recall,
        cost_units=cost, feasible=feasible,
        corpus={"kind": "clustered", "fingerprint": fp}, commit="test",
        seed=0)


def test_point_json_roundtrip_and_canonical(tmp_path):
    pts = [point(k=100), point(k=100, target=0.8, n_probe=8, cost=50.0),
           point(method="ivf", k=200)]
    assert tp.OperatingPoint.from_json(
        json.loads(json.dumps(pts[0].to_json()))) == pts[0]
    assert tp.canonical_json(pts) == tp.canonical_json(pts[::-1])
    store = tp.PointStore(pts)
    path = store.save(str(tmp_path / "points.json"))
    assert tp.canonical_json(tp.PointStore.load(path).points) == \
        tp.canonical_json(store.points)
    assert tp.PointStore.load(str(tmp_path / "missing.json")).points == []
    # the reference reads the port's file and writes the same bytes
    jstore = jtp.PointStore.load(path)
    assert jtp.canonical_json(jstore.points) == tp.canonical_json(pts)
    jstore.save(str(tmp_path / "again.json"))
    assert (tmp_path / "again.json").read_bytes() == \
        (tmp_path / "points.json").read_bytes()


def test_default_store_is_the_ports_own(monkeypatch, tmp_path):
    """The port never names the JAX package's ``tuned_points.json`` by
    default: its own file, or its own environment variable."""
    monkeypatch.delenv(tp.ENV_PATH, raising=False)
    monkeypatch.setenv("REPRO_TUNED_POINTS", str(tmp_path / "jax.json"))
    assert tp.PointStore.default_path() == str(ROOT / "tuned_points_torch.json")
    monkeypatch.setenv(tp.ENV_PATH, str(tmp_path / "mine.json"))
    assert tp.PointStore.default_path() == str(tmp_path / "mine.json")
    tp.PointStore([point()]).save()
    assert (tmp_path / "mine.json").exists()
    assert not (tmp_path / "jax.json").exists()


def test_store_add_replaces_cell():
    store = tp.PointStore([point(n_probe=16)])
    store.add(point(n_probe=32))
    assert len(store) == 1 and store.points[0].knobs.n_probe == 32


def test_resolve_nearest_cell_rules():
    store = tp.PointStore([
        point(k=100), point(k=100, target=0.8, n_probe=8, cost=50.0),
        point(k=1000, n_probe=32), point(method="ivf", k=100, n_probe=24)])
    p, prov = store.resolve("ivfpq", 100, corpus_fp="aaa")
    assert (p.k, p.recall_target, prov) == (100, 0.95, "tuned")
    p, _ = store.resolve("ivfpq", 500)
    assert p.k == 1000
    p, _ = store.resolve("ivfpq", 5000)
    assert p.k == 1000
    p, _ = store.resolve("ivfpq", 100, target=0.9)
    assert p.recall_target == 0.8
    p, _ = store.resolve("ivf", 100)
    assert p.method == "ivf" and p.knobs.n_probe == 24
    assert store.resolve("ivfrabitq", 100) == (None, tp.HAND_TUNED)
    _, prov = store.resolve("ivfpq", 100, corpus_fp="zzz")
    assert prov == "tuned-nearest"


def test_resolve_under_corpus_drift_flags_and_warns():
    store = tp.PointStore([point(fp="aaa")])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        p, prov = store.resolve("ivfpq", 100, corpus_fp="aaa", drift=0.05)
    assert p is not None and prov == "tuned"
    with pytest.warns(UserWarning, match="drift"):
        p, prov = store.resolve("ivfpq", 100, corpus_fp="aaa", drift=0.2)
    assert p is not None and prov == "tuned-drifted(20%)"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, prov = store.resolve("ivfpq", 100, corpus_fp="aaa")
    assert prov == "tuned"


def test_resolve_prefers_feasible():
    store = tp.PointStore([point(n_probe=4, cost=10.0, recall=0.5,
                                 feasible=False),
                           point(n_probe=32, cost=800.0)])
    p, _ = store.resolve("ivfpq", 100)
    assert p.feasible and p.knobs.n_probe == 32


def test_repo_store_resolves_as_reference():
    """The JAX package's ``tuned_points.json``, read (never written) by
    both packages: the same point and provenance for every cell of a grid,
    and the same frontiers."""
    path = str(ROOT / "tuned_points.json")
    before = Path(path).read_bytes()
    mine, ref = tp.PointStore.load(path), jtp.PointStore.load(path)
    assert len(mine) == len(ref) > 0
    assert tp.canonical_json(mine.points) == jtp.canonical_json(ref.points)
    fps = [None, "30c1a707a202", "000000000000"]
    for method in ("ivf", "ivfpq", "ivfrabitq"):
        for k in (10, 1000, 5000, 9000):
            for fp in fps:
                assert [p.name for p in mine.frontier(method, k, fp)] == \
                    [p.name for p in ref.frontier(method, k, fp)]
                for target in (0.5, 0.8, 0.9, 0.95, 0.99):
                    a, pa = mine.resolve(method, k, target, fp)
                    b, pb = ref.resolve(method, k, target, fp)
                    assert pa == pb
                    assert (a is None) == (b is None)
                    if a is not None:
                        assert json.dumps(a.to_json(), sort_keys=True) == \
                            json.dumps(b.to_json(), sort_keys=True)
    assert Path(path).read_bytes() == before


def test_corpus_fingerprint_equals_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((500, 24)).astype(np.float32)
    want = jtp.corpus_fingerprint(jnp.asarray(x))
    assert tp.corpus_fingerprint(x) == want == jtp.corpus_fingerprint(x)
    assert tp.corpus_fingerprint(torch.from_numpy(x)) == want
    assert tp.corpus_fingerprint(torch.from_numpy(x).T.contiguous().T) == \
        want
    assert tp.corpus_fingerprint(x[:-1]) != want


# ------------------------- degrade ladder / frontier ------------------------

def frontier_points():
    return [point(target=0.95, n_probe=32, recall=0.96, cost=800.0),
            point(target=0.9, n_probe=16, recall=0.90, cost=400.0),
            point(target=0.8, n_probe=8, recall=0.82, cost=200.0)]


def test_ladder_from_frontier_walks_monotonically():
    ladder = adm.DegradeLadder.from_frontier(frontier_points())
    assert len(ladder.rungs) == 2
    caps = [ladder.caps(lf) for lf in (0.5, 1.0, 1.5, 2.0, 5.0)]
    np_caps = [c[1] for c in caps if c[1] is not None]
    targets = [c[2] for c in caps if c[2] is not None]
    assert np_caps == sorted(np_caps, reverse=True)
    assert targets == sorted(targets, reverse=True)
    assert ladder.caps(0.5) == (None, None, None)
    assert ladder.caps(9.9) == (None, 8, 0.8)


def test_ladder_rejects_increasing_recall_targets():
    with pytest.raises(ValueError):
        adm.DegradeLadder(((1.0, None, 16, 0.8), (2.0, None, 8, 0.9)))
    ladder = adm.DegradeLadder(((1.0, 500, 16),))
    assert ladder.caps(1.0) == (500, 16, None)


def test_ladder_apply_flags_degradation():
    ladder = adm.DegradeLadder.from_frontier(frontier_points())
    r = rq.Request(rid=0, q=np.zeros(4, np.float32), k=50, n_probe=64,
                   arrival=0.0, deadline=1.0, recall_target=0.95)
    out = ladder.apply(r, load_factor=5.0)
    assert out.n_probe == 8 and out.recall_target == 0.8
    assert out.recall_requested == 0.95 and out.degraded
    again = ladder.apply(out, load_factor=5.0)
    assert again.recall_requested == 0.95


def test_request_recall_target_validation():
    def mk(**kw):
        return rq.Request(rid=0, q=np.zeros(4, np.float32), k=10,
                          n_probe=4, arrival=0.0, deadline=1.0, **kw)
    for bad in (0.0, -0.1, 1.5, float("nan"), float("inf")):
        with pytest.raises(ValueError):
            mk(recall_target=bad)
        with pytest.raises(ValueError):
            mk(recall_requested=bad)
    r = mk()
    r2 = r.recall_capped(0.9)
    assert r2.recall_target == 0.9 and not r2.degraded
    r3 = mk(recall_target=0.9).recall_capped(0.95)
    assert r3.recall_target == 0.9 and not r3.degraded


# --------------------------- engine tuned= wiring ---------------------------

@pytest.fixture(scope="module")
def tiny():
    """The reference test's tiny index (2000 x 16, 16 clusters), built by
    the reference and carried across; 8 held-out queries and the
    reference's exact ground truth at k=100."""
    rng = np.random.default_rng(0)
    x = synthetic.clustered(rng, 2000, 16, n_centers=16)
    qs = synthetic.queries_from(rng, x, 8)
    ji = jsearch.build_pq_index(jax.random.key(0), jnp.asarray(x), 16,
                                n_iter=3)
    ti, _ = convert.pq_index_from_numpy({
        "ivf_centroids": np.asarray(ji.ivf.centroids),
        "member_ids": np.asarray(ji.ivf.member_ids),
        "member_valid": np.asarray(ji.ivf.member_valid),
        "cluster_sizes": np.asarray(ji.ivf.cluster_sizes),
        "vectors": np.asarray(ji.vectors),
        "pq_centroids": np.asarray(ji.pq.centroids),
        "codes": np.asarray(ji.codes)}, device="cpu")
    gt = jmeasure.ground_truth_ids(x, qs, 100)
    return dict(x=x, qs=qs, ji=ji, ti=ti, gt=gt)


def _pq_point(mod, kmod, **kw):
    kw.setdefault("knobs", kmod.KnobConfig(n_probe=12, n_cand=400,
                                           pred_count=150))
    return mod.OperatingPoint(method="ivfpq", k=100, recall_target=0.95,
                              recall=0.97, cost_units=10.0, feasible=True,
                              **kw)


def test_engine_build_resolves_tuned_point(tiny):
    p = _pq_point(tp, kn)
    eng = engine.SearchEngine.build(tiny["ti"], k=100, tuned=p, device="cpu")
    assert (eng.n_probe, eng.n_cand, eng.pred_count) == (12, 400, 150)
    assert eng.tuned_from and "(tuned)" in eng.tuned_from
    je = jengine.SearchEngine.build(tiny["ji"], k=100,
                                    tuned=_pq_point(jtp, jkn))
    assert eng.tuned_from == je.tuned_from
    eng = engine.SearchEngine.build(tiny["ti"], k=100, n_probe=5, tuned=p,
                                    device="cpu")
    assert eng.n_probe == 5


@pytest.mark.parametrize("k", [100, 600, 1500])
def test_engine_build_reclamps_cross_bucket(tiny, k):
    """A point tuned at k=100 serving a larger k re-clamps its pools to
    [k, n] exactly as the reference's engine does."""
    eng = engine.SearchEngine.build(tiny["ti"], k=k, device="cpu",
                                    tuned=tp.PointStore([_pq_point(tp, kn)]))
    je = jengine.SearchEngine.build(
        tiny["ji"], k=k, tuned=jtp.PointStore([_pq_point(jtp, jkn)]))
    assert (eng.n_probe, eng.n_cand, eng.pred_count, eng.fused,
            eng.tuned_from) == (je.n_probe, je.n_cand, je.pred_count,
                                je.fused, je.tuned_from)
    assert eng.n_cand >= k and eng.pred_count >= k
    assert eng.pred_count <= eng.n_cand


def test_engine_build_clamps_oversized_tuned_knobs(tiny):
    big = dict(knobs=None, corpus={"n": 60_000, "d": 128,
                                   "fingerprint": "deadbeef0000"})
    pts = []
    for mod, kmod in ((tp, kn), (jtp, jkn)):
        big["knobs"] = kmod.KnobConfig(n_probe=244, n_cand=40_000,
                                       pred_count=20_000)
        pts.append(mod.OperatingPoint(
            method="ivfpq", k=5000, recall_target=0.95, recall=0.97,
            cost_units=10.0, feasible=True, **big))
    eng = engine.SearchEngine.build(tiny["ti"], k=100, device="cpu",
                                    tuned=tp.PointStore([pts[0]]))
    je = jengine.SearchEngine.build(tiny["ji"], k=100,
                                    tuned=jtp.PointStore([pts[1]]))
    assert eng.n_probe <= tiny["ti"].ivf.n_clusters
    assert eng.n_cand <= 2000 and eng.pred_count <= eng.n_cand
    assert (eng.n_probe, eng.n_cand, eng.pred_count) == \
        (je.n_probe, je.n_cand, je.pred_count)
    res = eng.search_batch(torch.zeros(2, 16))
    assert tuple(res.ids.shape) == (2, 100)


def test_engine_build_requires_n_probe_without_point(tiny):
    with pytest.raises(ValueError, match="n_probe is required"):
        engine.SearchEngine.build(tiny["ti"], k=100, device="cpu",
                                  tuned=tp.PointStore())


# ---------------------- measure and tune on the same index ------------------

def test_measure_equals_reference_on_its_index(tiny):
    """Every configuration of the cell's grid, static and predictive, on
    the reference's index: the port's recall, scanned lanes and re-rank
    counters equal the reference's (no boundary lane differs here)."""
    cell = autotune.make_cell(tiny["ti"], 100)
    jcell = jautotune.make_cell(tiny["ji"], 100)
    assert (cell.method, cell.k, cell.n, cell.d, cell.n_clusters) == \
        (jcell.method, jcell.k, jcell.n, jcell.d, jcell.n_clusters)
    grid = kn.grid(cell)
    assert grid == jkn.grid(jcell)
    cfgs = [kn.clamp(kn.KnobConfig(n_probe=n_probe, n_cand=n_cand,
                                   pred_count=pc), cell)
            for n_probe in grid["n_probe"][::2]
            for n_cand in grid["n_cand"][::2]
            for pc in grid["pred_count"]]
    for i, cfg in enumerate(cfgs):
        jcfg = jkn.KnobConfig(**cfg.__dict__)
        predictive = i % 2 == 0
        a = measure.measure(tiny["ti"], cell, cfg, tiny["qs"], tiny["gt"],
                            predictive=predictive, timed=False, device="cpu")
        b = jmeasure.measure(tiny["ji"], jcell, jcfg, tiny["qs"], tiny["gt"],
                             predictive=predictive, timed=False)
        assert (a.recall, a.scanned, a.reranked, a.second_pass,
                a.cost_units, a.wall_s) == \
            (b.recall, b.scanned, b.reranked, b.second_pass, b.cost_units,
             b.wall_s), cfg


def test_tune_cell_chooses_the_reference_knobs(tiny, monkeypatch):
    """One seeded sweep per package on the same index, queries and ground
    truth: the same configurations evaluated, the same points (knobs,
    recall, cost, feasibility) for every target, the same canonical JSON
    once the commit stamp is pinned."""
    monkeypatch.setattr(tp, "commit_fingerprint", lambda: "test")
    monkeypatch.setattr(jtp, "commit_fingerprint", lambda: "test")
    got = autotune.tune_cell(tiny["ti"], 100, tiny["qs"], tiny["gt"],
                             timed=False, device="cpu",
                             corpus={"kind": "clustered"})
    want = jautotune.tune_cell(tiny["ji"], 100, tiny["qs"], tiny["gt"],
                               timed=False, corpus={"kind": "clustered"})
    assert [s.knobs.key() for s in got["samples"]] == \
        [s.knobs.key() for s in want["samples"]]
    assert tp.canonical_json(got["points"]) == \
        jtp.canonical_json(want["points"])
    assert got["default"].knobs.key() == want["default"].knobs.key()
    assert [s.knobs.key() for s in got["frontier"]] == \
        [s.knobs.key() for s in want["frontier"]]
    # the port's own ground truth equals the reference's on this corpus
    assert np.array_equal(
        np.sort(measure.ground_truth_ids(tiny["x"], tiny["qs"], 100,
                                         device="cpu"), 1),
        np.sort(tiny["gt"], 1))


# ----------------------------- the consumers --------------------------------

def test_serving_state_operating_points_equal_reference(tiny):
    store = tp.PointStore([_pq_point(tp, kn)])
    jstore = jtp.PointStore([_pq_point(jtp, jkn)])
    state = ServingState(tiny["ti"], device="cpu", tuned=store)
    jstate = JServingState(tiny["ji"], tuned=jstore)
    for k in (64, 128, 256):
        bucket = bt.ShapeBucket(k=k, batch=4, n_probe=8)
        eng, je = state.engine(bucket), jstate.engine(bucket)
        assert (eng.n_probe, eng.n_cand, eng.pred_count) == \
            (je.n_probe, je.n_cand, je.pred_count)
    assert state.operating_points() == jstate.operating_points()
    assert ServingState(tiny["ti"], device="cpu").engine(
        bt.ShapeBucket(k=64, batch=4, n_probe=8)) is not None
    assert set(ServingState(tiny["ti"], device="cpu",
                            tuned=tp.PointStore()).operating_points()
               .values()) <= {tp.HAND_TUNED}


def test_mutable_index_resolves_with_fingerprint_and_drift(tiny):
    """``MutableIndex(tuned=)``: an exact corpus match resolves ``tuned``,
    another corpus ``tuned-nearest``; the reference's index labels the
    same way on the same corpus."""
    from repro.ingest import mutable as jmutable
    from repro_torch.ingest import MutableIndex
    x = tiny["x"]
    fp = tp.corpus_fingerprint(x)
    for corpus_fp, prov in ((fp, "tuned"), ("000000000000",
                                            "tuned-nearest")):
        p = _pq_point(tp, kn, corpus={"fingerprint": corpus_fp})
        jp = _pq_point(jtp, jkn, corpus={"fingerprint": corpus_fp})
        mi = MutableIndex(x, "ivfpq", k=100, n_clusters=16,
                          tuned=tp.PointStore([p]), device="cpu")
        jmi = jmutable.MutableIndex(x, "ivfpq", k=100, n_clusters=16,
                                    tuned=jtp.PointStore([jp]))
        assert mi.engine.tuned_from == jmi.engine.tuned_from == \
            f"{p.name} ({prov})"
        assert (mi.engine.n_probe, mi.engine.n_cand) == \
            (jmi.engine.n_probe, jmi.engine.n_cand)


def test_cli_tuned_path_and_auto(tmp_path, capsys, monkeypatch):
    """``--tuned <path>`` serves the store's point and names it;
    ``--tuned auto`` with no store of the port's names the hand-tuned
    fallback, as the JAX CLI does without one."""
    args = ["--device", "cpu", "--n", "3000", "--d", "32", "--k", "100",
            "--n-clusters", "16", "--n-probe", "8", "--queries", "8",
            "--batch", "8"]
    monkeypatch.setenv(tp.ENV_PATH, str(tmp_path / "absent.json"))
    assert serve.main([*args, "--tuned", "auto"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["operating_point"] == tp.HAND_TUNED
    p = _pq_point(tp, kn, knobs=kn.KnobConfig(n_probe=8, n_cand=300,
                                              pred_count=120))
    path = tp.PointStore([p]).save(str(tmp_path / "store.json"))
    assert serve.main([*args, "--tuned", path]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["operating_point"] == f"{p.name} (tuned)"
    assert out["recall_mean"] > 0.5


@pytest.mark.cuda
def test_cuda_measure_equals_cpu(tiny):
    """On a card: ``measure(timed=False)`` of the same configurations gives
    the CPU's deterministic sample (the kernels agree to the bit).  The
    form is pinned: ``fused=None`` is the fused scan on the card and the
    unfused one on the CPU, whose re-rank counters differ by design."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    import dataclasses
    cell = autotune.make_cell(tiny["ti"], 100)
    cfgs = [dataclasses.replace(cfg, fused=fused)
            for cfg in (kn.default_config(cell),
                        kn.clamp(kn.KnobConfig(n_probe=4, n_cand=400,
                                               pred_count=150), cell))
            for fused in (True, False)]
    for cfg in cfgs:
        for predictive in (False, True):
            a = measure.measure(tiny["ti"], cell, cfg, tiny["qs"],
                                tiny["gt"], predictive=predictive,
                                timed=False, device="cpu")
            b = measure.measure(tiny["ti"], cell, cfg, tiny["qs"],
                                tiny["gt"], predictive=predictive,
                                timed=False, device="cuda")
            assert a == b
