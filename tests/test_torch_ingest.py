"""Streaming ingest in the port (``repro_torch.ingest``) against the JAX
package's ``repro.ingest`` on the CPU.

Config: the JAX package's ingest test (N=3000, D=24, k=100, segments of
256 rows, merge trigger 0.10, n_cand 2048, n_probe 27).  One seeded
schedule of inserts, deletes, a crashed merge, mid-merge deletes, the
resumed merge and more churn is run by both packages' ``MutableIndex``;
the port's builds each generation's index as the reference does and
carries it across with ``convert`` (``_build_index`` on a subclass), so
both search the same index.  After every step the id sets are equal, the
sorted distances agree within rtol=atol=1e-4, no deleted id surfaces, and
the churn accounting and merge trigger agree.  On the port's own builds a
merge crashed and resumed equals an uninterrupted one bit for bit.

The near-duplicates of the queries sit 0.05 off them per coordinate: at
0.001 the reference's segment scan (the norm identity
|x|^2 + |q|^2 - 2 x.q in fp32) loses the distance to cancellation (0.0028
for a true 0.0049), while the port sums (x - q)^2 directly; that case is
held against float64 in ``test_segment_scan_matches_reference``.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import rerank as jrr  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro import ingest as jingest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import ingest  # noqa: E402
from repro_torch.checkpoint.manager import CorruptCheckpointError  # noqa: E402
from repro_torch.core import rerank as rr  # noqa: E402
from repro_torch.ingest import drift, segment  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, NQ, K = 3000, 24, 4, 100
N_PROBE, N_CAND = 27, 2048
CONFIG = dict(segment_capacity=256, merge_trigger=0.10)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    x = synthetic.clustered(rng, N, D, n_centers=32)
    qs = synthetic.queries_from(rng, x, NQ)
    return x.astype(np.float32), qs.astype(np.float32)


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


class RefBuilt(ingest.MutableIndex):
    """The port's MutableIndex over the reference's build of each
    generation: ``jax.random.key(seed + generation)``, ``n_iter=6``, as
    ``repro.ingest.mutable.MutableIndex._build_index`` makes it."""

    def _build_index(self, x, generation):
        key = jax.random.key(self.seed + generation)
        jx = jnp.asarray(x)
        if self.kind == "ivf":
            ji = jivf.build(key, jx, self.n_clusters, n_iter=6)
            return convert.ivf_index_from_numpy(_np({
                "ivf_centroids": ji.centroids, "member_ids": ji.member_ids,
                "member_valid": ji.member_valid,
                "cluster_sizes": ji.cluster_sizes}), device=self.device)[0]
        common = lambda ji: {  # noqa: E731
            "ivf_centroids": ji.ivf.centroids,
            "member_ids": ji.ivf.member_ids,
            "member_valid": ji.ivf.member_valid,
            "cluster_sizes": ji.ivf.cluster_sizes, "vectors": ji.vectors}
        if self.kind == "ivfpq":
            ji = jsearch.build_pq_index(key, jx, self.n_clusters, n_iter=6)
            return convert.pq_index_from_numpy(_np(dict(
                common(ji), pq_centroids=ji.pq.centroids, codes=ji.codes)),
                device=self.device)[0]
        ji = jsearch.build_rabitq_index(key, jx, self.n_clusters, n_iter=6)
        return convert.rabitq_index_from_numpy(_np(dict(
            common(ji), rot=ji.rq.rot, codes=ji.rq.codes,
            norm_o=ji.rq.norm_o, f_o=ji.rq.f_o)), device=self.device)[0]


def _pair(x, kind):
    kw = dict(k=K, n_probe=N_PROBE, n_cand=N_CAND if kind == "ivfpq"
              else None)
    # the reference's RaBitQ fused form on its kernel branch, the one the
    # port runs on both devices (ROADMAP.md)
    jkw = dict(backend="pallas") if kind == "ivfrabitq" else {}
    jmi = jingest.MutableIndex(x, kind, config=jingest.IngestConfig(**CONFIG),
                               **kw, **jkw)
    tmi = RefBuilt(x, kind, config=ingest.IngestConfig(**CONFIG),
                   device="cpu", **kw)
    return jmi, tmi


def _same(jmi, tmi, qs, dead):
    jr, tr = jmi.search(qs), tmi.search(qs)
    jids, tids = np.asarray(jr.ids), tr.ids.numpy()
    for row in range(len(qs)):
        got = set(tids[row].tolist()) - {-1}
        assert got == set(jids[row].tolist()) - {-1}, row
        assert not (got & dead), row
    np.testing.assert_allclose(np.sort(tr.dists.numpy(), 1),
                               np.sort(np.asarray(jr.dists), 1),
                               rtol=1e-4, atol=1e-4)
    assert tmi.churn_fraction() == jmi.churn_fraction()
    assert tmi.needs_merge() == jmi.needs_merge()
    assert tmi.generation == jmi.generation
    tv, ti = tmi.live_corpus()
    jv, ji = jmi.live_corpus()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    return tr


@pytest.mark.parametrize("kind", ["ivfpq", "ivf", "ivfrabitq"])
def test_schedule_matches_reference(corpus, kind, tmp_path):
    """Inserts (two segments), deletes of base and segment rows and of an
    unknown id, near-duplicates of the queries, a crashed merge served on
    the sealed state, deletes landing mid-merge, the resumed merge, and
    churn after it: equal to the reference after every step."""
    x, qs = corpus
    rng = np.random.default_rng(11)
    jmi, tmi = _pair(x, kind)
    dead: set = set()
    _same(jmi, tmi, qs, dead)
    rows = (x[rng.choice(N, 300)] + 0.05 * rng.standard_normal(
        (300, D))).astype(np.float32)
    ins = tmi.insert(rows)
    np.testing.assert_array_equal(ins, jmi.insert(rows))
    assert len(tmi.segments) == 2
    _same(jmi, tmi, qs, dead)
    doomed = np.concatenate([rng.choice(N, 40, replace=False),
                             ins[rng.choice(300, 20, replace=False)],
                             [10 ** 6]])
    assert tmi.delete(doomed) == jmi.delete(doomed) == 60
    dead |= set(doomed[:-1].tolist())
    _same(jmi, tmi, qs, dead)
    near = tmi.insert(qs + 0.05)
    jmi.insert(qs + 0.05)
    r = _same(jmi, tmi, qs, dead)
    for row in range(NQ):
        assert near[row] in r.ids[row].tolist()
    for mi, d in ((jmi, tmp_path / "jax"), (tmi, tmp_path / "port")):
        mod = jingest if mi is jmi else ingest
        with pytest.raises(mod.MergeCrash):
            mod.MergeJob(mi, str(d)).run(crash_after_checkpoint=True)
    _same(jmi, tmi, qs, dead)           # serving on the sealed state
    mid = np.array([near[0], 60, ins[-1]])
    assert tmi.delete(mid) == jmi.delete(mid)
    dead |= set(mid.tolist())
    jingest.resume_merge(jmi, str(tmp_path / "jax"))
    ingest.resume_merge(tmi, str(tmp_path / "port"))
    assert tmi.generation == 1 and not tmi.segments
    r = _same(jmi, tmi, qs, dead)
    assert near[1] in r.ids[1].tolist()
    more = tmi.insert(rows[:30] + 1.0)
    jmi.insert(rows[:30] + 1.0)
    gone = np.array([more[0], int(tmi.row_ids[5]), near[2]])
    assert tmi.delete(gone) == jmi.delete(gone) == 3
    dead |= set(gone.tolist())
    _same(jmi, tmi, qs, dead)
    # single (d,) queries: the same rows as the batch
    one = tmi.search(qs[2])
    assert torch.equal(one.ids, tmi.search(qs).ids[2])


def test_checkpoints_of_both_packages_carry_the_same_checksum(corpus,
                                                              tmp_path):
    """The merge snapshot each package checkpoints is the same tree: the
    manifests carry the same leaf digests and checksum."""
    import json
    x, _ = corpus
    jmi, tmi = _pair(x, "ivfpq")
    for mi in (jmi, tmi):
        mi.insert(x[:10] + 0.5)
        mi.delete(np.arange(7))
    for mi, d in ((jmi, tmp_path / "jax"), (tmi, tmp_path / "port")):
        mod = jingest if mi is jmi else ingest
        with pytest.raises(mod.MergeCrash):
            mod.MergeJob(mi, str(d)).run(crash_after_checkpoint=True)
    man = [json.loads((tmp_path / p / "step_00000001" /
                       "manifest.json").read_text()) for p in ("jax", "port")]
    assert man[0]["checksum"] == man[1]["checksum"]
    assert {k: v["sha256"] for k, v in man[0]["leaves"].items()} == \
        {k: v["sha256"] for k, v in man[1]["leaves"].items()}


def _port(x, **kw):
    kw.setdefault("k", K)
    kw.setdefault("n_probe", N_PROBE)
    kw.setdefault("n_cand", N_CAND)
    return ingest.MutableIndex(x, config=ingest.IngestConfig(**CONFIG),
                               device="cpu", **kw)


def test_resumed_merge_equals_an_uninterrupted_one(corpus, tmp_path):
    """The port's own builds (torch k-means from ``seed + generation``):
    crashed and resumed, or run straight through, the merged index serves
    the same ids and distances bit for bit."""
    x, qs = corpus
    runs = []
    for crash in (True, False):
        mi = _port(x)
        ins = mi.insert(np.asarray(qs + 0.001, np.float32))
        mi.delete(np.concatenate([np.arange(0, 50), ins[:1]]))
        d = str(tmp_path / f"crash{crash}")
        if crash:
            with pytest.raises(ingest.MergeCrash):
                ingest.MergeJob(mi, d).run(crash_after_checkpoint=True)
            ingest.resume_merge(mi, d)
        else:
            ingest.MergeJob(mi, d).run()
        assert mi.generation == 1 and mi.churn_fraction() == 0.0
        runs.append(mi.search(qs))
    assert torch.equal(runs[0].ids, runs[1].ids)
    assert torch.equal(runs[0].dists, runs[1].dists)
    assert not (set(runs[0].ids.flatten().tolist()) & set(range(50)))


def test_failing_merge_unwinds(corpus, tmp_path, monkeypatch):
    x, qs = corpus
    mi = _port(x)
    mi.insert(qs + 0.001)
    before = mi.search(qs)
    monkeypatch.setattr(mi, "build_engine",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("boom")))
    with pytest.raises(RuntimeError, match="boom"):
        ingest.MergeJob(mi, str(tmp_path)).run()
    assert mi._sealed is None and len(mi.segments) == 1
    after = mi.search(qs)
    assert torch.equal(before.ids, after.ids)
    with pytest.raises(RuntimeError, match="in flight"):
        mi.begin_merge()
        mi.begin_merge()


def test_corrupt_checkpoint_refuses_resume(corpus, tmp_path):
    x, _ = corpus
    mi = _port(x)
    mi.insert(np.ones((4, D), np.float32))
    with pytest.raises(ingest.MergeCrash):
        ingest.MergeJob(mi, str(tmp_path)).run(crash_after_checkpoint=True)
    step_dir = next(p for p in tmp_path.iterdir() if p.name.startswith("step"))
    victim = next(p for p in step_dir.iterdir() if p.suffix != ".json")
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF
    victim.write_bytes(bytes(data))
    with pytest.raises(CorruptCheckpointError):
        ingest.resume_merge(mi, str(tmp_path))
    mi.abort_merge()
    eng = ingest.MergeJob(mi, str(tmp_path / "fresh")).run()
    assert eng is mi.engine and mi.generation == 1
    with pytest.raises(FileNotFoundError):
        ingest.resume_merge(mi, str(tmp_path / "empty"))


def test_segment_scan_matches_reference(corpus):
    """One segment's exact scan (#3's plain version, the live mask, the k'
    smallest with ties to the lower row) and the round-robin deal against
    the reference's."""
    x, qs = corpus
    seg, jseg = segment.DeltaSegment(300, D), jingest.DeltaSegment(300, D)
    for s in (seg, jseg):
        s.append(x[:200], np.arange(5000, 5200))
        s.append(x[:10], np.arange(6000, 6010))   # exact duplicates: ties
        s.delete(5003)
    for kk in (50, 500):
        jd, ji = jingest.segment.delta_scan(
            jnp.asarray(jseg.vectors), jnp.asarray(jseg.ids.astype(np.int32)),
            jnp.asarray(jseg.live), jnp.asarray(qs), k=kk)
        td, ti = segment.delta_scan(
            torch.from_numpy(seg.vectors), torch.from_numpy(seg.ids),
            torch.from_numpy(seg.live), torch.from_numpy(qs), k=kk)
        assert td.shape == (NQ, min(kk, 300))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-4,
                                   atol=2e-4)
        assert 5003 not in ti.numpy()
    # a near-duplicate: the direct fp32 sum keeps the float64 distance
    v = np.asarray(qs[0] + 0.001, np.float32)
    td, _ = segment.delta_scan(torch.from_numpy(v[None]),
                               torch.zeros(1, dtype=torch.int64),
                               torch.ones(1, dtype=torch.bool),
                               torch.from_numpy(qs[:1]), k=1)
    truth = np.sqrt(((v.astype(np.float64) - qs[0]) ** 2).sum())
    assert abs(float(td[0, 0]) - truth) < 1e-6
    for s in (2, 3):
        for a, b in zip(segment.shard_delta(seg, s),
                        jingest.segment.shard_delta(jseg, s)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        seg.append(np.zeros((200, D), np.float32), np.arange(200))
    with pytest.raises(ValueError):
        segment.DeltaSegment(0, D)


def test_sharded_mutable_index_on_one_rank(corpus, tmp_path):
    """``MutableIndex(mesh=)`` on a one-rank gloo mesh: the sharded base
    and the sharded segment scan (``delta_scan_sharded``) return the
    single-device index's ids."""
    import torch.distributed as tdist
    from repro_torch.core import distributed
    x, qs = corpus
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                             rank=0, world_size=1)
    try:
        mesh = distributed.make_mesh((1,))
        a, b = _port(x), ingest.MutableIndex(
            x, k=K, n_probe=N_PROBE, n_cand=N_CAND, mesh=mesh,
            config=ingest.IngestConfig(**CONFIG))
        for mi in (a, b):
            ins = mi.insert(x[:300] + 0.01)
            mi.delete(np.concatenate([np.arange(20), ins[:5]]))
        ra, rb_ = a.search(qs), b.search(qs)
        for row in range(NQ):
            assert set(ra.ids[row].tolist()) == set(rb_.ids[row].tolist())
        sv, si = segment.delta_scan_sharded(
            mesh, torch.from_numpy(qs), *segment.place_delta(mesh,
                                                             b.segments[0]),
            k=K)
        dv, di = segment.delta_scan(
            *(torch.from_numpy(t) for t in (b.segments[0].vectors,
                                            b.segments[0].ids,
                                            b.segments[0].live)),
            torch.from_numpy(qs), k=K)
        assert torch.equal(si, di) and torch.equal(sv, dv)
    finally:
        tdist.destroy_process_group()


JAX_SHARDED = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from repro.data import synthetic
    from repro.ingest import IngestConfig, MutableIndex

    rng = np.random.default_rng(5)
    x = synthetic.clustered(rng, 3000, 24, n_centers=32)
    qs = synthetic.queries_from(rng, x, 4)
    rows = (x[:300] + 0.05).astype(np.float32)
    mesh = jax.make_mesh((4,), ("model",))
    mi = MutableIndex(x, "ivfpq", k=100, n_probe=27, n_cand=2048, mesh=mesh,
                      config=IngestConfig(segment_capacity=256))
    ins = mi.insert(rows)
    doomed = np.concatenate([np.arange(0, 3000, 11), ins[::7]])
    assert mi.delete(doomed) == len(doomed)
    r = mi.search(qs)
    ix = mi.engine.index
    np.savez(sys.argv[1], x=x, qs=qs, rows=rows, doomed=doomed,
             ids=np.asarray(r.ids), dists=np.asarray(r.dists),
             ivf_centroids=ix.ivf.centroids, member_ids=ix.ivf.member_ids,
             member_valid=ix.ivf.member_valid,
             cluster_sizes=ix.ivf.cluster_sizes, vectors=ix.vectors,
             pq_centroids=ix.pq.centroids, codes=ix.codes)
    print("JAX_INGEST_OK")
    """
)

PORT_SHARDED = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    import torch.distributed as tdist
    import torch.multiprocessing as mp


    def rank_main(rank, src, dst, store):
        torch.set_num_threads(1)
        tdist.init_process_group("gloo", init_method=f"file://{store}",
                                 rank=rank, world_size=4)
        from repro_torch import convert, ingest
        from repro_torch.core import distributed as dist
        a = dict(np.load(src))

        class Loaded(ingest.MutableIndex):
            def _build_index(self, x, generation):
                return convert.pq_index_from_numpy(a, device="cpu")[0]

        mesh = dist.make_mesh((4,), ("model",))
        mi = Loaded(a["x"], "ivfpq", k=100, n_probe=27, n_cand=2048,
                    mesh=mesh, config=ingest.IngestConfig(
                        segment_capacity=256))
        mi.insert(a["rows"])
        assert mi.delete(a["doomed"]) == len(a["doomed"])
        r = mi.search(a["qs"])
        if rank == 0:
            np.savez(dst, ids=r.ids.numpy(), dists=r.dists.numpy())
        tdist.barrier()
        tdist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(rank_main, args=tuple(sys.argv[1:4]), nprocs=4, join=True)
        print("PORT_INGEST_OK")
    """
)


@pytest.mark.multidevice
def test_four_ranks_mutable_index_matches_reference(tmp_path):
    """The sharded deployment: the reference's MutableIndex on 4 forced
    host devices and the port's on 4 gloo ranks over the same index,
    after the same inserts (two segments, dealt over the ranks and
    scanned by ``delta_scan_sharded``) and deletes."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    ref_path, port_path = tmp_path / "jax.npz", tmp_path / "port.npz"
    script = tmp_path / "port_ranks.py"      # spawn pickles by module path
    script.write_text(PORT_SHARDED)
    for args, marker in (
            ([sys.executable, "-c", JAX_SHARDED, str(ref_path)],
             "JAX_INGEST_OK"),
            ([sys.executable, str(script), str(ref_path), str(port_path),
              str(tmp_path / "store")], "PORT_INGEST_OK")):
        out = subprocess.run(args, capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=600)
        assert marker in out.stdout, out.stderr[-3000:]
    want, got = dict(np.load(ref_path)), dict(np.load(port_path))
    dead = set(want["doomed"].tolist())
    for row in range(want["ids"].shape[0]):
        ids = set(got["ids"][row].tolist())
        assert ids == set(want["ids"][row].tolist()), row
        assert not (ids & dead), row
    np.testing.assert_allclose(np.sort(got["dists"], 1),
                               np.sort(want["dists"], 1), rtol=1e-4,
                               atol=1e-4)


def test_ids_monotone_churn_and_trigger(corpus):
    x, _ = corpus
    mi, jmi = _port(x), jingest.MutableIndex(
        x, k=K, n_probe=N_PROBE, n_cand=N_CAND,
        config=jingest.IngestConfig(**CONFIG))
    for m in (mi, jmi):
        assert not m.needs_merge()
        a = m.insert(np.ones((3, D), np.float32))
        m.delete(a)
        b = m.insert(np.ones((3, D), np.float32))
        assert a.tolist() == [N, N + 1, N + 2]
        assert b.tolist() == [N + 3, N + 4, N + 5]
        ins = m.insert(np.ones((N // 8, D), np.float32))
        m.delete(ins[: N // 100])
    assert mi.churn_fraction() == jmi.churn_fraction()
    assert mi.needs_merge() and jmi.needs_merge()
    # tuned points are ported: a store resolves at build with the corpus
    # fingerprint (an exact match here) and the churn share (0 at build)
    from repro_torch.tuning import knobs as tkn
    from repro_torch.tuning import points as tpts
    point = tpts.OperatingPoint(
        method="ivfpq", k=K, recall_target=0.95,
        knobs=tkn.KnobConfig(n_probe=N_PROBE), recall=1.0, cost_units=1.0,
        feasible=True, corpus={"fingerprint": tpts.corpus_fingerprint(x)})
    tmi = _port(x, n_probe=None, n_cand=None,
                tuned=tpts.PointStore([point]))
    assert tmi.engine.n_probe == N_PROBE
    assert tmi.engine.tuned_from == f"{point.name} (tuned)"


# ---------------------------- drift and swap --------------------------------

def _warm(mod, m, hist, **kw):
    st = mod.predictor_init(m, **kw)
    return mod.predictor_update(st, hist)


@pytest.mark.parametrize("case", ["near", "far", "cold"])
def test_drift_carry_matches_reference(case):
    """tv_distance and carry_state on the same EMA arrays as the
    reference's."""
    m = 7
    base = np.zeros((1, m + 1), np.float32)
    base[0, 2] = 100.0
    other = np.zeros((1, m + 1), np.float32)
    if case == "near":
        other[0, 2], other[0, 3] = 90.0, 10.0
    else:
        other[0, 6] = 100.0
    jold = jrr.predictor_init(m) if case == "cold" else \
        _warm(jrr, m, jnp.asarray(base))
    told = rr.predictor_init(m) if case == "cold" else \
        _warm(rr, m, torch.from_numpy(base))
    jk, jtv, jc = jingest.carry_state(jold, _warm(jrr, m, jnp.asarray(other)),
                                      0.25)
    tk, ttv, tc = drift.carry_state(told, _warm(rr, m,
                                                torch.from_numpy(other)),
                                    0.25)
    assert ttv == pytest.approx(jtv, abs=1e-12) and tc == jc
    assert (tk is told) == (jk is jold)
    np.testing.assert_array_equal(tk.ema.numpy(), np.asarray(jk.ema))
    assert float(tk.weight) == float(jk.weight)
    p, q = np.array([0.5, 0.5, 0.0]), np.array([0.0, 0.5, 0.5])
    assert drift.tv_distance(p, q) == jingest.tv_distance(p, q) == 0.5


def _serving(x):
    from repro_torch.index import search
    from repro_torch.serving.batcher import ShapeBucket
    from repro_torch.serving.state import ServingState
    idx = search.build_pq_index(x, 16, n_iter=3, device="cpu")
    st = ServingState(idx, use_bbc=True, tau_pred=True, m=64, pred_count=64,
                      device="cpu")
    return st, ShapeBucket(k=K, batch=NQ, n_probe=8), idx


def test_swap_is_copy_on_swap(corpus):
    """Forks taken before the swap keep the OLD generation's engine cache;
    the swapping state gets a NEW dict, and its engines the new
    generation and the tombstone mask."""
    from repro_torch.index import search
    x, qs = corpus
    st, bucket, _ = _serving(x)
    st.engine(bucket)
    fork = st.fork()
    old = fork._engines
    idx2 = search.build_pq_index(x, 16, n_iter=3, seed=1, device="cpu")
    live = np.ones(N, bool)
    live[:100] = False
    st.swap(idx2, live=live)
    assert st.generation == 1 and fork.generation == 0
    assert fork._engines is old and st._engines is not old
    assert fork.engine(bucket).generation == 0
    eng = st.engine(bucket)
    assert eng.generation == 1 and eng.live is not None
    ids = eng.search(torch.from_numpy(qs)).ids
    assert not (set(ids.flatten().tolist()) & set(range(100)))


def test_swap_reports_the_drift_decision(corpus):
    """A warm bucket's EMA is tested against one probe batch through the
    new engine: on the same index it carries (TV small), and the report
    says so; a cold state carries trivially."""
    from repro_torch.serving.batcher import Batch, Request
    x, qs = corpus
    st, bucket, idx = _serving(x)
    reqs = tuple(Request(rid=i, q=qs[i], k=K, n_probe=8, arrival=0.0,
                         deadline=1.0) for i in range(NQ))
    for _ in range(3):
        st.run(Batch(bucket=bucket, requests=reqs, queries=qs))
    warm = st.pred_state(bucket)
    assert float(warm.weight) > 0
    report = st.swap(idx, probe_qs=qs, drift_threshold=0.25)
    (key, entry), = report.items()
    assert key == (K, 8) and entry["carried"] and entry["tv"] < 0.25
    assert st.pred_state(bucket) is warm and st.drift_report == report
    report = st.swap(idx, probe_qs=qs, drift_threshold=-1.0)
    assert not report[(K, 8)]["carried"]
    assert float(st.pred_state(bucket).weight) == 0.0


@pytest.mark.cuda
def test_cuda_mutable_index_equals_cpu(corpus):
    """The schedule's inserts and deletes on the card: the fused scan on
    the tombstoned base and #3 over the segments give the CPU's ids and
    distances bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from repro_torch.index import search

    class CpuBuilt(ingest.MutableIndex):
        """Both devices serve the CPU's build of each generation."""

        def _build_index(self, x, generation):
            dev, self.device = self.device, torch.device("cpu")
            try:
                index = super()._build_index(x, generation)
            finally:
                self.device = dev
            return search.index_to(index, dev)

    x, qs = corpus
    out = []
    for dev in ("cpu", "cuda"):
        mi = CpuBuilt(x, k=K, n_probe=N_PROBE, n_cand=N_CAND,
                      config=ingest.IngestConfig(**CONFIG), device=dev,
                      fused=True)
        ins = mi.insert(x[:600] + 0.05)
        mi.delete(np.concatenate([np.arange(0, 3000, 7), ins[::5]]))
        out.append(mi.search(qs))
    assert torch.equal(out[1].ids.cpu(), out[0].ids)
    assert torch.equal(out[1].dists.cpu(), out[0].dists)


def test_plain_l2_is_the_delta_scans_kernel_contract():
    """The delta scan calls #3 at (B, capacity); its plain version is the
    fixed-order fp32 sum the card's kernel equals bit for bit."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal((256, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((3, D)).astype(np.float32))
    d, i = segment.delta_scan(v, torch.arange(256), torch.ones(256,
                                                               dtype=bool),
                              q, k=10)
    full = ref.l2_exact_batch(v, q)
    assert torch.equal(d, torch.sort(full, dim=1, stable=True).values[:, :10])
