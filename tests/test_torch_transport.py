"""The port's transport tier (``repro_torch.transport``) against the JAX
package's ``repro.transport`` on the CPU, without sockets.

Frames encode to the reference's bytes in both codecs and each package
decodes the other's; a seeded corruption fuzz gives both readers the same
outcome and never escapes as another exception.  The caches behave alike
over one operation sequence.  The Zipf traces and the ``isotropic`` and
``manifold`` corpora are bit-identical.  On the virtual-clock
``LoopbackSim`` with a numpy stub executor, over several seeds and wire
schedules with worker kills, a drain, backpressure, the result cache and
a malformed request, the port's ``MasterCore`` gives the reference's
``outcome_digest``, transcript text (``Transcript.save``), stats,
assignments and replies byte for byte, and either package replays the
other's transcript to the same digest; a nondeterministic executor is
caught.  Last, ``enginehost``: specs and datasets equal to the reference's,
the same index bits from one spec in two processes on the CPU, and
``make_exec_fn`` on the reference's index (passed by ``index_npz``) giving
the reference's id set per query.
"""
import hashlib
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import synthetic as jsyn  # noqa: E402
from repro.serving import faults as jflt  # noqa: E402
from repro.serving import queue as jrq  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro.serving import server as jsv  # noqa: E402
from repro.serving.batcher import k_ceilings as jk_ceilings  # noqa: E402
from repro.transport import cache as jcache  # noqa: E402
from repro.transport import core as jcore  # noqa: E402
from repro.transport import enginehost as jeh  # noqa: E402
from repro.transport import frames as jframes  # noqa: E402
from repro.transport import replay as jreplay  # noqa: E402
from repro.transport import sim as jsim  # noqa: E402
from repro.transport import wire as jwire  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.serving import faults as flt  # noqa: E402
from repro_torch.serving import queue as rq  # noqa: E402
from repro_torch.serving import router  # noqa: E402
from repro_torch.serving import server as sv  # noqa: E402
from repro_torch.serving.batcher import ShapeBucket, k_ceilings  # noqa: E402
from repro_torch.transport import cache, core, enginehost  # noqa: E402
from repro_torch.transport import frames, replay, sim, wire  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CODECS = ["json"] + (["msgpack"] if frames.msgpack is not None else [])

PORT = SimpleNamespace(frames=frames, cache=cache, core=core, sim=sim,
                       wire=wire, replay=replay, rq=rq, flt=flt,
                       router=router, sv=sv, k_ceilings=k_ceilings)
REF = SimpleNamespace(frames=jframes, cache=jcache, core=jcore, sim=jsim,
                      wire=jwire, replay=jreplay, rq=jrq, flt=jflt,
                      router=jrouter, sv=jsv, k_ceilings=jk_ceilings)


# --------------------------------------------------------------------------
# frames
# --------------------------------------------------------------------------

def _sample_frames(pkg):
    rng = np.random.default_rng(3)
    pk = pkg.frames.pack_array
    return [
        {"kind": "req", "rid": 7, "k": 100, "n_probe": 8,
         "q": pk(rng.standard_normal(6).astype(np.float32)),
         "deadline_s": 0.5, "note": "héllo"},
        {"kind": "resp", "rid": 3, "wid": 1, "checksum": 4_000_000_000,
         "dists": pk(np.linspace(0, 1, 5, dtype=np.float32)),
         "ids": pk(np.arange(5, dtype=np.int32)), "k": 5, "n_probe": 8},
        {"kind": "ready", "wid": 2, "svc": {"10,8": 0.0012, "100,8": 0.003}},
        {"kind": "hello", "role": "worker", "wid": 0},
        {"kind": "retry_after", "rid": 9, "delay_s": 0.05,
         "reason": "backpressure"},
        {"kind": "err", "rid": -1, "code": "bad_frame", "detail": "x" * 40},
        {"kind": "x", "nested": [1, [2, {"a": None, "b": True}], 3.5],
         "raw": b"\x00\xff" * 9},
    ]


@pytest.mark.parametrize("codec", CODECS)
def test_frames_encode_to_the_reference_bytes(codec):
    """Every sample frame encodes to the reference's bytes, and each
    package's reader decodes the other's stream to the same dicts."""
    ours = b"".join(frames.encode_frame(f, codec)
                    for f in _sample_frames(PORT))
    theirs = b"".join(jframes.encode_frame(f, codec)
                      for f in _sample_frames(REF))
    assert ours == theirs
    got_p = frames.FrameReader().feed(theirs)
    got_r = jframes.FrameReader().feed(ours)
    assert got_p == got_r and len(got_p) == len(_sample_frames(PORT))
    q = frames.unpack_array(got_p[0]["q"])
    np.testing.assert_array_equal(q, jframes.unpack_array(got_r[0]["q"]))
    assert frames.default_codec() == jframes.default_codec()


def test_frames_byte_at_a_time_and_constants():
    blob = b"".join(frames.encode_frame(f, "json")
                    for f in _sample_frames(PORT))
    reader = frames.FrameReader()
    got = []
    for i in range(len(blob)):          # never raises on partial input
        got.extend(reader.feed(blob[i:i + 1]))
    assert [g["kind"] for g in got] == [f["kind"]
                                        for f in _sample_frames(PORT)]
    assert reader.pending() == 0
    for name in ("MAX_FRAME", "CODEC_JSON", "CODEC_MSGPACK", "HELLO",
                 "READY", "REQ", "RESP", "ERR", "RETRY_AFTER", "HB", "BYE",
                 "_ALLOWED_DTYPES"):
        assert getattr(frames, name) == getattr(jframes, name), name


def _fuzz_outcome(pkg, blob: bytes):
    reader = pkg.frames.FrameReader(max_frame=1 << 20)
    try:
        out = reader.feed(blob)
    except pkg.frames.FrameError as e:
        assert reader.pending() == 0        # poisoned reader cleared
        return ("error", str(e).split(":")[0])
    for f in out:                           # decoded frames are well-formed
        assert isinstance(f, dict) and isinstance(f["kind"], str)
    return ("ok", repr(out), reader.pending())


@pytest.mark.parametrize("codec", CODECS)
def test_frame_fuzz_contained_like_the_reference(codec):
    """Seeded byte corruption of a real frame stream: each trial decodes
    cleanly or raises FrameError, never another exception, and both
    packages' readers reach the same outcome."""
    rng = np.random.default_rng(1234)
    base = b"".join(frames.encode_frame(
        {"kind": "req", "rid": i,
         "q": frames.pack_array(rng.standard_normal(4).astype(np.float32))},
        codec) for i in range(4))
    kinds = set()
    for _ in range(200):
        blob = bytearray(base)
        for _ in range(rng.integers(1, 6)):
            blob[int(rng.integers(0, len(blob)))] = int(rng.integers(0, 256))
        ours = _fuzz_outcome(PORT, bytes(blob))
        assert ours == _fuzz_outcome(REF, bytes(blob))
        kinds.add(ours[0])
    assert kinds == {"ok", "error"}


@pytest.mark.parametrize("bad", [
    None, 42, "x",
    {"dtype": "object", "shape": [1], "data": b"x"},
    {"dtype": "float32", "shape": [], "data": b""},
    {"dtype": "float32", "shape": [-1], "data": b""},
    {"dtype": "float32", "shape": ["a"], "data": b""},
    {"dtype": "float32", "shape": [2], "data": b"\x00" * 7},
    {"dtype": "float32", "shape": [2], "data": "notbytes"},
    {"dtype": "float32", "shape": [1 << 30], "data": b""},
])
def test_unpack_array_refuses_what_the_reference_refuses(bad):
    with pytest.raises(frames.FrameError) as ours:
        frames.unpack_array(bad)
    with pytest.raises(jframes.FrameError) as theirs:
        jframes.unpack_array(bad)
    assert str(ours.value) == str(theirs.value)


def test_frame_errors_match_the_reference():
    cases = [(2048).to_bytes(4, "big") + b"J{}",
             (3).to_bytes(4, "big") + b"Zxx", (0).to_bytes(4, "big")]
    for body in (json.dumps([1, 2]).encode(),
                 json.dumps({"nokind": 1}).encode()):
        cases.append((len(body) + 1).to_bytes(4, "big") + b"J" + body)
    for blob in cases:
        with pytest.raises(frames.FrameError) as ours:
            frames.FrameReader(max_frame=1024).feed(blob)
        with pytest.raises(jframes.FrameError) as theirs:
            jframes.FrameReader(max_frame=1024).feed(blob)
        assert str(ours.value) == str(theirs.value)
    for bad in ({"no": "kind"},
                {"kind": "x", "data": b"\x00" * (2 * frames.MAX_FRAME)}):
        with pytest.raises(frames.FrameError):
            frames.encode_frame(bad, "json")


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def _cache_log(pkg, seed: int):
    """A seeded mix of puts and gets on all three caches; returns what
    every get answered and the final stats."""
    rng = np.random.default_rng(seed)
    lru = pkg.cache.LruCache(4)
    rc = pkg.cache.ResultCache(5)
    memo = pkg.cache.RouteMemo(3)
    qs = [rng.standard_normal(4).astype(np.float32) for _ in range(8)]
    log = []
    for step in range(300):
        i = int(rng.integers(0, 8))
        k, n_probe = int(rng.choice([10, 100])), int(rng.choice([4, 8]))
        op = int(rng.integers(0, 6))
        if op == 0:
            lru.put(("key", i), step)
        elif op == 1:
            log.append(("lru", lru.get(("key", i)), ("key", i) in lru))
        elif op == 2:
            rc.put(qs[i], k, n_probe, np.full(k, i, np.float32),
                   np.arange(k, dtype=np.int64) + step)
        elif op == 3:
            hit = rc.get(qs[i], k, n_probe)
            log.append(("rc", None if hit is None else
                        (hit[0].tobytes(), hit[1].tobytes())))
        elif op == 4:
            memo.put(qs[i], step % 3)
        else:
            log.append(("memo", memo.get(qs[i])))
    q64 = qs[0].astype(np.float64)
    log.append(("dtype-key", rc.get(q64, 10, 4)))
    return log, lru.stats(), rc.stats(), memo.stats(), len(lru)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_caches_behave_like_the_reference(seed):
    assert _cache_log(PORT, seed) == _cache_log(REF, seed)
    assert cache.result_key(np.arange(3, dtype=np.float32), 5, 2) == \
        jcache.result_key(np.arange(3, dtype=np.float32), 5, 2)
    with pytest.raises(ValueError):
        cache.LruCache(0)


# --------------------------------------------------------------------------
# traces and corpora
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pool,alpha", [(1, 1.1), (32, 1.1), (500, 0.7)])
def test_zipf_query_ids_bit_identical(pool, alpha):
    a = rq.zipf_query_ids(np.random.default_rng(5), 1000, pool, alpha)
    b = jrq.zipf_query_ids(np.random.default_rng(5), 1000, pool, alpha)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    for bad in ((0, 1.1), (4, 0.0)):
        with pytest.raises(ValueError):
            rq.zipf_query_ids(np.random.default_rng(0), 4, *bad)


@pytest.mark.parametrize("ks", [100, (10, 100), (10, 100, 1000)])
def test_make_zipf_trace_bit_identical(ks):
    pool = np.random.default_rng(1).standard_normal((24, 8)) \
        .astype(np.float32)
    kw = dict(rate=150.0, deadline=0.4, n_probe=6, alpha=1.2, t0=1.5)
    a = rq.make_zipf_trace(np.random.default_rng(9), pool, 300, ks, **kw)
    b = jrq.make_zipf_trace(np.random.default_rng(9), pool, 300, ks, **kw)
    assert len(a) == len(b) == 300
    for x, y in zip(a, b):
        assert (x.rid, x.k, x.n_probe, x.arrival, x.deadline) == \
            (y.rid, y.k, y.n_probe, y.arrival, y.deadline)
        assert x.q.dtype == y.q.dtype and x.q.tobytes() == y.q.tobytes()


@pytest.mark.parametrize("kind,kw", [
    ("isotropic", {}), ("manifold", {}),
    ("manifold", {"intrinsic_dim": 4, "n_centers": 16, "zipf_a": 2.0}),
    ("clustered", {})])
def test_corpora_bit_identical(kind, kw):
    a = getattr(synthetic, kind)(np.random.default_rng(2), 3000, 24, **kw)
    b = getattr(jsyn, kind)(np.random.default_rng(2), 3000, 24, **kw)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_manifold_refuses_a_wide_intrinsic_dim():
    with pytest.raises(ValueError):
        synthetic.manifold(np.random.default_rng(0), 10, 4, intrinsic_dim=8)


# --------------------------------------------------------------------------
# MasterCore on the loopback sim, port against reference
# --------------------------------------------------------------------------

KS = (10, 100)


def _exec_fn(q, k, n_probe):
    h = int(np.abs(np.asarray(q, dtype=np.float64)).sum() * 1e3) % 997
    ids = np.arange(k, dtype=np.int64) + h
    dists = np.float32(h % 7) + np.arange(k, dtype=np.float32) * 0.01
    return dists, ids


def _service_fn(bucket):
    return 0.001 + bucket.k * 1e-6


WIRE_A = dict(seed=11, drop=0.05, dup=0.03, slow=0.1, truncate=0.02,
              disconnect=0.02)
WIRE_B = dict(seed=5, drop=0.04, dup=0.02, slow=0.12, truncate=0.01,
              disconnect=0.01)
WIRE_C = dict(seed=7, drop=0.1, dup=0.05, slow=0.2, truncate=0.03,
              disconnect=0.03, slow_base=0.001, slow_jitter=0.01)

SIM_CASES = {
    "clean": dict(),
    "faults-kill": dict(wire=WIRE_A, kill_at={1: 0.05}),
    "faults-kill-b": dict(wire=WIRE_B, kill_at={2: 0.08}, trace_seed=3),
    "backpressure": dict(cfg=dict(n_workers=1, lane_depth=1, max_pending=2),
                         n_req=60, rate=5000.0),
    "drain": dict(n_req=40, rate=200.0, drain=True),
    "cache-faults": dict(cfg=dict(n_workers=3, cache_size=64), wire=WIRE_C,
                         n_req=150, trace_seed=4),
    "malformed": dict(n_req=20, malformed=True),
    "heavy-two-kills": dict(cfg=dict(n_workers=2, lane_depth=2,
                                     max_pending=8, cache_size=16),
                            wire=WIRE_C, kill_at={0: 0.03, 1: 0.2},
                            trace_seed=8, rate=600.0, deadline=0.2),
}


def _sim_run(pkg, *, cfg=None, wire=None, kill_at=None, trace_seed=0,
             n_req=120, rate=300.0, deadline=0.5, drain=False,
             malformed=False):
    rng = np.random.default_rng(trace_seed)
    centroids = rng.standard_normal((16, 8)).astype(np.float32)
    pool = rng.standard_normal((24, 8)).astype(np.float32)
    trace = pkg.rq.make_zipf_trace(rng, pool, n_req, KS, rate=rate,
                                   deadline=deadline, n_probe=4)
    cfg = pkg.core.MasterConfig(ceilings=pkg.k_ceilings(KS),
                                **(cfg or dict(n_workers=3)))
    mcore = pkg.core.MasterCore(cfg, centroids)
    s = pkg.sim.LoopbackSim(
        mcore, _exec_fn, _service_fn,
        wire=None if wire is None else pkg.flt.WireSchedule(**wire),
        kill_at=kill_at, record=True)
    if drain:
        s._push(trace[len(trace) // 2].arrival, "core", {"ev": "drain"})
    if malformed:
        s._push(trace[0].arrival, "core", {
            "ev": "req", "conn": 0, "crid": 777,
            "q": np.array([np.nan] * 8, dtype=np.float32), "k": 10,
            "n_probe": 4, "deadline_s": 1.0})
    outs = s.run(trace)
    return SimpleNamespace(core=mcore, sim=s, outs=outs, cfg=cfg,
                           centroids=centroids, trace=trace)


def _canon(obj):
    if isinstance(obj, np.ndarray):
        return ("nd", obj.dtype.name, obj.shape, obj.tobytes())
    if isinstance(obj, dict):
        return tuple(sorted((k, _canon(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_canon(v) for v in obj)
    return obj


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_core_on_loopback_sim_matches_reference(case, tmp_path):
    """The same trace, stub executor, service model, wire schedule and
    kills through both packages' ``LoopbackSim``: equal outcome digests,
    transcript files, stats, assignments, replies, cache stats and wire
    fault counts; every completion is the stub's direct answer."""
    p = _sim_run(PORT, **SIM_CASES[case])
    r = _sim_run(REF, **SIM_CASES[case])
    assert router.outcome_digest(p.outs) == jrouter.outcome_digest(r.outs)
    p.sim.transcript.save(str(tmp_path / "port.jsonl"))
    r.sim.transcript.save(str(tmp_path / "ref.jsonl"))
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    assert p.core.stats == r.core.stats
    assert p.core.assignments == r.core.assignments
    assert _canon(p.sim.replies) == _canon(r.sim.replies)
    assert p.core.cache_stats() == r.core.cache_stats()
    assert p.sim.shim.fault_counts() == r.sim.shim.fault_counts()
    assert sv.summarize(p.outs) == jsv.summarize(r.outs)
    assert sv.summarize(p.outs)["conserved"]
    for o in p.outs:
        if o.completed:
            _, ids = _exec_fn(o.request.q, o.request.k, o.request.n_probe)
            np.testing.assert_array_equal(o.ids, ids)
    stats = p.core.stats
    if case == "backpressure":
        assert stats["rejected_backpressure"] > 0
    if case == "drain":
        assert stats["rejected_draining"] > 0
    if case == "malformed":
        assert stats["malformed"] == 1
    if "kill" in case:
        assert stats["respawns"] >= 1 and p.sim.shim.fault_counts()
    if "cache" in case:
        assert stats["cache_hits"] > 0


@pytest.mark.parametrize("case", ["faults-kill", "cache-faults",
                                  "heavy-two-kills"])
def test_replay_across_packages(case):
    """Each package's transcript text, loaded by either package, replays
    through either package's core to the live digest and stats."""
    p = _sim_run(PORT, **SIM_CASES[case])
    r = _sim_run(REF, **SIM_CASES[case])
    digest = router.outcome_digest(p.outs)
    for text in (p.sim.transcript.dumps(), r.sim.transcript.dumps()):
        res = replay.replay_transcript(wire.Transcript.loads(text), p.cfg,
                                       p.centroids, _exec_fn)
        assert res.digest == digest and res.checksum_mismatches == []
        assert res.core.stats == p.core.stats
        jres = jreplay.replay_transcript(jwire.Transcript.loads(text),
                                         r.cfg, r.centroids, _exec_fn)
        assert jres.digest == digest
        assert [(c, _canon(f)) for c, f in res.replies] == \
            [(c, _canon(f)) for c, f in jres.replies]


def test_replay_strict_catches_a_nondeterministic_executor():
    p = _sim_run(PORT, n_req=20)
    tr = wire.Transcript.loads(p.sim.transcript.dumps())

    def drifted(q, k, n_probe):         # a different engine build
        d, i = _exec_fn(q, k, n_probe)
        return d, i + 1
    with pytest.raises(replay.ReplayError):
        replay.replay_transcript(tr, p.cfg, p.centroids, drifted)
    res = replay.replay_transcript(tr, p.cfg, p.centroids, drifted,
                                   strict=False)
    assert res.checksum_mismatches
    assert res.digest != router.outcome_digest(p.outs)


def test_transcript_strips_payloads_and_round_trips():
    p = _sim_run(PORT, n_req=30, wire=WIRE_A)
    resps = [e for e in p.sim.transcript.entries if e.get("ev") == "resp"]
    assert resps
    for e in resps:
        assert "dists" not in e and "ids" not in e
        assert "checksum" in e and "n_ids" in e and "ck_ok" in e
    text = p.sim.transcript.dumps()
    assert wire.Transcript.loads(text).dumps() == text
    assert p.sim.transcript.fault_entries()
    with pytest.raises(ValueError):
        wire.Transcript.loads("\n \n")


def _core_script(pkg, max_retries: int):
    """The reference test's two hand-driven core scripts: a corrupt
    response retried, and a short (3-row) payload; returns every action
    list, canonicalised."""
    rng = np.random.default_rng(0)
    cfg = pkg.core.MasterConfig(
        n_workers=1, ceilings=pkg.k_ceilings(KS),
        retry=pkg.router.RetryPolicy(relative=True, max_retries=max_retries))
    mcore = pkg.core.MasterCore(
        cfg, rng.standard_normal((8, 8)).astype(np.float32))
    mcore.start(0.0)
    acts = [mcore.handle({"ev": "up", "t": 0.0, "wid": 0,
                          "svc": {"10,4": 0.002}})]
    q = np.arange(8, dtype=np.float32)
    acts.append(mcore.handle({"ev": "req", "t": 0.0, "conn": 1, "crid": 5,
                              "q": q, "k": 10, "n_probe": 4,
                              "deadline_s": 1.0}))
    rid = [a for a in acts[-1] if a[0] == "send"][0][2]["rid"]
    dists, ids = _exec_fn(q, 10, 4)
    d3, i3 = np.zeros(3, np.float32), np.arange(3, dtype=np.int64)
    acts.append(mcore.handle({"ev": "resp", "t": 0.01, "wid": 0,
                              "rid": rid, "dists": d3, "ids": i3,
                              "checksum": pkg.flt.payload_checksum(d3, i3)}))
    for a in acts[-1]:
        if a[0] == "timer" and a[2]["ev"] == "retry":
            acts.append(mcore.handle({**a[2], "t": a[1]}))
    good = pkg.flt.payload_checksum(dists, ids)
    acts.append(mcore.handle({"ev": "resp", "t": 0.05, "wid": 0, "rid": rid,
                              "dists": dists, "ids": ids, "checksum": 1}))
    acts.append(mcore.handle({"ev": "timeout", "t": 0.2, "rid": rid,
                              "aid": 1}))
    acts.append(mcore.handle({"ev": "resp", "t": 0.3, "wid": 0, "rid": rid,
                              "dists": dists, "ids": ids,
                              "checksum": good}))
    acts.append(mcore.handle({"ev": "lost", "t": 0.4, "wid": 0}))
    outs = [(o.request.rid, o.status, None if o.bucket is None else
             (o.bucket.k, o.bucket.batch, o.bucket.n_probe),
             _canon(o.ids), _canon(o.dists), o.t_done, o.k_effective,
             o.replica, o.retries, o.hedged)
            for o in mcore.outcome_list()]
    return _canon(acts), mcore.stats, outs


@pytest.mark.parametrize("max_retries", [0, 1, 3])
def test_core_by_hand_matches_reference(max_retries):
    ours = _core_script(PORT, max_retries)
    assert ours == _core_script(REF, max_retries)
    assert ours[1]["corrupt_detected"] >= 1
    with pytest.raises(ValueError):
        core.MasterConfig(n_workers=1, ceilings=k_ceilings(KS),
                          retry=router.RetryPolicy(relative=False))


# --------------------------------------------------------------------------
# enginehost
# --------------------------------------------------------------------------

SPEC_KW = dict(n=4096, d=16, seed=0, ks=(10, 100), n_probe=8)


@pytest.mark.parametrize("data", ["clustered", "isotropic", "manifold"])
def test_spec_and_dataset_match_reference(data):
    ours = enginehost.build_spec(data=data, device="cpu", **SPEC_KW)
    theirs = jeh.build_spec(data=data, **SPEC_KW)
    assert {k: v for k, v in ours.items()
            if k not in ("device", "index_npz")} == theirs
    assert ours["device"] == "cpu" and ours["index_npz"] is None
    assert json.loads(json.dumps(ours)) == ours
    assert enginehost.make_dataset(ours).tobytes() == \
        jeh.make_dataset(theirs).tobytes()
    with pytest.raises(ValueError):
        enginehost.build_spec(data="gaussian")


_BITS = """
import hashlib, json, sys
import torch
torch.set_num_threads(2)
from repro_torch.transport.enginehost import build_state_from_spec
state, ceil = build_state_from_spec(json.loads(sys.argv[1]))
ix = state.index
h = hashlib.sha256()
for t in (ix.ivf.centroids, ix.ivf.member_ids, ix.ivf.member_valid,
          ix.pq.centroids, ix.codes, ix.vectors):
    h.update(t.cpu().contiguous().numpy().tobytes())
print(json.dumps({"sha": h.hexdigest(), "ceil": list(ceil)}))
"""


def _bits_in_process(spec):
    state, ceil = enginehost.build_state_from_spec(spec)
    ix = state.index
    h = hashlib.sha256()
    for t in (ix.ivf.centroids, ix.ivf.member_ids, ix.ivf.member_valid,
              ix.pq.centroids, ix.codes, ix.vectors):
        h.update(t.cpu().contiguous().numpy().tobytes())
    return {"sha": h.hexdigest(), "ceil": list(ceil)}


def test_one_spec_builds_the_same_bits_in_two_processes():
    """Two fresh interpreters handed one CPU spec build bit-identical
    indexes, equal to this process's build."""
    spec = enginehost.build_spec(device="cpu", n_iter=4, **SPEC_KW)
    env = {"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2",
           "PATH": "/usr/bin:/bin"}
    procs = [subprocess.Popen([sys.executable, "-c", _BITS,
                               json.dumps(spec)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert outs[0] == outs[1] == _bits_in_process(spec)
    assert outs[0]["ceil"] == list(k_ceilings(SPEC_KW["ks"]))


@pytest.fixture(scope="module")
def ref_index(tmp_path_factory):
    """The reference's engine from the spec, and its index's arrays in an
    ``.npz`` with the keys ``convert.pq_index_from_numpy`` takes."""
    spec = jeh.build_spec(**SPEC_KW)
    jstate, jceil = jeh.build_state_from_spec(spec)
    ji = jstate.index
    path = tmp_path_factory.mktemp("ref_index") / "index.npz"
    np.savez(path, ivf_centroids=np.asarray(ji.ivf.centroids),
             member_ids=np.asarray(ji.ivf.member_ids),
             member_valid=np.asarray(ji.ivf.member_valid),
             cluster_sizes=np.asarray(ji.ivf.cluster_sizes),
             vectors=np.asarray(ji.vectors),
             pq_centroids=np.asarray(ji.pq.centroids),
             codes=np.asarray(ji.codes))
    return SimpleNamespace(spec=spec, jstate=jstate, jceil=jceil,
                           path=str(path),
                           jexec=jeh.make_exec_fn(jstate, jceil))


def test_exec_fn_on_the_reference_index(ref_index):
    """The port's singleton executor over the reference's index: per query
    and k, the reference's id set, sorted distances within 1e-4, and the
    reference's dtypes (the bytes ``payload_checksum`` hashes)."""
    spec = enginehost.build_spec(device="cpu", index_npz=ref_index.path,
                                 **SPEC_KW)
    state, ceil = enginehost.build_state_from_spec(spec)
    assert ceil == ref_index.jceil
    np.testing.assert_array_equal(state.centroids,
                                  np.asarray(ref_index.jstate.centroids))
    ours = enginehost.make_exec_fn(state, ceil)
    rng = np.random.default_rng(4)
    x = enginehost.make_dataset(spec)
    qs = synthetic.queries_from(rng, x, 6)
    for q in qs:
        for k in (10, 37, 100):
            d, i = ours(q, k, spec["n_probe"])
            jd, ji = ref_index.jexec(q, k, spec["n_probe"])
            assert (d.dtype, i.dtype) == (jd.dtype, ji.dtype)
            assert len(i) == k and set(i.tolist()) == set(ji.tolist())
            np.testing.assert_allclose(np.sort(d), np.sort(jd), rtol=1e-4,
                                       atol=1e-4)
            d2, i2 = ours(q, k, spec["n_probe"])
            assert flt.payload_checksum(d, i) == flt.payload_checksum(d2, i2)


def test_warmup_and_service_fn_like_the_reference(ref_index):
    spec = enginehost.build_spec(device="cpu", index_npz=ref_index.path,
                                 **SPEC_KW)
    state, ceil = enginehost.build_state_from_spec(spec)
    svc = enginehost.warmup_and_measure(
        enginehost.make_exec_fn(state, ceil), spec, ceil)
    jsvc = jeh.warmup_and_measure(ref_index.jexec, ref_index.spec,
                                  ref_index.jceil)
    assert list(svc) == list(jsvc) == ["10,8", "100,8"]
    assert all(v > 0 for v in svc.values())
    fixed = {"10,8": 0.001, "100,8": 0.004}
    ours = enginehost.service_fn_from_svc(fixed, default=0.5)
    theirs = jeh.service_fn_from_svc(fixed, default=0.5)
    for b in (ShapeBucket(k=10, batch=1, n_probe=8),
              ShapeBucket(k=100, batch=1, n_probe=8),
              ShapeBucket(k=100, batch=1, n_probe=16)):
        assert ours(b) == theirs(b)


@pytest.mark.cuda
def test_cuda_exec_fn_equals_cpu(ref_index):
    """On a card: the singleton executor over the reference's index gives
    the CPU's payload bytes (ids and distances agree to the bit between
    the two devices), so a CPU and a card worker checksum alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    fns = {}
    for dev in ("cpu", "cuda"):
        spec = enginehost.build_spec(device=dev, index_npz=ref_index.path,
                                     **SPEC_KW)
        fns[dev] = enginehost.make_exec_fn(
            *enginehost.build_state_from_spec(spec))
    qs = synthetic.queries_from(np.random.default_rng(6),
                                enginehost.make_dataset(ref_index.spec), 6)
    for q in qs:
        for k in (10, 100):
            dc, ic = fns["cpu"](q, k, SPEC_KW["n_probe"])
            dg, ig = fns["cuda"](q, k, SPEC_KW["n_probe"])
            assert flt.payload_checksum(dc, ic) == \
                flt.payload_checksum(dg, ig)
