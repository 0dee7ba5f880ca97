"""Live-socket tests of the port's transport tier on the CPU.

Real worker subprocesses over Unix sockets, every engine on
``device="cpu"`` at the reference test's spec (4096 x 16, k 10/100,
n_probe 8): round-trip parity with the in-process ``exec_fn`` and result
cache hits; typed errors on malformed frames with the workers surviving;
the same run recorded and replayed to an identical digest; worker death,
detection and respawn; a SIGTERM drain of ``python -m
repro_torch.launch.serve --mode net --serve-forever``.  Then across
frameworks, on the reference's index passed by ``index_npz``: a reference
``MasterServer`` answered by a port ``WorkerApp``, and a port master
answered by a reference ``WorkerApp``, with 0 corrupt responses and the
reference's id sets.  Every wait has a timeout and every child is killed
in a ``finally``.
"""
import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.transport import enginehost as jeh  # noqa: E402
from repro.transport import master as jmaster  # noqa: E402
from repro.transport import worker as jworker  # noqa: E402
from repro.transport.core import MasterConfig as JMasterConfig  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.batcher import k_ceilings  # noqa: E402
from repro_torch.serving.queue import make_zipf_trace  # noqa: E402
from repro_torch.serving.router import (RetryPolicy,  # noqa: E402
                                        outcome_digest)
from repro_torch.transport import frames  # noqa: E402
from repro_torch.transport.client import NetClient  # noqa: E402
from repro_torch.transport.core import MasterConfig  # noqa: E402
from repro_torch.transport.enginehost import (build_spec,  # noqa: E402
                                              build_state_from_spec,
                                              make_dataset, make_exec_fn)
from repro_torch.transport.master import MasterServer  # noqa: E402
from repro_torch.transport.replay import replay_transcript  # noqa: E402
from repro_torch.transport.wire import Transcript  # noqa: E402
from repro_torch.transport.worker import WorkerApp  # noqa: E402

torch.set_num_threads(2)

KS = (10, 100)
SPEC = build_spec(n=4096, d=16, seed=0, ks=KS, n_probe=8, device="cpu")
ROOT = Path(__file__).resolve().parents[1]
UP = 120.0          # seconds a worker may take to build and report READY


@contextlib.contextmanager
def _env(**kv):
    """Environment for the children spawned inside the block: two threads
    each, and the variables given (None removes one)."""
    kv.setdefault("OMP_NUM_THREADS", "2")
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rand_q(rng):
    return rng.standard_normal(SPEC["d"]).astype(np.float32)


def _trace(n, seed=0, rate=150.0, deadline=5.0):
    rng = np.random.default_rng(seed)
    pool = synthetic.queries_from(rng, make_dataset(SPEC), 8)
    return make_zipf_trace(rng, pool, n, KS, rate=rate, deadline=deadline,
                           n_probe=SPEC["n_probe"])


def _serve_in_thread(ms):
    stop = threading.Event()
    th = threading.Thread(target=lambda: ms.serve(until=stop.is_set),
                          daemon=True)
    th.start()
    return stop, th


def _stop(stop, th, ms):
    stop.set()
    th.join(timeout=10.0)
    assert not th.is_alive()
    ms.shutdown()


@pytest.fixture(scope="module")
def net():
    """One live port master + 2 port worker subprocesses + an in-process
    twin engine (parity and replay), shared by the first three tests."""
    cfg = MasterConfig(n_workers=2, ceilings=k_ceilings(KS), cache_size=64)
    ms = MasterServer(cfg, SPEC, record=True)
    with _env():
        ms.start()
    stop = th = None
    try:
        assert ms.wait_workers(timeout=UP), "workers never came up"
        stop, th = _serve_in_thread(ms)
        state, ceilings = build_state_from_spec(SPEC)
        yield SimpleNamespace(ms=ms, stop=stop, thread=th, cfg=cfg,
                              state=state,
                              exec_fn=make_exec_fn(state, ceilings))
    finally:
        if stop is not None:
            stop.set()
            th.join(timeout=10.0)
        ms.shutdown()


def test_live_roundtrip_parity_and_cache(net):
    trace = _trace(40)
    with NetClient(net.ms.addr, timeout=30.0) as c:
        records = c.run_trace(trace, settle=30.0)
    assert len(records) == len(trace)
    by_rid = {r.rid: r for r in trace}
    for rid, rec in records.items():
        assert rec["status"] in ("ok", "degraded"), (rid, rec)
        req = by_rid[rid]
        dists, ids = net.exec_fn(req.q, req.k, req.n_probe)
        # what came over the wire is the direct in-process call, bit for
        # bit, cached or not
        assert rec["ids"].dtype == np.int32
        np.testing.assert_array_equal(rec["ids"], ids)
        np.testing.assert_array_equal(rec["dists"], dists)
    assert any(r["cached"] for r in records.values())
    assert net.ms.core.stats["cache_hits"] > 0
    assert net.ms.core.stats["corrupt_detected"] == 0


def test_live_malformed_frames_typed_errors_workers_survive(net):
    ms = net.ms
    # stream-level garbage: a typed bad_frame error, then the close
    c = NetClient(ms.addr, timeout=10.0).connect()
    try:
        c.send_raw(b"\xff\xff\xff\xff garbage that is not a frame")
        r = c.recv_reply(timeout=10.0)
        assert r is not None and r["kind"] == frames.ERR
        assert r["code"] == "bad_frame"
        with pytest.raises(ConnectionError):
            c.recv_reply(timeout=10.0)
    finally:
        c.sock.close()

    # seeded corruption of a valid frame over the real wire
    rng = np.random.default_rng(7)
    base = frames.encode_frame(
        {"kind": frames.REQ, "rid": 1, "q": frames.pack_array(_rand_q(rng)),
         "k": 10, "n_probe": 8, "deadline_s": 1.0}, "json")
    for _ in range(8):
        blob = bytearray(base)
        for _ in range(3):
            blob[int(rng.integers(0, len(blob)))] = int(rng.integers(0, 256))
        cx = NetClient(ms.addr, timeout=10.0).connect()
        try:
            cx.send_raw(bytes(blob))
            reply = cx.recv_reply(timeout=5.0)
            if reply is not None:
                assert reply["kind"] in (frames.ERR, frames.RESP,
                                         frames.RETRY_AFTER)
        except ConnectionError:
            pass                        # closed on corruption: correct
        finally:
            cx.sock.close()

    # well-formed frames with hostile payloads: typed errors on an open
    # connection, then a valid request is served on it
    with NetClient(ms.addr, timeout=10.0) as c2:
        c2.sock.sendall(frames.encode_frame(
            {"kind": frames.REQ, "rid": 1, "q": "not an array",
             "k": 10, "n_probe": 8, "deadline_s": 1.0}, c2.codec))
        r = c2.recv_reply(10.0)
        assert r["kind"] == frames.ERR and r["code"] == "bad_request"
        c2.send_request(2, np.full(SPEC["d"], np.nan, np.float32), 10, 8,
                        1.0)
        r = c2.recv_reply(10.0)
        assert r["kind"] == frames.ERR and r["code"] == "bad_request"
        c2.sock.sendall(frames.encode_frame(
            {"kind": frames.REQ, "rid": 3,
             "q": frames.pack_array(_rand_q(rng)), "k": "lots",
             "n_probe": 8, "deadline_s": 1.0}, c2.codec))
        r = c2.recv_reply(10.0)
        assert r["kind"] == frames.ERR and r["code"] == "bad_request"
        c2.sock.sendall(frames.encode_frame({"kind": "totally_unknown"},
                                            c2.codec))
        r = c2.recv_reply(10.0)
        assert r["kind"] == frames.ERR and r["code"] == "bad_kind"
        c2.send_request(9, _rand_q(rng), 10, 8, 10.0)
        r = c2.recv_reply(30.0)
        assert r["kind"] == frames.RESP and r["rid"] == 9

    # an oversized frame announcement is refused before buffering
    c3 = NetClient(ms.addr, timeout=10.0).connect()
    try:
        c3.send_raw((64 * 1024 * 1024).to_bytes(4, "big") + b"J")
        r = c3.recv_reply(10.0)
        assert r is not None and r["code"] == "bad_frame"
    finally:
        c3.sock.close()
    assert all(p.poll() is None for p in ms.procs.values())
    assert ms.core.stats["malformed"] >= 2


def test_live_record_replay_digest_identical(net):
    """Stop the loop, then replay the recorded run through a fresh core
    with the in-process twin: the digest is byte-identical and every
    re-executed payload reproduces the worker's checksum."""
    net.stop.set()
    net.thread.join(timeout=10.0)
    assert not net.thread.is_alive()
    ms = net.ms
    live = outcome_digest(ms.core.outcome_list())
    assert ms.core.outcomes
    tr = Transcript.loads(ms.transcript.dumps())
    res = replay_transcript(tr, net.cfg, net.state.centroids, net.exec_fn)
    assert res.digest == live
    assert res.checksum_mismatches == []
    for key in ("offered", "cache_hits", "malformed", "dispatched"):
        assert res.core.stats[key] == ms.core.stats[key], key
    ups = [e for e in tr.entries if e.get("ev") == "up"]
    assert {e["wid"] for e in ups} == {0, 1}
    assert all(set(e["svc"]) == {"10,8", "100,8"} for e in ups)


def test_live_worker_death_detection_and_respawn(tmp_path):
    """A worker that exits while serving its 3rd request: the master sees
    the death, respawns it, and the orphaned request completes on the
    fresh process (the reference's 120 s deadline)."""
    cfg = MasterConfig(
        n_workers=1, ceilings=k_ceilings(KS),
        retry=RetryPolicy(relative=True, timeout_mult=6.0, max_retries=3,
                          backoff_base=0.005, backoff_cap=0.1))
    ms = MasterServer(cfg, SPEC, run_dir=str(tmp_path))
    with _env(REPRO_WORKER_EXIT_AFTER="3"):
        ms.start()
    stop = th = None
    try:
        assert ms.wait_workers(timeout=UP)
        stop, th = _serve_in_thread(ms)     # respawns inherit no hook
        rng = np.random.default_rng(3)
        with _env(), NetClient(ms.addr, timeout=30.0) as c:
            for rid in range(2):
                c.send_request(rid, _rand_q(rng), 10, 8, 30.0)
                r = c.recv_reply(30.0)
                assert r is not None and r["kind"] == frames.RESP \
                    and r["rid"] == rid
            c.send_request(2, _rand_q(rng), 100, 8, 120.0)
            r = c.recv_reply(120.0)
            assert r is not None and r["kind"] == frames.RESP \
                and r["rid"] == 2, r
        assert ms.core.stats["worker_lost"] >= 1
        assert ms.core.stats["respawns"] >= 1
        out = [o for o in ms.core.outcome_list() if o.request.k == 100]
        assert out and out[-1].completed
    finally:
        if stop is not None:
            stop.set()
            th.join(timeout=10.0)
        ms.shutdown()
    assert all(p.poll() is not None for p in ms.procs.values())
    # the run dir the caller passed is kept; only the respawned worker
    # exited cleanly and reported its launches (none on the CPU)
    assert len(list(tmp_path.glob("worker0.launches.*.json"))) == 1
    assert ms.worker_reports == 1
    assert set(ms.worker_launches) == set(ops.LAUNCHES)
    assert not any(ms.worker_launches.values())


def test_master_run_dir_removed_and_long_socket_path_on_tcp(tmp_path):
    """A run dir the master made is removed in shutdown; where the socket
    path would pass the AF_UNIX limit the master listens on TCP localhost
    and a client reaches it there."""
    cfg = MasterConfig(n_workers=1, ceilings=k_ceilings(KS))
    ms = MasterServer(cfg, SPEC, spawn_workers=False)
    try:
        ms.start()
        assert ms.addr["family"] == "unix" and os.path.isdir(ms.run_dir)
    finally:
        ms.shutdown()
    assert not os.path.exists(ms.run_dir)
    long_dir = tmp_path / ("d" * 120)
    ms = MasterServer(cfg, SPEC, run_dir=str(long_dir), spawn_workers=False)
    assert ms.addr == {"family": "tcp", "host": "127.0.0.1", "port": 0}
    stop = th = None
    try:
        ms.start()
        assert ms.addr["port"] > 0
        stop, th = _serve_in_thread(ms)
        with NetClient(ms.addr, timeout=10.0) as c:
            c.send_request(0, _rand_q(np.random.default_rng(0)), 10, 8,
                           0.05)
            r = c.recv_reply(10.0)
        # no worker is up: the master answers with a typed shed
        assert r is not None and r["rid"] == 0 and r["code"] == "shed", r
    finally:
        if stop is not None:
            stop.set()
            th.join(timeout=10.0)
        ms.shutdown()
    assert long_dir.is_dir()


def test_sigterm_graceful_drain_subprocess():
    """``serve --mode net --serve-forever --device cpu`` under SIGTERM: a
    request completes while up, every reply during the drain is a typed
    RESP or RETRY_AFTER, the summary conserves every offered request, and
    the exit code is 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "net",
         "--device", "cpu", "--workers", "1", "--n", "4096", "--d", "16",
         "--n-probe", "8", "--k-choices", "10,100", "--serve-forever"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    lines: list[str] = []
    reader = threading.Thread(
        target=lambda: lines.extend(iter(proc.stdout.readline, "")),
        daemon=True)
    reader.start()
    c = None
    try:
        addr, end = None, time.monotonic() + UP
        while addr is None and time.monotonic() < end:
            for line in list(lines):
                if '"listening"' in line:
                    addr = json.loads(line)["addr"]
            time.sleep(0.05)
        assert addr is not None, "server never announced its address"
        rng = np.random.default_rng(0)
        c = NetClient(addr, timeout=30.0).connect()
        c.send_request(0, _rand_q(rng), 10, 8, 10.0)
        r = c.recv_reply(30.0)
        assert r is not None and r["kind"] == frames.RESP and r["rid"] == 0
        inflight = list(range(1, 6))
        for rid in inflight:
            c.send_request(rid, _rand_q(rng), 100, 8, 10.0)
        got, closed = {}, False
        r = c.recv_reply(30.0)
        assert r is not None
        got[r.get("rid")] = r
        proc.send_signal(signal.SIGTERM)
        probe_rid, end = 100, time.monotonic() + 20.0
        while time.monotonic() < end and not closed and \
                not all(i in got for i in inflight):
            try:
                c.send_request(probe_rid, _rand_q(rng), 10, 8, 10.0)
                probe_rid += 1
                r = c.recv_reply(0.1)
            except (OSError, ConnectionError):
                closed = True
                break
            if r is not None:
                got[r.get("rid")] = r
        assert got or closed
        for rid, r in got.items():
            assert r["kind"] in (frames.RESP, frames.RETRY_AFTER), (rid, r)
        assert proc.wait(timeout=60) == 0
        reader.join(timeout=10.0)
        summaries = [json.loads(ln) for ln in lines
                     if ln.startswith("{") and '"conserved"' in ln]
        assert summaries and summaries[-1]["conserved"], lines[-3:]
        assert summaries[-1]["requests"] >= 1 + len(inflight)
        assert summaries[-1]["device"] == "cpu"
    finally:
        if c is not None and c.sock is not None:
            c.sock.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# ------------------------------ across frameworks ---------------------------

@pytest.fixture(scope="module")
def ref_index(tmp_path_factory):
    """The reference's engine from SPEC, its index's arrays in an ``.npz``,
    and its direct singleton executor (the id sets both runs are held to)."""
    jspec = jeh.build_spec(n=SPEC["n"], d=SPEC["d"], seed=SPEC["seed"],
                           ks=KS, n_probe=SPEC["n_probe"])
    jstate, jceil = jeh.build_state_from_spec(jspec)
    ji = jstate.index
    path = tmp_path_factory.mktemp("ref_index") / "index.npz"
    np.savez(path, ivf_centroids=np.asarray(ji.ivf.centroids),
             member_ids=np.asarray(ji.ivf.member_ids),
             member_valid=np.asarray(ji.ivf.member_valid),
             cluster_sizes=np.asarray(ji.ivf.cluster_sizes),
             vectors=np.asarray(ji.vectors),
             pq_centroids=np.asarray(ji.pq.centroids),
             codes=np.asarray(ji.codes))
    spec = build_spec(n=SPEC["n"], d=SPEC["d"], seed=SPEC["seed"], ks=KS,
                      n_probe=SPEC["n_probe"], device="cpu",
                      index_npz=str(path))
    return SimpleNamespace(spec=spec, jexec=jeh.make_exec_fn(jstate, jceil))


def _cross_run(ms, worker_cls, spec, ref_index):
    """Serve ``ms`` in a thread, answer it with one in-process worker of
    ``worker_cls``, drive a 30-request trace through the port's client;
    returns the client's records and the master's stats."""
    ms.start()
    stop, th = _serve_in_thread(ms)
    app = worker_cls({"wid": 0, "addr": ms.addr, "codec": ms.codec,
                      "engine": spec, "hb_interval": 0.05})
    wt = threading.Thread(target=app.run, daemon=True)
    wt.start()
    try:
        end = time.monotonic() + UP
        while not all(w.connected for w in ms.core.workers) and \
                time.monotonic() < end:
            time.sleep(0.02)
        assert all(w.connected for w in ms.core.workers)
        trace = _trace(30, seed=5)
        with NetClient(ms.addr, timeout=30.0) as c:
            records = c.run_trace(trace, settle=30.0)
    finally:
        app.stop = True
        wt.join(timeout=10.0)
        _stop(stop, th, ms)
    assert not wt.is_alive()
    by_rid = {r.rid: r for r in trace}
    assert len(records) == len(trace)
    for rid, rec in records.items():
        assert rec["status"] in ("ok", "degraded"), (rid, rec)
        req = by_rid[rid]
        jd, jids = ref_index.jexec(req.q, req.k, req.n_probe)
        assert set(rec["ids"].tolist()) == set(jids.tolist()), rid
        np.testing.assert_allclose(np.sort(rec["dists"]), np.sort(jd),
                                   rtol=1e-4, atol=1e-4)
    return records, ms.core.stats


def test_reference_master_answered_by_port_worker(ref_index):
    cfg = JMasterConfig(n_workers=1, ceilings=k_ceilings(KS))
    ms = jmaster.MasterServer(cfg, ref_index.spec, spawn_workers=False)
    records, stats = _cross_run(ms, WorkerApp, ref_index.spec, ref_index)
    assert stats["corrupt_detected"] == 0 and stats["dispatched"] > 0


def test_port_master_answered_by_reference_worker(ref_index):
    cfg = MasterConfig(n_workers=1, ceilings=k_ceilings(KS), cache_size=16)
    ms = MasterServer(cfg, ref_index.spec, spawn_workers=False)
    records, stats = _cross_run(ms, jworker.WorkerApp, ref_index.spec,
                                ref_index)
    assert stats["corrupt_detected"] == 0 and stats["dispatched"] > 0
    assert stats["cache_hits"] > 0
