"""Large-k retrieval serving entry point of the port.

Builds an IVF+PQ or IVF+RaBitQ index over a seeded synthetic corpus on the
device and serves fixed-size query batches through
``index.engine.SearchEngine`` (``--batch 1``: one (d,) query per call,
through the single-query searchers); the last stdout line is one JSON
summary with the JAX serving CLI's keys plus ``"device"``.  ``--method
flat`` serves exact search one query at a time, as the JAX CLI does.

  PYTHONPATH=src python -m repro_torch.launch.serve              # the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --n 12000 --d 64 --k 500 --n-clusters 64 --queries 16 --batch 8 \
      --method ivfrabitq_bbc

``--shards N`` serves the mesh-sharded engine over N ranks of a process
group: under ``torchrun --nproc-per-node N`` (``WORLD_SIZE`` set) each rank
joins the group ``torchrun`` describes; otherwise the CLI spawns N ranks
itself (gloo with ``--device cpu``, NCCL on cards 0..N-1 with CUDA) over a
``file://`` store.  Rank 0 builds the index and broadcasts it; rank 0
prints the summary.

``--mode async`` serves an open-loop request stream through the
micro-batching subsystem (``repro_torch.serving``): a seeded
synthetic trace (``--trace poisson|bursty`` at ``--rate`` req/s, deadline
``--deadline-ms`` after each arrival, k drawn from ``--k-choices``) flows
through admission control and deadline-aware batch assembly onto one
warmed engine per (k, n_probe) bucket, batches of ``--max-batch``.  The
last line is the JAX CLI's async summary plus ``"device"``; with
``--check-parity`` every completed request's ids are held against a direct
engine call and the exit code is 1 on any mismatch or when nothing was
checked.  With ``--shards N`` it serves the sharded engines: rank 0 runs
the event loop and drives the other ranks in lock step
(``serving.lockstep``), and only rank 0 prints.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode async \
      --check-parity                                 # the card
  PYTHONPATH=src python -m repro_torch.launch.serve --mode async \
      --device cpu --n 4000 --d 32 --n-clusters 32 --n-probe 8 \
      --queries 24 --k-choices 50,120 --max-batch 4 --check-parity

``--replicas N`` (N > 1, async mode) serves the trace through the
fault-tolerant replica tier (``serving.router.ReplicaServer``): N replicas
over the shared engines, affinity routing, health checks (``--hb-ms``),
retries (``--retries``), hedged sends (``--hedge``) and supervisor respawn
(``--respawn-ms``); ``--faults`` injects a deterministic fault schedule at
the replicas' service boundary (it requires ``--replicas > 1``), and the
summary gains ``replicas``, ``faults``, ``outcome_digest`` and
``fault_stats``.  With ``--shards`` the pool is rank 0's: its replicas
are forks of rank 0's ``LockstepState``, whose engine calls, forks,
predictor restores and swaps every other rank makes in lock step:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode async \
      --device cpu --n 4000 --d 32 --n-clusters 32 --n-probe 8 \
      --queries 24 --k-choices 50,120 --max-batch 4 --replicas 3 \
      --faults 'crash@1:t=0.05' --check-parity
  PYTHONPATH=src python -m repro_torch.launch.serve --mode async \
      --device cpu --n 4000 --d 32 --n-clusters 32 --n-probe 8 \
      --queries 24 --k-choices 50,120 --max-batch 4 --shards 2 \
      --replicas 2 --faults 'crash@1:t=0.05' --check-parity

``--tuned auto`` (the default, as in the JAX CLI) fills the knobs the
command line leaves unset from the port's own point store
(``tuned_points_torch.json`` at the repo root, or
``$REPRO_TORCH_TUNED_POINTS``) when it holds a point for the method; a
path reads that store instead (the JAX package's ``tuned_points.json``
too); ``off`` keeps the hand defaults.  The summary names the operating
point (or ``hand-tuned fallback``) of each engine, and the replica tier's
degrade ladder walks the store's recall/cost frontier.

``--mode net`` serves a Zipf trace of ``--requests`` requests through the
multi-process socket front end (``repro_torch.transport``): a master
spawns ``--workers`` worker processes, each building the engine from one
spec on ``--device`` and answering singleton requests, with a result cache
of ``--net-cache`` entries in the master, seeded wire faults
(``--wire-faults``), a recorded transcript (``--record``) and an in-process
replay that must reproduce the outcome digest (``--check-replay``).  With
``--serve-forever`` it listens on ``--addr`` until SIGTERM or SIGINT, then
drains.  The last line is the JAX CLI's net summary plus ``"device"``:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode net \
      --check-replay                                 # the card
  PYTHONPATH=src python -m repro_torch.launch.serve --mode net \
      --device cpu --n 4096 --d 16 --n-probe 8 --k-choices 10,100 \
      --workers 2 --requests 40 --check-replay

Every mode, ``--method`` and flag of the JAX CLI is ported.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.core import distributed
from repro_torch.data import synthetic
from repro_torch.index import engine, flat, search
from repro_torch.kernels.platform import resolve_device
from repro_torch.serving import lockstep
from repro_torch.serving.state import HAND_TUNED, ServingState
from repro_torch.tuning.points import PointStore

METHODS = ("ivfpq", "ivfpq_bbc", "ivfrabitq", "ivfrabitq_bbc", "flat")
RECALL_SAMPLE = 8   # queries with exact ground truth for the recall estimate


def build_index(method: str, x: torch.Tensor, n_clusters: int, seed: int,
                dev: torch.device):
    if method.startswith("ivfpq"):
        return search.build_pq_index(x, n_clusters, seed=seed, device=dev)
    if method.startswith("ivfrabitq"):
        return search.build_rabitq_index(x, n_clusters, seed=seed,
                                         device=dev)
    return None


def mean_recall(x: torch.Tensor, qs: torch.Tensor, ids: list, k: int) -> float:
    """Mean recall@k of result id rows against exact ground truth."""
    _, gt = flat.search_batch(x, qs, k)
    gt = gt.cpu().numpy()
    recalls = [len(set(np.asarray(r).tolist()) - {-1} & set(g.tolist())) / k
               for r, g in zip(ids, gt)]
    return float(np.mean(recalls)) if recalls else float("nan")


def mean_recall_entries(x: torch.Tensor, entries) -> float:
    """Mean recall over (query, ids, k) triples against exact ground truth
    (per-entry k, so heterogeneous-k serving outcomes average correctly)."""
    recalls = []
    for q, ids, k in entries:
        q = torch.as_tensor(np.asarray(q, np.float32)).to(x.device)
        gt = flat.search(x, q, k)[1].cpu().numpy()
        got = set(np.asarray(ids).tolist()) - {-1}
        recalls.append(len(got & set(gt.tolist())) / k)
    return float(np.mean(recalls)) if recalls else float("nan")


def sample_indices(n: int, n_sample: int) -> np.ndarray:
    """Evenly spaced sample over [0, n) that always includes the last index."""
    return np.unique(np.linspace(0, max(n - 1, 0),
                                 min(n_sample, n)).round().astype(int))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tuned_store(args) -> PointStore | None:
    """The point store ``--tuned`` names: None for ``off`` and for an
    ``auto`` store that is absent or empty; an explicit path that yields
    no point exits, as in the JAX CLI."""
    if args.tuned == "off":
        return None
    store = PointStore.load(None if args.tuned == "auto" else args.tuned)
    if args.tuned != "auto" and not len(store):
        raise SystemExit(f"--tuned {args.tuned}: no usable point store")
    return store if len(store) else None


def run_static(args, x: torch.Tensor | None, qs: torch.Tensor, index,
               dev: torch.device, mesh=None) -> dict:
    """Serve ``qs`` in fixed batches; with ``mesh``, every rank calls this
    together and only the rank holding ``x`` (rank 0) measures recall."""
    tau_pred_on = args.tau_pred == "on"
    if args.method == "flat":
        if tau_pred_on:
            raise SystemExit("--tau-pred does not apply to the flat baseline")
        batch = 1
        searcher = lambda q: flat.search(x, q, args.k)[1]  # noqa: E731
    else:
        if tau_pred_on and not args.method.endswith("bbc"):
            raise SystemExit("--tau-pred on requires a *_bbc method")
        # n_cand / pred_count come from the tuned operating point when
        # one covers this (method, k) cell, else the hand defaults
        eng = engine.SearchEngine.build(
            index, k=args.k, n_probe=min(args.n_probe, args.n_clusters),
            use_bbc=args.method.endswith("bbc"),
            pred_count=args.pred_count, device=dev, mesh=mesh,
            tuned=tuned_store(args), recall_target=args.recall_target)
        batch = max(1, args.batch)
        eng.warmup((batch, (args.queries - 1) % batch + 1),
                   predictive=tau_pred_on)
        state = [eng.predictor_init()]

        def searcher(qb):
            if tau_pred_on:
                r, state[0] = eng.search(qb, pred_state=state[0])
                return r.ids
            return eng.search(qb).ids

    batches = [qs[i:i + batch] for i in range(0, args.queries, batch)]
    if batch == 1:          # one (d,) query per call
        batches = [q for q in qs]
    searcher(batches[0])
    _sync(dev)
    t0 = time.monotonic()
    results = [searcher(qb) for qb in batches]
    _sync(dev)
    dt = time.monotonic() - t0
    all_ids = [row for ids in results
               for row in ids.reshape(-1, args.k).cpu().numpy()]
    idx = sample_indices(args.queries, RECALL_SAMPLE)
    recall = float("nan") if x is None else mean_recall(
        x, qs[torch.as_tensor(idx, device=dev)], [all_ids[i] for i in idx],
        args.k)
    return {
        "mode": "static", "method": args.method, "k": args.k,
        "batch": batch, "shards": args.shards, "tau_pred": args.tau_pred,
        "operating_point": "flat" if args.method == "flat" else
        eng.tuned_from or HAND_TUNED,
        "qps": round(args.queries / dt, 2),
        "ms_per_query": round(1e3 * dt / args.queries, 2),
        "ms_per_batch": round(1e3 * dt / len(batches), 2),
        "recall_mean": round(recall, 4),
        "recall_queries": int(len(idx)),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")}


def check_async(args) -> None:
    """The async mode's flag refusals, made before any rank starts."""
    if args.method == "flat":
        raise SystemExit("--mode async does not apply to the flat baseline")
    if args.tau_pred == "on" and not args.method.endswith("bbc"):
        raise SystemExit("--tau-pred on requires a *_bbc method")
    if args.tau_pred == "on" and args.check_parity:
        raise SystemExit(
            "--check-parity compares against non-predictive direct calls; "
            "run it with --tau-pred off")
    if args.faults and args.replicas <= 1:
        raise SystemExit("--faults requires --replicas > 1 (faults are "
                         "injected at the replica service boundary)")


def serving_state(args, index, dev: torch.device, mesh=None,
                  leader: bool = True) -> ServingState:
    """The async mode's ``ServingState``: on one device, or on a mesh as
    rank 0's ``LockstepState`` (``leader``) or a following rank's state."""
    kw = dict(use_bbc=args.method.endswith("bbc"),
              tau_pred=args.tau_pred == "on", pred_count=args.pred_count,
              tuned=tuned_store(args))
    if mesh is None:
        return ServingState(index, device=dev, **kw)
    if leader:
        return lockstep.LockstepState(index, mesh=mesh, **kw)
    return ServingState(index, mesh=mesh, **kw)


def run_async(args, x: torch.Tensor, qs: torch.Tensor, index,
              dev: torch.device, mesh=None) -> tuple[dict, int]:
    """The micro-batching event loop over ``repro_torch.serving``: the
    reference's ``run_async``, through the replica tier with ``--replicas
    N > 1``.  With ``mesh`` this is rank 0 of the sharded deployment,
    driving the other ranks' engines in lock step until its last engine
    call.  Returns the summary and the exit code."""
    from repro_torch.serving import batcher as sv_batcher
    from repro_torch.serving import queue as sv_queue
    from repro_torch.serving import server as sv_server

    n_probe = min(args.n_probe, args.n_clusters)
    ks = tuple(int(s) for s in args.k_choices.split(",")) \
        if args.k_choices else (args.k,)
    trace = sv_queue.make_trace(
        np.random.default_rng(args.seed), qs.cpu().numpy(), ks,
        rate=args.rate, deadline=args.deadline_ms / 1e3, n_probe=n_probe,
        pattern=args.trace, burst=args.burst,
        recall_target=args.recall_target)
    state = serving_state(args, index, dev, mesh)
    max_wait = args.max_wait_ms / 1e3 if args.max_wait_ms else None
    if args.replicas > 1:
        # the fault-tolerant multi-replica tier: affinity routing, health
        # checks, retries and hedges, supervisor respawn
        from repro_torch.serving import faults as sv_faults
        from repro_torch.serving.admission import DegradeLadder
        from repro_torch.serving.router import (HedgePolicy, ReplicaServer,
                                                RetryPolicy)
        schedule = sv_faults.FaultSchedule.parse(args.faults) \
            if args.faults else None
        # degrade along the tuned recall/cost frontier when the store
        # covers this method, instead of the hand-picked k caps
        ladder = None
        if state.tuned is not None:
            frontier = state.tuned.frontier(state.kind, max(ks))
            if len(frontier) > 1:
                ladder = DegradeLadder.from_frontier(frontier)
        srv = ReplicaServer(
            state, args.replicas, ceilings=sv_batcher.k_ceilings(ks),
            batch=args.max_batch, ladder=ladder,
            retry=RetryPolicy(max_retries=args.retries),
            hedge=HedgePolicy(enabled=args.hedge == "on"),
            faults=schedule, max_wait=max_wait,
            hb_interval=args.hb_ms / 1e3,
            respawn_delay=args.respawn_ms / 1e3)
    else:
        srv = sv_server.Server(
            state, ceilings=sv_batcher.k_ceilings(ks), batch=args.max_batch,
            admission=not args.no_admission, max_wait=max_wait)
    n_buckets = len({(min(r.k, max(ks)), r.n_probe) for r in trace})
    t0 = time.monotonic()
    srv.warmup(trace)
    print(f"[serve] warmed {n_buckets} shape buckets in "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    outcomes = srv.run_trace(trace, warmup=False)
    # one executor per replica: each batch finishes at its own instant
    batches = len({(o.replica, o.bucket, o.t_done) for o in outcomes
                   if o.completed})
    print(f"[serve] {batches} batches served", flush=True)

    summary = sv_server.summarize(outcomes, state=state)
    if args.replicas > 1:
        from repro_torch.serving.router import outcome_digest
        summary.update({
            "replicas": args.replicas, "faults": args.faults or "",
            "outcome_digest": outcome_digest(outcomes),
            "fault_stats": dict(sorted(srv.stats.items())),
        })
    done = [o for o in outcomes if o.status != sv_server.SHED]
    idx = sample_indices(len(done), RECALL_SAMPLE)
    # None (json null), not NaN, when everything was shed
    recall = mean_recall_entries(
        x, [(done[i].request.q, done[i].ids, done[i].k_effective)
            for i in idx]) if done else None
    parity = n_checked = None
    if args.check_parity:
        parity, n_checked = sv_server.parity_vs_direct(state, outcomes)
    if mesh is not None:
        state.stop()
    summary.update({
        "mode": "async", "method": args.method, "trace": args.trace,
        "rate": args.rate, "deadline_ms": args.deadline_ms,
        "k_choices": list(ks), "max_batch": args.max_batch,
        "shards": args.shards, "tau_pred": args.tau_pred,
        "recall_mean": round(recall, 4) if recall is not None else None,
        "recall_queries": int(len(idx))})
    if parity is not None:
        summary["parity"] = round(parity, 4)
        summary["parity_checked"] = n_checked
    summary["device"] = (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu")
    # an all-shed run verified nothing: that is a parity failure
    rc = 1 if (parity is not None and (parity < 1.0 or n_checked == 0)) \
        else 0
    return summary, rc


def _parse_net_addr(spec: str):
    """'' -> the master's default; 'unix:/path' -> Unix socket;
    'host:port' -> TCP."""
    from repro_torch.transport.master import tcp_addr, unix_addr
    if not spec:
        return None
    if spec.startswith("unix:"):
        return unix_addr(spec[len("unix:"):])
    host, _, port = spec.rpartition(":")
    try:
        return tcp_addr(host or "127.0.0.1", int(port))
    except ValueError:
        raise SystemExit(f"--addr {spec!r}: want 'unix:/path' or "
                         f"'host:port'")


def net_spec_and_trace(args, device: str):
    """``--mode net``'s engine spec on ``device`` and its Zipf trace of
    ``--requests`` singleton requests, from the parsed arguments: the
    reference's ``run_net`` derivation (clusters capped at n / 64, n_probe
    at the clusters, the query pool and trace seeded from ``seed + 1``)."""
    from repro_torch.serving.queue import make_zipf_trace
    from repro_torch.transport.enginehost import build_spec, make_dataset
    ks = tuple(int(s) for s in args.k_choices.split(",")) \
        if args.k_choices else (args.k,)
    n_clusters = min(args.n_clusters, max(args.n // 64, 16))
    n_probe = min(args.n_probe, n_clusters)
    spec = build_spec(n=args.n, d=args.d, seed=args.seed, ks=ks,
                      n_probe=n_probe, n_clusters=n_clusters, device=device)
    rng = np.random.default_rng(args.seed + 1)
    pool = synthetic.queries_from(rng, make_dataset(spec),
                                  max(args.requests // 8, 4))
    trace = make_zipf_trace(rng, pool, args.requests, ks, rate=args.rate,
                            deadline=args.deadline_ms / 1e3, n_probe=n_probe)
    return spec, trace


def run_net(args) -> int:
    """The multi-process socket front end (``repro_torch.transport``): the
    reference's ``run_net``.  Every worker and the replay build the engine
    from one spec on ``--device``; for a CUDA spec the master builds the
    kernels once before it spawns the workers.  Returns the exit code: 1
    when the workers do not come up or the replay's digest differs."""
    import signal
    import threading

    from repro_torch.serving import faults as sv_faults
    from repro_torch.serving import server as sv_server
    from repro_torch.serving.batcher import k_ceilings
    from repro_torch.serving.router import outcome_digest
    from repro_torch.transport.client import NetClient
    from repro_torch.transport.core import MasterConfig
    from repro_torch.transport.enginehost import (build_state_from_spec,
                                                  make_exec_fn)
    from repro_torch.transport.master import MasterServer
    from repro_torch.transport.replay import replay_transcript

    addr = _parse_net_addr(args.addr)
    dev = resolve_device(args.device)   # no worker starts for a missing card
    spec, trace = net_spec_and_trace(args, dev.type)
    ks = tuple(spec["ks"])
    wire = sv_faults.WireSchedule.parse(args.wire_faults) \
        if args.wire_faults else None
    cfg = MasterConfig(n_workers=args.workers, ceilings=k_ceilings(ks),
                       cache_size=args.net_cache,
                       hb_interval=args.hb_ms / 1e3)
    ms = MasterServer(cfg, spec, addr=addr, wire=wire,
                      record=bool(args.record) or args.check_replay)
    want_drain = threading.Event()
    handlers = {sig: signal.getsignal(sig)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    records: dict[int, dict] = {}
    client_thread = None
    try:
        t0 = time.monotonic()
        ms.start()
        if not ms.wait_workers(timeout=300.0):
            print(json.dumps({"error": "workers failed to come up"}))
            return 1
        print(f"[serve] {args.workers} workers ready in "
              f"{time.monotonic() - t0:.1f}s on {ms.addr}", flush=True)
        for sig in handlers:
            signal.signal(sig, lambda s, f: want_drain.set())
        if not args.serve_forever:
            def _drive():
                try:
                    with NetClient(ms.addr) as c:
                        records.update(c.run_trace(trace))
                finally:
                    want_drain.set()
            client_thread = threading.Thread(target=_drive, daemon=True)
            client_thread.start()
        else:
            print(json.dumps({"event": "listening", "addr": ms.addr}),
                  flush=True)
        while not ms.stopped:
            if want_drain.is_set():
                ms.drain()
            if ms._drain_started is not None and (
                    ms.core.idle() or ms.clock.now() - ms._drain_started
                    > ms.drain_timeout):
                ms.shutdown()
                break
            ms.step()
        if client_thread is not None:
            client_thread.join(timeout=10.0)
    finally:
        ms.shutdown()
        for sig, handler in handlers.items():
            signal.signal(sig, handler)

    outcomes = ms.core.outcome_list()
    summary = sv_server.summarize(outcomes)
    summary.update({
        "mode": "net", "workers": args.workers,
        "k_choices": list(ks), "rate": args.rate,
        "wire_faults": args.wire_faults or "",
        "outcome_digest": outcome_digest(outcomes),
        "net_stats": {k: v for k, v in sorted(ms.core.stats.items()) if v},
        "cache": ms.core.cache_stats(),
        # the card's kernel launches, as the workers reported them
        "worker_launches": {k: v for k, v in ms.worker_launches.items()
                            if v},
    })
    if records:
        done = [r for r in records.values()
                if r["status"] in ("ok", "degraded")]
        summary["client_completed"] = len(done)
        lat = sorted(r["latency_s"] for r in done)
        if lat:
            summary["client_p99_ms"] = round(
                1e3 * lat[min(int(0.99 * len(lat)), len(lat) - 1)], 2)
    rc = 0
    if args.check_replay:
        state, ceil = build_state_from_spec(spec)
        res = replay_transcript(ms.transcript, cfg, state.centroids,
                                make_exec_fn(state, ceil))
        summary["replay_digest"] = res.digest
        summary["replay_identical"] = \
            res.digest == summary["outcome_digest"]
        if not summary["replay_identical"]:
            rc = 1
    if args.record:
        ms.transcript.save(args.record)
        summary["transcript"] = args.record
    summary["device"] = (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu")
    print(json.dumps(summary))
    return rc


def corpus(args, dev: torch.device):
    rng = np.random.default_rng(args.seed)
    x_np = synthetic.clustered(rng, args.n, args.d)
    qs_np = synthetic.queries_from(rng, x_np, args.queries)
    return torch.from_numpy(x_np).to(dev), torch.from_numpy(qs_np).to(dev)


def serve_rank(args, dev: torch.device) -> tuple[dict, int] | None:
    """One rank of the sharded deployment, inside an initialised process
    group: rank 0 makes the corpus and builds the index, every rank gets
    the queries and the index from rank 0 (none assumes that its own build
    would equal rank 0's), and all serve together (``--mode async``: rank
    0's event loop, the others following it in lock step).  Returns rank
    0's summary and exit code, None elsewhere."""
    rank = tdist.get_rank()
    mesh = distributed.make_mesh((args.shards,), ("model",), device=dev)
    x = payload = None
    if rank == 0:
        x, qs = corpus(args, dev)
        t0 = time.monotonic()
        index = build_index(args.method, x, args.n_clusters, args.seed, dev)
        print(f"[serve] index built in {time.monotonic() - t0:.1f}s",
              flush=True)
        payload = (qs.cpu(), search.index_to(index, "cpu"))
    box = [payload]
    tdist.broadcast_object_list(box, src=0, device=dev if dev.type == "cuda"
                                else None)
    qs, index = box[0]
    if args.mode == "async":
        if rank == 0:
            return run_async(args, x, qs.to(dev), index, dev, mesh=mesh)
        lockstep.follow(serving_state(args, index, dev, mesh, leader=False))
        return None
    out = run_static(args, x, qs.to(dev), index, dev, mesh=mesh)
    return (out, 0) if rank == 0 else None


def _report(ranked) -> int:
    """Print rank 0's summary; returns its exit code (0 elsewhere)."""
    if ranked is None:
        return 0
    out, rc = ranked
    print(json.dumps(out), flush=True)
    return rc


def _spawned(rank: int, argv: list, store: str) -> None:
    """Entry point of a rank that ``main`` spawned for ``--shards``; rank 0
    leaves its exit code in ``<store>.rc``."""
    args = parse_args(argv)
    dev = torch.device("cpu") if args.device == "cpu" else \
        torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:       # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.shards))
    tdist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                             init_method=f"file://{store}", rank=rank,
                             world_size=args.shards)
    try:
        rc = _report(serve_rank(args, dev))
    finally:
        tdist.destroy_process_group()
    if rank == 0:
        with open(store + ".rc", "w") as f:
            f.write(str(rc))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--k", type=int, default=5_000)
    ap.add_argument("--method", choices=METHODS, default="ivfpq_bbc")
    ap.add_argument("--n-probe", type=int, default=64)
    ap.add_argument("--n-clusters", type=int, default=316)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--mode", choices=("static", "async", "net"),
                    default="static",
                    help="static = fixed-batch loop; async = deadline-aware "
                         "micro-batching over an open-loop trace; net = "
                         "the multi-process socket front end")
    ap.add_argument("--batch", type=int, default=32,
                    help="queries per engine call")
    ap.add_argument("--shards", type=int, default=1,
                    help="mesh-shard the corpus over this many ranks "
                         "(torchrun's, or spawned here)")
    ap.add_argument("--tau-pred", choices=("on", "off"), default="off",
                    help="predictive early-exact re-ranking across batches")
    ap.add_argument("--pred-count", type=int, default=None,
                    help="predictive re-rank pool target (default ~2.5k)")
    ap.add_argument("--tuned", type=str, default="auto",
                    help="tuned operating points: 'auto' loads the port's "
                         "store (tuned_points_torch.json at the repo root, "
                         "or $REPRO_TORCH_TUNED_POINTS) when present, "
                         "'off' forces the hand-tuned defaults, anything "
                         "else is a path to a point-store JSON")
    ap.add_argument("--recall-target", type=float, default=0.95,
                    help="recall@k requirement: selects the tuned "
                         "operating point and stamps async-mode requests")
    # -- async-mode knobs (the JAX CLI's, with its defaults) ----------------
    ap.add_argument("--trace", choices=("poisson", "bursty"),
                    default="poisson", help="[async] arrival pattern")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="[async] offered load, requests/s")
    ap.add_argument("--deadline-ms", type=float, default=500.0,
                    help="[async] per-request deadline after arrival")
    ap.add_argument("--k-choices", type=str, default="",
                    help="[async] comma-separated k values sampled per "
                         "request (default: just --k); the bucket ladder")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="[async] padded batch width B of the shape buckets")
    ap.add_argument("--max-wait-ms", type=float, default=None,
                    help="[async] cap on queueing wait before a partial "
                         "batch fires (default: deadline-slack only)")
    ap.add_argument("--burst", type=int, default=8,
                    help="[async] burst size for --trace bursty")
    ap.add_argument("--no-admission", action="store_true",
                    help="[async] disable admission control")
    ap.add_argument("--check-parity", action="store_true",
                    help="[async] verify every completed request's ids "
                         "against a direct engine call; exit 1 on any "
                         "mismatch")
    # -- multi-replica fault-tolerance knobs (async mode) -------------------
    ap.add_argument("--replicas", type=int, default=1,
                    help="[async] replica pool size; > 1 routes through the "
                         "fault-tolerant tier (affinity routing, health "
                         "checks, retries, hedges, supervisor respawn)")
    ap.add_argument("--faults", type=str, default="",
                    help="[async] deterministic fault schedule, e.g. "
                         "'crash@1:t=0.5;stall@0:t=0.2,dur=0.1;"
                         "slow@2:t=0.0,dur=1.0,factor=4;corrupt@3:t=0.3,"
                         "dur=0.2' (requires --replicas > 1)")
    ap.add_argument("--retries", type=int, default=2,
                    help="[async] max retry attempts per request after a "
                         "timeout or corrupt response (--replicas > 1)")
    ap.add_argument("--hedge", choices=("on", "off"), default="on",
                    help="[async] hedged second sends when deadline slack "
                         "runs low; first response wins (--replicas > 1)")
    ap.add_argument("--hb-ms", type=float, default=20.0,
                    help="[async] replica heartbeat interval, ms "
                         "(--replicas > 1)")
    ap.add_argument("--respawn-ms", type=float, default=50.0,
                    help="[async] supervisor respawn delay after a replica "
                         "is marked DOWN, ms (--replicas > 1)")
    # -- net-mode knobs (--mode net; the JAX CLI's, with its defaults) ------
    ap.add_argument("--workers", type=int, default=4,
                    help="[net] worker subprocesses to spawn and supervise")
    ap.add_argument("--net-cache", type=int, default=256,
                    help="[net] exact-key result cache capacity in the "
                         "master (0 = off)")
    ap.add_argument("--wire-faults", type=str, default="",
                    help="[net] seeded wire-fault schedule, e.g. "
                         "'drop=0.02,dup=0.01,slow=0.1,slow_ms=2:8,"
                         "disconnect=0.005,seed=7'")
    ap.add_argument("--record", type=str, default="",
                    help="[net] write the run's record/replay transcript "
                         "to this path")
    ap.add_argument("--check-replay", action="store_true",
                    help="[net] after the run, replay the transcript "
                         "in-process on --device and exit 1 unless the "
                         "outcome digest is byte-identical")
    ap.add_argument("--serve-forever", action="store_true",
                    help="[net] keep serving until SIGTERM/SIGINT, then "
                         "drain gracefully and exit 0")
    ap.add_argument("--addr", type=str, default="",
                    help="[net] listen address: 'unix:/path' or "
                         "'host:port' (default: a Unix socket in a "
                         "fresh run dir)")
    ap.add_argument("--requests", type=int, default=200,
                    help="[net] trace length for the built-in driver")
    ap.add_argument("--seed", type=int, default=0,
                    help="corpus and trace RNG seed")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)

    if args.mode == "net":
        return run_net(args)
    tuned_store(args)               # an unusable --tuned path exits now
    if args.mode == "async":
        check_async(args)
    dev = resolve_device(args.device)

    if args.shards > 1:
        if args.method == "flat":
            raise SystemExit("--shards does not apply to the flat baseline")
        if "WORLD_SIZE" in os.environ:            # under torchrun
            if int(os.environ["WORLD_SIZE"]) != args.shards:
                raise SystemExit(f"--shards {args.shards} under a torchrun "
                                 f"world of {os.environ['WORLD_SIZE']}")
            if dev.type == "cuda":
                dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
                torch.cuda.set_device(dev)
            tdist.init_process_group("gloo" if dev.type == "cpu" else "nccl")
            try:
                return _report(serve_rank(args, dev))
            finally:
                tdist.destroy_process_group()
        if dev.type == "cuda" and torch.cuda.device_count() < args.shards:
            raise RuntimeError(f"--shards {args.shards} needs "
                               f"{args.shards} cards, this host has "
                               f"{torch.cuda.device_count()}")
        import torch.multiprocessing as mp

        from repro_torch.launch import serve as this
        with tempfile.TemporaryDirectory() as tmp:
            store = os.path.join(tmp, "store")
            mp.spawn(this._spawned, args=(argv, store), nprocs=args.shards,
                     join=True)
            with open(store + ".rc") as f:
                return int(f.read())

    x, qs = corpus(args, dev)
    t0 = time.monotonic()
    index = build_index(args.method, x, args.n_clusters, args.seed, dev)
    _sync(dev)
    print(f"[serve] index built in {time.monotonic() - t0:.1f}s", flush=True)
    if args.mode == "async":
        summary, rc = run_async(args, x, qs, index, dev)
        print(json.dumps(summary))
        return rc
    print(json.dumps(run_static(args, x, qs, index, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
