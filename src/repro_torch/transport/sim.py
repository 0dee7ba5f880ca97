"""Loopback simulation driver: MasterCore + simulated workers + wire shim
on a virtual clock.

This is the third driver over the same :class:`~repro_torch.transport.core.
MasterCore` (live sockets and replay are the others): workers are modeled
as single-executor FIFO servers with a caller-supplied deterministic
``exec_fn`` and ``service_fn``, the wire applies a seeded
:class:`~repro_torch.serving.faults.WireSchedule` at frame granularity in both
directions, heartbeats flow as real frames (and are therefore subject to
wire faults, exactly like the socket path), and worker kills / respawns
follow a declarative schedule.  Everything runs on one ``heapq`` timeline
with explicit tie-breaks, so a seeded (trace, schedule) pair replays
byte-identically — which is what lets the property tests draw random
trace x wire-fault-schedule pairs and assert conservation, and what lets
the record/replay tests exercise the full transcript contract without
spawning a single process.

The port's copy of the JAX package's ``transport/sim.py``: over the port's
``MasterCore`` and the same stub executor, trace, wire schedule and kills,
it gives the reference's outcome digest, transcript and stats.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Callable, Sequence

import numpy as np

from repro_torch.serving import faults as flt
from repro_torch.serving.batcher import ShapeBucket, bucket_of
from repro_torch.serving.queue import Request
from repro_torch.transport.core import MasterCore
from repro_torch.transport.wire import Transcript, WireShim

ExecFn = Callable[[np.ndarray, int, int], tuple[np.ndarray, np.ndarray]]
ServiceFn = Callable[[ShapeBucket], float]


class _SimWorker:
    """Single-executor worker model: FIFO queue, busy-until clock."""

    def __init__(self, wid: int):
        self.wid = wid
        self.alive = True
        self.connected = False
        self.busy_until = 0.0
        self.queue: deque = deque()
        self.gen = 0                    # bumps on kill; stale work discarded


class LoopbackSim:
    """Virtual-clock transport run over one ``MasterCore``."""

    def __init__(self, core: MasterCore, exec_fn: ExecFn,
                 service_fn: ServiceFn, *,
                 wire: flt.WireSchedule | None = None,
                 kill_at: dict[int, float] | None = None,
                 reconnect_delay: float = 0.02,
                 respawn_delay: float = 0.1,
                 record: bool = False):
        self.core = core
        self.exec_fn = exec_fn
        self.service_fn = service_fn
        self.shim = WireShim(wire)
        self.kill_at = dict(kill_at or {})
        self.reconnect_delay = float(reconnect_delay)
        self.respawn_delay = float(respawn_delay)
        self.workers = [_SimWorker(w) for w in range(core.cfg.n_workers)]
        self.replies: list[tuple[int, dict]] = []    # (conn, frame)
        self.transcript = Transcript() if record else None
        self._heap: list = []
        self._seq = itertools.count()

    # -- timeline helpers ----------------------------------------------------

    def _push(self, t: float, kind: str, data=None) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, data))

    def _record(self, entry: dict) -> None:
        if self.transcript is not None:
            self.transcript.append(entry)

    def _core(self, ev: dict) -> None:
        """Feed one event to the core, record it, execute the actions."""
        if ev["ev"] == "resp":
            entry = dict(ev)
            entry["n_ids"] = int(len(ev["ids"]))
            entry["ck_ok"] = bool(
                flt.payload_checksum(ev["dists"], ev["ids"])
                == int(ev["checksum"]))
            self._record(entry)
        else:
            self._record(dict(ev))
        for act in self.core.handle(ev):
            if act[0] == "timer":
                _, t_at, tev = act
                self._push(t_at, "core", tev)
            elif act[0] == "reply":
                self.replies.append((act[1], act[2]))
            elif act[0] == "send":
                self._send_up(act[1], act[2], ev["t"])

    # -- wire: master -> worker ----------------------------------------------

    def _send_up(self, wid: int, frame: dict, t: float) -> None:
        w = self.workers[wid]
        if not w.connected or not w.alive:
            return                      # dispatch raced a dead link
        d = self.shim.decide(wid, "up")
        if d.kind is not None:
            self._record({"ev": "fault", "t": t, "wid": wid, "dir": "up",
                          "kind": d.kind, "delay": d.delay})
        if d.kind == flt.WIRE_DROP:
            return
        if d.kind in (flt.WIRE_TRUNCATE, flt.WIRE_DISCONNECT):
            self._disconnect(wid, t)
            return
        n = 2 if d.kind == flt.WIRE_DUP else 1
        for _ in range(n):
            self._push(t + d.delay, "deliver_up", (wid, w.gen, dict(frame)))

    def _on_deliver_up(self, wid: int, gen: int, frame: dict,
                       t: float) -> None:
        w = self.workers[wid]
        if not w.alive or not w.connected or gen != w.gen:
            return
        if frame["kind"] != "req":
            return
        bucket = bucket_of(int(frame["k"]), int(frame["n_probe"]),
                           self.core.cfg.ceilings, 1)
        start = max(t, w.busy_until)
        done = start + self.service_fn(bucket)
        w.busy_until = done
        self._push(done, "exec_done", (wid, w.gen, dict(frame)))

    def _on_exec_done(self, wid: int, gen: int, frame: dict,
                      t: float) -> None:
        w = self.workers[wid]
        if not w.alive or not w.connected or gen != w.gen:
            return
        dists, ids = self.exec_fn(np.asarray(frame["q"]), int(frame["k"]),
                                  int(frame["n_probe"]))
        resp = {"kind": "resp", "rid": frame["rid"], "wid": wid,
                "dists": dists, "ids": ids,
                "checksum": flt.payload_checksum(dists, ids),
                "k": int(frame["k"]), "n_probe": int(frame["n_probe"])}
        self._send_down(wid, resp, t)

    # -- wire: worker -> master ----------------------------------------------

    def _send_down(self, wid: int, frame: dict, t: float) -> None:
        w = self.workers[wid]
        if not w.connected or not w.alive:
            return
        d = self.shim.decide(wid, "down")
        if d.kind is not None:
            self._record({"ev": "fault", "t": t, "wid": wid, "dir": "down",
                          "kind": d.kind, "delay": d.delay})
        if d.kind == flt.WIRE_DROP:
            return
        if d.kind in (flt.WIRE_TRUNCATE, flt.WIRE_DISCONNECT):
            self._disconnect(wid, t)
            return
        n = 2 if d.kind == flt.WIRE_DUP else 1
        for _ in range(n):
            self._push(t + d.delay, "deliver_down", (wid, dict(frame)))

    def _on_deliver_down(self, wid: int, frame: dict, t: float) -> None:
        if frame["kind"] == "resp":
            self._core({"ev": "resp", "t": t, "wid": wid,
                        "rid": frame["rid"], "dists": frame["dists"],
                        "ids": frame["ids"],
                        "checksum": frame["checksum"]})
        elif frame["kind"] == "hb":
            self._core({"ev": "hb", "t": t, "wid": wid})
        elif frame["kind"] == "err":
            self._core({"ev": "werr", "t": t, "wid": wid,
                        "rid": frame["rid"], "code": frame["code"]})

    # -- link / process lifecycle --------------------------------------------

    def _disconnect(self, wid: int, t: float) -> None:
        w = self.workers[wid]
        if not w.connected:
            return
        w.connected = False
        w.queue.clear()
        w.gen += 1                      # in-progress work dies with the conn
        self._core({"ev": "lost", "t": t, "wid": wid})
        if w.alive:
            self._push(t + self.reconnect_delay, "reconnect",
                       (wid, False))

    def _on_kill(self, wid: int, t: float) -> None:
        w = self.workers[wid]
        if not w.alive:
            return
        w.alive = False
        w.gen += 1
        if w.connected:
            w.connected = False
            self._core({"ev": "lost", "t": t, "wid": wid})
        self._push(t + self.respawn_delay, "reconnect", (wid, True))

    def _on_reconnect(self, wid: int, respawned: bool, t: float) -> None:
        w = self.workers[wid]
        if respawned:
            w.alive = True
        if not w.alive or w.connected:
            return
        w.connected = True
        w.busy_until = t
        self._core({"ev": "up", "t": t, "wid": wid,
                    "respawned": respawned})
        self._push(t + self.core.cfg.hb_interval, "worker_hb", wid)

    def _on_worker_hb(self, wid: int, t: float) -> None:
        w = self.workers[wid]
        if not w.alive or not w.connected:
            return
        self._send_down(wid, {"kind": "hb", "wid": wid}, t)
        self._push(t + self.core.cfg.hb_interval, "worker_hb", wid)

    # -- the run -------------------------------------------------------------

    def _svc_seed(self, trace: Sequence[Request]) -> dict[str, float]:
        ceilings = self.core.cfg.ceilings
        buckets = {bucket_of(min(r.k, ceilings[-1]), r.n_probe, ceilings, 1)
                   for r in trace}
        return {f"{b.k},{b.n_probe}": float(self.service_fn(b))
                for b in sorted(buckets)}

    def run(self, trace: Sequence[Request],
            settle: float = 5.0) -> list:
        """Drive the whole trace; returns outcomes in rid order.

        Client requests enter at their ``arrival`` times with
        ``deadline - arrival`` as the relative deadline; ``conn`` is 0 and
        ``crid`` is the trace rid.  ``settle`` bounds how long past the
        last event the sim keeps processing timers (heartbeats re-arm
        forever, so the loop stops once every request is terminal)."""
        trace = sorted(trace, key=lambda r: (r.arrival, r.rid))
        t0 = trace[0].arrival if trace else 0.0
        if self.transcript is not None:
            self.transcript.header = {
                "t0": t0, "n_workers": self.core.cfg.n_workers,
                "ceilings": list(self.core.cfg.ceilings),
                "wire": (self.shim.schedule.to_dict()
                         if self.shim.schedule else None)}
        self.core.start(t0)
        svc = self._svc_seed(trace)
        for w in self.workers:
            w.busy_until = t0
            w.connected = True
            self._core({"ev": "up", "t": t0, "wid": w.wid,
                        "respawned": False, "svc": svc})
            self._push(t0 + self.core.cfg.hb_interval, "worker_hb", w.wid)
        for wid, t_kill in sorted(self.kill_at.items()):
            self._push(t_kill, "kill", wid)
        for req in trace:
            self._push(req.arrival, "client_req", req)
        n_expected = len(trace)
        t_last = t0
        while self._heap:
            t, _, kind, data = heapq.heappop(self._heap)
            if len(self.core.outcomes) >= n_expected and \
                    self.core.idle():
                break
            if t > t_last + settle and len(self.core.outcomes) \
                    >= n_expected:
                break
            t_last = max(t_last, t)
            if kind == "client_req":
                req = data
                self._core({"ev": "req", "t": t, "conn": 0,
                            "crid": req.rid, "rid": req.rid, "q": req.q,
                            "k": req.k, "n_probe": req.n_probe,
                            "deadline_s": req.deadline - req.arrival})
            elif kind == "core":
                ev = dict(data)
                ev["t"] = t
                self._core(ev)
            elif kind == "deliver_up":
                self._on_deliver_up(*data, t)
            elif kind == "exec_done":
                self._on_exec_done(*data, t)
            elif kind == "deliver_down":
                self._on_deliver_down(*data, t)
            elif kind == "kill":
                self._on_kill(data, t)
            elif kind == "reconnect":
                self._on_reconnect(*data, t)
            elif kind == "worker_hb":
                self._on_worker_hb(data, t)
        if self.transcript is not None:
            self._record({"ev": "end", "t": t_last})
        return self.core.outcome_list()
