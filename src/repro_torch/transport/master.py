"""Live socket driver: listener, worker supervision, wire shim, recording.

``MasterServer`` is the wall-clock shell around the pure
:class:`~repro_torch.transport.core.MasterCore`:

* ONE non-blocking listener (Unix or TCP); workers and clients both dial
  it and declare their role in a ``hello`` frame;
* worker subprocesses are spawned from the engine spec, supervised by
  polling their exit codes, and respawned on death (the reconnect itself
  is the worker's job — the supervisor only restarts dead processes);
* every frame to or from a worker crosses the :class:`WireShim`: drops,
  duplicates, seeded latency (delayed via the timer heap), truncated
  writes and forced disconnects — the transport-level extension of the
  ``serving.faults`` taxonomy, applied at the real socket boundary;
* every core event is recorded (with ``resp`` payload facts reduced to
  checksum/row-count, see :mod:`repro_torch.transport.wire`) so a live run can
  be replayed to a byte-identical ``outcome_digest``;
* graceful drain: on request (serve.py wires SIGTERM/SIGINT to it) the
  core rejects new work with ``retry_after`` frames, in-flight requests
  finish, then workers get ``bye`` and the process exits cleanly.

The loop is intentionally single-threaded: selectors + a timer heap give
deterministic-enough scheduling, and all policy lives in the core where
determinism is exact.

The port's copy of the JAX package's ``transport/master.py``, with these
changes for workers on the card.  The master builds the engine from the
spec only to read its routing centroids, and builds it in ``start`` after
spawning the workers, so that it builds alongside them and touches the
card only after the first spawn.  For a ``"cuda"`` spec it builds the
CUDA kernels once before the first spawn (``kernels._build.build_all``),
so that the workers load the libraries instead of each running ``nvcc``.
A worker runs ``python -m repro_torch.transport.worker`` with the
directory that holds ``repro_torch`` on its ``PYTHONPATH``.  ``shutdown``
sums the kernel launches that the workers report on a clean exit into
``worker_launches``.  A run dir that the master made itself is removed in
``shutdown`` (one the caller passed in is kept), and where its socket path
would pass the AF_UNIX limit the master listens on TCP localhost instead.
"""
from __future__ import annotations

import heapq
import itertools
import json
import os
import selectors
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

import repro_torch
from repro_torch.serving import faults as flt
from repro_torch.serving.clock import Clock, SystemClock
from repro_torch.transport import frames
from repro_torch.transport.core import MasterConfig, MasterCore
from repro_torch.transport.enginehost import build_state_from_spec
from repro_torch.transport.wire import Transcript, WireShim


_UNIX_PATH_MAX = 107                    # sun_path's 108 bytes, less the NUL


def unix_addr(path: str) -> dict:
    return {"family": "unix", "path": path}


def tcp_addr(host: str, port: int) -> dict:
    return {"family": "tcp", "host": host, "port": int(port)}


class _Conn:
    """Per-connection state: role, parser, write buffer."""

    def __init__(self, cid: int, sock: socket.socket):
        self.cid = cid
        self.sock = sock
        self.role: str | None = None    # None until hello; "worker"/"client"
        self.wid: int | None = None
        self.reader = frames.FrameReader()
        self.out = bytearray()
        self.closing = False            # flush remaining bytes, then close
        self.last_rx = 0.0


class MasterServer:
    """Wall-clock front-end over one :class:`MasterCore`."""

    def __init__(self, cfg: MasterConfig, spec: dict, *,
                 addr: dict | None = None, codec: str | None = None,
                 wire: flt.WireSchedule | None = None, record: bool = False,
                 clock: Clock | None = None, run_dir: str | None = None,
                 spawn_workers: bool = True, respawn: bool = True,
                 conn_idle_timeout: float = 30.0,
                 drain_timeout: float = 10.0):
        self.cfg = cfg
        self.spec = dict(spec)
        self.codec = codec or frames.default_codec()
        self.clock = clock or SystemClock()
        self._own_run_dir = run_dir is None
        self.run_dir = run_dir or tempfile.mkdtemp(prefix="repro-net-")
        os.makedirs(self.run_dir, exist_ok=True)
        if addr is None:
            path = os.path.join(self.run_dir, "master.sock")
            addr = unix_addr(path) if len(os.fsencode(path)) <= \
                _UNIX_PATH_MAX else tcp_addr("127.0.0.1", 0)
        self.addr = addr
        self.shim = WireShim(wire)
        self.spawn_workers = spawn_workers
        self.respawn = respawn
        self.conn_idle_timeout = float(conn_idle_timeout)
        self.drain_timeout = float(drain_timeout)
        # made in start(), once the workers are spawned
        self.core: MasterCore | None = None
        self.transcript = Transcript() if record else None
        self.sel = selectors.DefaultSelector()
        self.listener: socket.socket | None = None
        self.conns: dict[int, _Conn] = {}
        self._cid = itertools.count(1)
        self.worker_conn: dict[int, _Conn] = {}     # wid -> live conn
        self.procs: dict[int, subprocess.Popen] = {}
        self._respawned: set[int] = set()
        self._timers: list = []                     # (t, seq, payload)
        self._tseq = itertools.count()
        self._drain_started: float | None = None
        self.stopped = False
        # the workers' kernel launches, summed in shutdown over the reports
        # of the processes that exited cleanly
        self.worker_launches: dict[str, int] = {}
        self.worker_reports = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self.addr["family"] == "unix":
            path = self.addr["path"]
            if os.path.exists(path):
                os.unlink(path)
            self.listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.listener.bind(path)
        else:
            self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.listener.bind((self.addr["host"], self.addr["port"]))
            self.addr = tcp_addr(*self.listener.getsockname())
        self.listener.listen(64)
        self.listener.setblocking(False)
        self.sel.register(self.listener, selectors.EVENT_READ, "accept")
        if self.spawn_workers:
            if self.spec.get("device", "cuda") == "cuda":
                from repro_torch.kernels import _build
                _build.build_all()
            for wid in range(self.cfg.n_workers):
                self._spawn(wid)
        try:
            state, _ = build_state_from_spec(self.spec)
        except BaseException:
            self.shutdown()             # no worker outlives a failed start
            raise
        self.core = MasterCore(self.cfg, state.centroids)
        self.core.start(self.clock.now())
        if self.transcript is not None:
            self.transcript.header = {
                "t0": self.clock.now(), "n_workers": self.cfg.n_workers,
                "ceilings": list(self.cfg.ceilings),
                "wire": self.shim.schedule.to_dict()
                if self.shim.schedule else None}

    def _worker_spec(self, wid: int) -> dict:
        return {"wid": wid, "addr": self.addr, "codec": self.codec,
                "engine": self.spec,
                "hb_interval": self.cfg.hb_interval}

    def _spawn(self, wid: int) -> None:
        path = os.path.join(self.run_dir, f"worker{wid}.json")
        with open(path, "w") as f:
            json.dump(self._worker_spec(wid), f)
        env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (src, env.get("PYTHONPATH")) if p)
        with open(os.path.join(self.run_dir, f"worker{wid}.log"),
                  "ab") as log:
            self.procs[wid] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.transport.worker", path],
                stdout=log, stderr=log, env=env)

    # -- recording + core feed -----------------------------------------------

    def _feed(self, ev: dict) -> None:
        """Record one core event, hand it to the core, run the actions."""
        if self.transcript is not None:
            if ev["ev"] == "resp":
                entry = {k: v for k, v in ev.items()
                         if k not in ("dists", "ids")}
                entry["n_ids"] = int(len(ev["ids"]))
                entry["ck_ok"] = bool(
                    flt.payload_checksum(ev["dists"], ev["ids"])
                    == int(ev["checksum"]))
                self.transcript.append(entry)
            else:
                self.transcript.append(dict(ev))
        for act in self.core.handle(ev):
            if act[0] == "timer":
                self._push_timer(act[1], ("core", act[2]))
            elif act[0] == "reply":
                self._reply(act[1], act[2])
            elif act[0] == "send":
                self._send_worker(act[1], act[2])

    def _push_timer(self, t_at: float, payload: tuple) -> None:
        heapq.heappush(self._timers, (t_at, next(self._tseq), payload))

    # -- outbound ------------------------------------------------------------

    def _enqueue_bytes(self, conn: _Conn, data: bytes) -> None:
        conn.out.extend(data)
        try:
            self.sel.modify(conn.sock, selectors.EVENT_READ
                            | selectors.EVENT_WRITE, conn)
        except (KeyError, ValueError):
            pass

    def _reply(self, cid: int, frame: dict) -> None:
        conn = self.conns.get(cid)
        if conn is None or conn.closing:
            return
        wire_frame = dict(frame)
        for key in ("dists", "ids"):
            if isinstance(wire_frame.get(key), np.ndarray):
                wire_frame[key] = frames.pack_array(wire_frame[key])
        self._enqueue_bytes(conn, frames.encode_frame(wire_frame, self.codec))

    def _send_worker(self, wid: int, frame: dict) -> None:
        conn = self.worker_conn.get(wid)
        if conn is None or conn.closing:
            return
        wire_frame = dict(frame)
        if isinstance(wire_frame.get("q"), np.ndarray):
            wire_frame["q"] = frames.pack_array(wire_frame["q"])
        data = frames.encode_frame(wire_frame, self.codec)
        d = self.shim.decide(wid, "up")
        now = self.clock.now()
        if d.kind is not None and self.transcript is not None:
            self.transcript.append({"ev": "fault", "t": now, "wid": wid,
                                    "dir": "up", "kind": d.kind,
                                    "delay": d.delay})
        if d.kind == flt.WIRE_DROP:
            return
        if d.kind == flt.WIRE_TRUNCATE:
            try:                       # partial prefix, then a hard close
                conn.sock.send(data[:max(1, len(data) // 2)])
            except OSError:
                pass
            self._close_conn(conn, now)
            return
        if d.kind == flt.WIRE_DISCONNECT:
            self._close_conn(conn, now)
            return
        n = 2 if d.kind == flt.WIRE_DUP else 1
        for _ in range(n):
            if d.delay > 0:
                self._push_timer(now + d.delay, ("tx", wid, data))
            else:
                self._enqueue_bytes(conn, data)

    # -- inbound -------------------------------------------------------------

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self.listener.accept()
            except BlockingIOError:
                return
            sock.setblocking(False)
            if self.addr["family"] == "tcp":
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(next(self._cid), sock)
            conn.last_rx = self.clock.now()
            self.conns[conn.cid] = conn
            self.sel.register(sock, selectors.EVENT_READ, conn)

    def _close_conn(self, conn: _Conn, now: float) -> None:
        if conn.cid not in self.conns:
            return
        del self.conns[conn.cid]
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        conn.sock.close()
        conn.closing = True
        if conn.role == "worker" and \
                self.worker_conn.get(conn.wid) is conn:
            del self.worker_conn[conn.wid]
            self._feed({"ev": "lost", "t": now, "wid": conn.wid})

    def _on_readable(self, conn: _Conn) -> None:
        now = self.clock.now()
        try:
            data = conn.sock.recv(262144)
        except BlockingIOError:
            return
        except OSError:
            self._close_conn(conn, now)
            return
        if not data:
            self._close_conn(conn, now)
            return
        conn.last_rx = now
        try:
            parsed = conn.reader.feed(data)
        except frames.FrameError as e:
            # stream-level corruption: no resync point -> typed error, close
            if conn.role != "worker":
                try:
                    conn.sock.send(frames.encode_frame(
                        {"kind": frames.ERR, "rid": -1, "code": "bad_frame",
                         "detail": str(e)}, self.codec))
                except OSError:
                    pass
            self._close_conn(conn, now)
            return
        for frame in parsed:
            if conn.closing:            # a shim disconnect mid-batch
                return
            self._on_frame(conn, frame, now)

    def _on_frame(self, conn: _Conn, frame: dict, now: float) -> None:
        kind = frame.get("kind")
        if kind == frames.HELLO:
            role = frame.get("role")
            if role == "worker" and isinstance(frame.get("wid"), int) and \
                    0 <= frame["wid"] < self.cfg.n_workers:
                conn.role, conn.wid = "worker", frame["wid"]
                stale = self.worker_conn.get(conn.wid)
                if stale is not None and stale is not conn:
                    self._close_conn(stale, now)
                self.worker_conn[conn.wid] = conn
            else:
                conn.role = "client"
            return
        if conn.role == "worker":
            self._on_worker_frame(conn, frame, now)
        else:
            self._on_client_frame(conn, frame, now)

    def _on_worker_frame(self, conn: _Conn, frame: dict,
                         now: float) -> None:
        wid = conn.wid
        kind = frame.get("kind")
        if kind == frames.READY:
            self._feed({"ev": "up", "t": now, "wid": wid,
                        "respawned": wid in self._respawned,
                        "svc": frame.get("svc") or {}})
            self._respawned.discard(wid)
            return
        d = self.shim.decide(wid, "down")
        if d.kind is not None and self.transcript is not None:
            self.transcript.append({"ev": "fault", "t": now, "wid": wid,
                                    "dir": "down", "kind": d.kind,
                                    "delay": d.delay})
        if d.kind == flt.WIRE_DROP:
            return
        if d.kind in (flt.WIRE_TRUNCATE, flt.WIRE_DISCONNECT):
            self._close_conn(conn, now)
            return
        ev = self._worker_event(wid, frame, now)
        if ev is None:
            return
        reps = 2 if d.kind == flt.WIRE_DUP else 1
        for i in range(reps):
            if d.delay > 0:
                self._push_timer(now + d.delay, ("core", ev))
            else:
                e = dict(ev)
                e["t"] = self.clock.now()
                self._feed(e)

    def _worker_event(self, wid: int, frame: dict,
                      now: float) -> dict | None:
        kind = frame.get("kind")
        if kind == frames.HB:
            return {"ev": "hb", "t": now, "wid": wid}
        if kind == frames.RESP:
            try:
                dists = frames.unpack_array(frame["dists"])
                ids = frames.unpack_array(frame["ids"])
                rid = int(frame["rid"])
                checksum = int(frame["checksum"])
            except (frames.FrameError, KeyError, TypeError, ValueError):
                return None             # unusable response; timeout recovers
            return {"ev": "resp", "t": now, "wid": wid, "rid": rid,
                    "dists": dists, "ids": ids, "checksum": checksum}
        if kind == frames.ERR:
            rid = frame.get("rid")
            if not isinstance(rid, int):
                return None
            return {"ev": "werr", "t": now, "wid": wid, "rid": rid,
                    "code": str(frame.get("code", "unknown"))}
        return None

    def _on_client_frame(self, conn: _Conn, frame: dict,
                         now: float) -> None:
        kind = frame.get("kind")
        if kind == frames.BYE:
            self._close_conn(conn, now)
            return
        if kind != frames.REQ:
            self._reply(conn.cid, {"kind": frames.ERR, "rid": -1,
                                   "code": "bad_kind",
                                   "detail": f"unexpected {kind!r}"})
            return
        crid = frame.get("rid")
        if not isinstance(crid, int):
            self._reply(conn.cid, {"kind": frames.ERR, "rid": -1,
                                   "code": "bad_request",
                                   "detail": "missing int rid"})
            return
        try:
            q = frames.unpack_array(frame.get("q"))
        except frames.FrameError as e:
            self._reply(conn.cid, {"kind": frames.ERR, "rid": crid,
                                   "code": "bad_request", "detail": str(e)})
            return
        self._feed({"ev": "req", "t": now, "conn": conn.cid, "crid": crid,
                    "q": q, "k": frame.get("k"),
                    "n_probe": frame.get("n_probe"),
                    "deadline_s": frame.get("deadline_s", 1.0)})

    # -- supervision ---------------------------------------------------------

    def _poll_workers(self, now: float) -> None:
        if not self.spawn_workers:
            return
        for wid, proc in list(self.procs.items()):
            if proc.poll() is None:
                continue
            conn = self.worker_conn.get(wid)
            if conn is not None:
                self._close_conn(conn, now)
            if self.respawn and self._drain_started is None:
                self._respawned.add(wid)
                self._spawn(wid)

    def _sweep_idle(self, now: float) -> None:
        for conn in list(self.conns.values()):
            if conn.role == "worker":
                continue                # workers are health-checked by HB
            if now - conn.last_rx > self.conn_idle_timeout:
                self._close_conn(conn, now)

    # -- timers --------------------------------------------------------------

    def _fire_timers(self, now: float) -> None:
        while self._timers and self._timers[0][0] <= now:
            _, _, payload = heapq.heappop(self._timers)
            if payload[0] == "core":
                ev = dict(payload[1])
                ev["t"] = self.clock.now()
                self._feed(ev)
            elif payload[0] == "tx":
                _, wid, data = payload
                conn = self.worker_conn.get(wid)
                if conn is not None and not conn.closing:
                    self._enqueue_bytes(conn, data)

    # -- the loop ------------------------------------------------------------

    def step(self, max_wait: float = 0.05) -> None:
        """One select round: I/O, due timers, supervisor poll."""
        now = self.clock.now()
        timeout = max_wait
        if self._timers:
            timeout = min(timeout, max(self._timers[0][0] - now, 0.0))
        for key, mask in self.sel.select(timeout):
            if key.data == "accept":
                self._accept()
                continue
            conn = key.data
            if mask & selectors.EVENT_WRITE:
                self._flush(conn)
            if mask & selectors.EVENT_READ:
                self._on_readable(conn)
        now = self.clock.now()
        self._fire_timers(now)
        self._poll_workers(now)
        self._sweep_idle(now)

    def _flush(self, conn: _Conn) -> None:
        if conn.cid not in self.conns:
            return
        try:
            if conn.out:
                n = conn.sock.send(bytes(conn.out))
                del conn.out[:n]
        except BlockingIOError:
            return
        except OSError:
            self._close_conn(conn, self.clock.now())
            return
        if not conn.out:
            try:
                self.sel.modify(conn.sock, selectors.EVENT_READ, conn)
            except (KeyError, ValueError):
                pass

    def serve(self, until=None, timeout: float | None = None) -> None:
        """Run until ``until()`` is true, the drain completes, or
        ``timeout`` seconds pass."""
        t_end = None if timeout is None else self.clock.now() + timeout
        while not self.stopped:
            if until is not None and until():
                return
            if self._drain_started is not None:
                if self.core.idle() or self.clock.now() - \
                        self._drain_started > self.drain_timeout:
                    self.shutdown()
                    return
            if t_end is not None and self.clock.now() > t_end:
                return
            self.step()

    # -- drain / shutdown ----------------------------------------------------

    def drain(self) -> None:
        """Graceful: reject new requests (retriable), finish in-flight."""
        if self._drain_started is not None:
            return
        self._drain_started = self.clock.now()
        self._feed({"ev": "drain", "t": self._drain_started})
        if self.listener is not None:
            try:
                self.sel.unregister(self.listener)
            except (KeyError, ValueError):
                pass
            self.listener.close()
            self.listener = None

    def shutdown(self) -> None:
        if self.stopped:
            return
        self.stopped = True
        now = self.clock.now()
        bye = frames.encode_frame({"kind": frames.BYE}, self.codec)
        for wid, conn in list(self.worker_conn.items()):
            try:
                conn.sock.send(bye)
            except OSError:
                pass
        # flush best-effort, then close everything
        deadline = time.monotonic() + 0.5
        while any(c.out for c in self.conns.values()) and \
                time.monotonic() < deadline:
            for conn in list(self.conns.values()):
                self._flush(conn)
        for conn in list(self.conns.values()):
            self._close_conn(conn, now)
        if self.listener is not None:
            self.listener.close()
            self.listener = None
        for wid, proc in self.procs.items():
            if proc.poll() is None:
                proc.terminate()
        for wid, proc in self.procs.items():
            try:
                proc.wait(timeout=3.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=3.0)
        self.sel.close()
        self._collect_launches()
        if self._own_run_dir:
            shutil.rmtree(self.run_dir, ignore_errors=True)

    def _collect_launches(self) -> None:
        """Sum the launch counts the workers wrote on a clean exit."""
        try:
            names = sorted(os.listdir(self.run_dir))
        except OSError:
            return
        for name in names:
            if not (name.startswith("worker") and ".launches." in name):
                continue
            try:
                with open(os.path.join(self.run_dir, name)) as f:
                    counts = json.load(f)
            except (OSError, ValueError):
                continue
            self.worker_reports += 1
            for k, v in counts.items():
                self.worker_launches[k] = \
                    self.worker_launches.get(k, 0) + int(v)

    # -- convenience ---------------------------------------------------------

    def wait_workers(self, timeout: float = 60.0) -> bool:
        """Serve until every worker has connected and sent READY."""
        t_end = self.clock.now() + timeout

        def ready():
            return all(w.connected for w in self.core.workers) or \
                self.clock.now() > t_end
        self.serve(until=ready)
        return all(w.connected for w in self.core.workers)
