"""Worker subprocess: one spec-built engine behind a framed socket loop.

``python -m repro_torch.transport.worker <spec.json>`` builds the engine
described by the spec (see :mod:`repro_torch.transport.enginehost`), warms up
every serving bucket while measuring service times, then DIALS the master
and serves singleton requests until told to stop:

* the worker owns the reconnect loop — capped exponential backoff, fresh
  HELLO/READY handshake on every (re)connect, so a master-side disconnect
  fault or restart heals without supervisor involvement;
* READY carries the measured ``{"k,n_probe": seconds}`` warmup times, so
  the master's service EMA (and therefore its first attempt timeouts) is
  seeded from evidence the moment the worker joins;
* heartbeats go out every ``hb_interval`` over the same wire as data —
  a stalled or partitioned worker stops beating and the master's
  ``HealthView`` sees it;
* the request boundary never kills the process: malformed frames get a
  typed ``err`` reply (or, when the stream itself is corrupt, a clean
  reconnect), engine exceptions get ``err`` with code ``exec_error``.

SIGTERM sends a best-effort ``bye`` and exits 0 (the master's drain
path); a ``bye`` from the master does the same.  On that clean exit the
worker writes the kernel launches it made while serving (``ops.LAUNCHES``,
zeroed after the warm-up) beside its spec, as
``<spec>.launches.<pid>.json``; a worker that is killed writes none.

The port's copy of the JAX package's ``transport/worker.py``.  The engine
lives on the spec's device: a spec that says ``"cuda"`` on a host without
a card raises while the worker starts, as every entry point of the port
does; it never serves from the CPU.  Its frames are the reference's, so a
port worker serves a reference master and back.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import sys
import time

import numpy as np

from repro_torch.kernels import ops
from repro_torch.serving import faults as flt
from repro_torch.transport import frames
from repro_torch.transport.enginehost import (build_state_from_spec,
                                              make_exec_fn,
                                              warmup_and_measure)


def connect_addr(addr: dict, timeout: float = 2.0) -> socket.socket:
    if addr["family"] == "unix":
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(addr["path"])
    else:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect((addr["host"], int(addr["port"])))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


class WorkerApp:
    """The serve loop, separated from ``main`` for in-test reuse."""

    def __init__(self, spec: dict):
        self.spec = dict(spec)
        self.wid = int(spec["wid"])
        self.addr = spec["addr"]
        self.codec = spec.get("codec") or frames.default_codec()
        self.hb_interval = float(spec.get("hb_interval", 0.05))
        self.reconnect_base = float(spec.get("reconnect_base", 0.05))
        self.reconnect_cap = float(spec.get("reconnect_cap", 1.0))
        self.max_dials = int(spec.get("max_dials", 0))   # 0 = keep trying
        self.stop = False
        state, self.ceilings = build_state_from_spec(spec["engine"])
        self.exec_fn = make_exec_fn(state, self.ceilings)
        self.svc = warmup_and_measure(self.exec_fn, spec["engine"],
                                      self.ceilings)
        ops.reset_launches()            # count only what serving launches
        self.served = 0

    # -- one request ---------------------------------------------------------

    def _handle_req(self, frame: dict) -> dict:
        """REQ -> RESP/ERR frame.  Every failure is a typed reply; nothing
        a client or master sends can raise out of here."""
        rid = frame.get("rid")
        if not isinstance(rid, int):
            return {"kind": frames.ERR, "rid": -1, "wid": self.wid,
                    "code": "bad_request", "detail": "missing int rid"}
        try:
            q = frames.unpack_array(frame.get("q"))
            k = int(frame["k"])
            n_probe = int(frame["n_probe"])
            if q.ndim != 1:
                raise frames.FrameError(f"query must be 1-D, got {q.shape}")
            if not (0 < k <= self.ceilings[-1]):
                raise frames.FrameError(f"k={k} outside (0, "
                                        f"{self.ceilings[-1]}]")
            if not np.all(np.isfinite(np.asarray(q, dtype=np.float64))):
                raise frames.FrameError("query has non-finite values")
        except (frames.FrameError, KeyError, TypeError, ValueError) as e:
            return {"kind": frames.ERR, "rid": rid, "wid": self.wid,
                    "code": "bad_request", "detail": str(e)}
        try:
            dists, ids = self.exec_fn(q, k, n_probe)
        except Exception as e:          # engine bug: reply, don't die
            return {"kind": frames.ERR, "rid": rid, "wid": self.wid,
                    "code": "exec_error",
                    "detail": f"{type(e).__name__}: {e}"}
        self.served += 1
        return {"kind": frames.RESP, "rid": rid, "wid": self.wid,
                "dists": frames.pack_array(dists),
                "ids": frames.pack_array(ids),
                "checksum": flt.payload_checksum(dists, ids),
                "k": k, "n_probe": n_probe}

    # -- one connection ------------------------------------------------------

    def _serve_conn(self, sock: socket.socket) -> None:
        codec = self.codec
        sock.sendall(frames.encode_frame(
            {"kind": frames.HELLO, "role": "worker", "wid": self.wid},
            codec))
        sock.sendall(frames.encode_frame(
            {"kind": frames.READY, "wid": self.wid, "svc": self.svc},
            codec))
        reader = frames.FrameReader()
        sock.settimeout(self.hb_interval / 2)
        next_hb = time.monotonic() + self.hb_interval
        while not self.stop:
            now = time.monotonic()
            if now >= next_hb:
                sock.sendall(frames.encode_frame(
                    {"kind": frames.HB, "wid": self.wid}, codec))
                next_hb = now + self.hb_interval
            try:
                data = sock.recv(65536)
            except socket.timeout:
                continue
            if not data:
                return                  # master closed: dial again
            for frame in reader.feed(data):
                kind = frame.get("kind")
                if kind == frames.REQ:
                    sock.sendall(frames.encode_frame(
                        self._handle_req(frame), codec))
                elif kind == frames.BYE:
                    self.stop = True
                    return
                # anything else from the master is ignorable chatter

    # -- the dial loop -------------------------------------------------------

    def run(self) -> int:
        dials = 0
        backoff = self.reconnect_base
        while not self.stop:
            dials += 1
            if self.max_dials and dials > self.max_dials:
                return 1
            try:
                sock = connect_addr(self.addr)
            except OSError:
                time.sleep(backoff)
                backoff = min(backoff * 2, self.reconnect_cap)
                continue
            backoff = self.reconnect_base
            try:
                self._serve_conn(sock)
            except (frames.FrameError, OSError):
                pass                    # corrupt stream / broken pipe: redial
            finally:
                try:
                    if self.stop:
                        sock.sendall(frames.encode_frame(
                            {"kind": frames.BYE, "wid": self.wid},
                            self.codec))
                except OSError:
                    pass
                sock.close()
        return 0


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print("usage: python -m repro_torch.transport.worker <spec.json>",
              file=sys.stderr)
        return 2
    with open(argv[1]) as f:
        spec = json.load(f)
    app = WorkerApp(spec)

    def _term(signum, _frame):
        app.stop = True
    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    if os.environ.get("REPRO_WORKER_EXIT_AFTER"):
        # test hook: die after N served requests (exercises the master's
        # death-detection + respawn path without raw SIGKILL races)
        limit = int(os.environ["REPRO_WORKER_EXIT_AFTER"])
        orig = app._handle_req

        def wrapped(frame):
            out = orig(frame)
            if app.served >= limit:
                os._exit(17)
            return out
        app._handle_req = wrapped
    rc = app.run()
    with open(f"{os.path.splitext(argv[1])[0]}.launches.{os.getpid()}.json",
              "w") as f:
        json.dump(ops.LAUNCHES, f)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
