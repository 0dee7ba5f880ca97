"""Framed client: connect, pace a trace open-loop, collect typed replies.

``NetClient`` is the bench's and the tests' view of the serving front
door.  ``run_trace`` sends requests at their trace arrival offsets
(open-loop — a slow server does NOT slow the offered load, which is what
makes the backpressure path real) while draining replies concurrently,
and returns one record per request: completed payloads with client-side
latency, ``retry_after`` rejections with their suggested delay, and typed
errors.  Nothing here retries — the master already owns retries against
workers; client-side retry policy belongs to real applications, and the
bench wants to SEE rejections, not paper over them.

The port's copy of the JAX package's ``transport/client.py``; it speaks
to either package's master.
"""
from __future__ import annotations

import select
import socket
import time

import numpy as np

from repro_torch.transport import frames
from repro_torch.transport.worker import connect_addr


class NetClient:
    def __init__(self, addr: dict, codec: str | None = None,
                 timeout: float = 10.0):
        self.addr = addr
        self.codec = codec or frames.default_codec()
        self.timeout = float(timeout)
        self.sock: socket.socket | None = None
        self.reader = frames.FrameReader()
        self._queued: list[dict] = []
        self._eof = False

    def connect(self) -> "NetClient":
        self.sock = connect_addr(self.addr, timeout=self.timeout)
        self.sock.sendall(frames.encode_frame(
            {"kind": frames.HELLO, "role": "client"}, self.codec))
        return self

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.sendall(frames.encode_frame(
                    {"kind": frames.BYE}, self.codec))
            except OSError:
                pass
            self.sock.close()
            self.sock = None

    def __enter__(self) -> "NetClient":
        return self.connect()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- low level -----------------------------------------------------------

    def send_raw(self, data: bytes) -> None:
        """Test hook: put arbitrary bytes on the wire (fuzzing)."""
        self.sock.sendall(data)

    def send_request(self, rid: int, q: np.ndarray, k: int, n_probe: int,
                     deadline_s: float) -> None:
        self.sock.sendall(frames.encode_frame(
            {"kind": frames.REQ, "rid": int(rid),
             "q": frames.pack_array(np.ascontiguousarray(q)),
             "k": int(k), "n_probe": int(n_probe),
             "deadline_s": float(deadline_s)}, self.codec))

    def _drain(self, wait: float) -> list[dict]:
        """Read whatever arrives within ``wait`` seconds (may be [])."""
        out: list[dict] = []
        if self._eof:
            raise ConnectionError("server closed the connection")
        end = time.monotonic() + max(wait, 0.0)
        while True:
            remaining = end - time.monotonic()
            r, _, _ = select.select([self.sock], [], [], max(remaining, 0.0))
            if not r:
                return out
            data = self.sock.recv(262144)
            if not data:
                # frames parsed just before the close must not be lost —
                # a typed error followed by EOF is the bad_frame contract
                self._eof = True
                if out:
                    return out
                raise ConnectionError("server closed the connection")
            out.extend(self.reader.feed(data))
            # return as soon as a whole frame is ready: callers poll in a
            # loop, and holding a parsed reply for the rest of the window
            # would add the full window to every round trip
            if out or remaining <= 0:
                return out

    def recv_reply(self, timeout: float | None = None) -> dict | None:
        """Block for one frame (or until ``timeout``)."""
        if self._queued:
            return self._queued.pop(0)
        end = time.monotonic() + (timeout if timeout is not None
                                  else self.timeout)
        while True:
            got = self._drain(end - time.monotonic())
            if got:
                self._queued.extend(got[1:])
                return got[0]
            if time.monotonic() >= end:
                return None

    # -- trace driving -------------------------------------------------------

    def run_trace(self, trace, *, settle: float = 15.0) -> dict[int, dict]:
        """Open-loop paced send of a ``serving.queue`` Request trace.

        Returns ``{rid: record}`` where record is one of::

            {"status": "ok"|"degraded", "ids", "dists", "cached",
             "latency_s"}
            {"status": "rejected", "delay_s", "reason"}
            {"status": "error", "code", "detail"}
        """
        trace = sorted(trace, key=lambda r: (r.arrival, r.rid))
        t_base = trace[0].arrival if trace else 0.0
        records: dict[int, dict] = {}
        sent_at: dict[int, float] = {}
        start = time.monotonic()

        def handle(frame: dict) -> None:
            rid = frame.get("rid")
            kind = frame.get("kind")
            now = time.monotonic()
            if kind == frames.RESP:
                records[rid] = {
                    "status": str(frame.get("status", "ok")),
                    "ids": frames.unpack_array(frame["ids"]),
                    "dists": frames.unpack_array(frame["dists"]),
                    "cached": bool(frame.get("cached", False)),
                    "latency_s": now - sent_at.get(rid, start)}
            elif kind == frames.RETRY_AFTER:
                records[rid] = {"status": "rejected",
                                "delay_s": float(frame.get("delay_s", 0.0)),
                                "reason": str(frame.get("reason", ""))}
            elif kind == frames.ERR:
                records[rid] = {"status": "error",
                                "code": str(frame.get("code", "unknown")),
                                "detail": str(frame.get("detail", ""))}

        for req in trace:
            target = start + (req.arrival - t_base)
            while True:
                wait = target - time.monotonic()
                if wait <= 0:
                    break
                for frame in self._drain(min(wait, 0.05)):
                    handle(frame)
            sent_at[req.rid] = time.monotonic()
            self.send_request(req.rid, req.q, req.k, req.n_probe,
                              req.deadline - req.arrival)
        end = time.monotonic() + settle
        while len(records) < len(trace) and time.monotonic() < end:
            for frame in self._drain(0.1):
                handle(frame)
        return records
