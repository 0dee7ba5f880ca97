"""Record/replay transcript + the seeded wire-fault shim's bookkeeping.

The replay contract: a live socket run is fully described by the ordered
sequence of *core events* its driver processed — request arrivals,
response facts, heartbeats, timer firings, connection losses — each with
the wall timestamp it was handled at.  ``MasterCore`` is pure over that
sequence, so feeding the recorded events into a fresh core reproduces
every decision, every outcome, and the exact ``outcome_digest``.

What the transcript does NOT store is response payloads: a ``resp`` entry
keeps only the integrity checksum (plus rid/wid/k facts).  Replay
re-executes each response through the in-process engine and verifies the
recorded checksum — so digest equality is a genuine end-to-end
determinism check on the worker's wire bytes (same spec-built engine in a
different process produced the same payload), not a tautology of copying
payloads around.

Wire-fault decisions are recorded as informational ``fault`` entries:
replay never re-decides faults (their *consequences* — the dropped frame
that never became an event, the delayed delivery timestamp — are already
baked into the event sequence), but the entries document what the run was
subjected to and let tests assert the schedule actually fired.

Format: JSON lines — one header object, then one object per entry.
ndarrays (request vectors) are stored as dtype + shape + base64 bytes and
round-trip bit-exactly.

The port's copy of the JAX package's ``transport/wire.py``:
``Transcript.save`` writes the reference's text for the same entries, so
either package loads the other's transcripts.
"""
from __future__ import annotations

import base64
import json
from typing import Any, Iterable

import numpy as np

from repro_torch.serving.faults import WireDecision, WireSchedule

# core-event kinds replay feeds back into MasterCore; anything else in a
# transcript ("fault", "end") is documentation
CORE_EVENTS = ("req", "resp", "werr", "hb", "timeout", "retry", "expire",
               "lost", "up", "drain")


def _ser(obj: Any) -> Any:
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        return {"__nd__": {"dtype": arr.dtype.name,
                           "shape": list(arr.shape),
                           "b64": base64.b64encode(arr.tobytes()).decode()}}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, dict):
        return {k: _ser(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_ser(v) for v in obj]
    return obj


def _deser(obj: Any) -> Any:
    if isinstance(obj, dict):
        nd = obj.get("__nd__")
        if nd is not None and set(obj) == {"__nd__"}:
            return np.frombuffer(
                base64.b64decode(nd["b64"]),
                dtype=np.dtype(nd["dtype"])).reshape(nd["shape"])
        return {k: _deser(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_deser(v) for v in obj]
    return obj


class Transcript:
    """Ordered record of one live run (header + entries)."""

    def __init__(self, header: dict | None = None):
        self.header = dict(header or {})
        self.entries: list[dict] = []

    def __len__(self) -> int:
        return len(self.entries)

    def append(self, entry: dict) -> None:
        """Record one entry.  ``resp`` entries are stripped of their
        payload arrays here (see module docstring) — recording is the one
        place the stripping rule lives."""
        if entry.get("ev") == "resp":
            entry = {k: v for k, v in entry.items()
                     if k not in ("dists", "ids")}
        self.entries.append(entry)

    def core_events(self) -> Iterable[dict]:
        return (e for e in self.entries if e.get("ev") in CORE_EVENTS)

    def fault_entries(self) -> list[dict]:
        return [e for e in self.entries if e.get("ev") == "fault"]

    # -- persistence ---------------------------------------------------------

    def dumps(self) -> str:
        lines = [json.dumps(_ser(self.header), sort_keys=True)]
        lines.extend(json.dumps(_ser(e), sort_keys=True)
                     for e in self.entries)
        return "\n".join(lines) + "\n"

    @classmethod
    def loads(cls, text: str) -> "Transcript":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty transcript")
        t = cls(header=_deser(json.loads(lines[0])))
        t.entries = [_deser(json.loads(ln)) for ln in lines[1:]]
        return t

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def load(cls, path: str) -> "Transcript":
        with open(path) as f:
            return cls.loads(f.read())


class WireShim:
    """Per-link frame counters over a :class:`WireSchedule`.

    The schedule's decisions are keyed by the per-(worker, direction)
    frame sequence number; this object owns those counters so every frame
    crossing the shim consumes exactly one decision — the invariant that
    makes live runs reproducible under timing jitter.  A ``None`` schedule
    is the fault-free shim (every decision is clean delivery)."""

    def __init__(self, schedule: WireSchedule | None = None):
        self.schedule = schedule
        self._seq: dict[tuple[int, str], int] = {}
        self.decisions: list[tuple[int, str, int, str, float]] = []

    def decide(self, wid: int, direction: str) -> WireDecision:
        seq = self._seq.get((wid, direction), 0)
        self._seq[(wid, direction)] = seq + 1
        if self.schedule is None:
            return WireDecision()
        d = self.schedule.decide(wid, direction, seq)
        if d.kind is not None:
            self.decisions.append((wid, direction, seq, d.kind, d.delay))
        return d

    def fault_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for _, _, _, kind, _ in self.decisions:
            out[kind] = out.get(kind, 0) + 1
        return out
