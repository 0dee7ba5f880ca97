"""Replay driver: transcript -> fresh MasterCore -> byte-identical digest.

Replay feeds a recorded run's ordered core events into a brand-new
:class:`~repro_torch.transport.core.MasterCore`.  Because the core is pure over
its event sequence, every routing choice, retry, rejection, cache hit and
outcome is reproduced exactly — ``outcome_digest`` over the replayed
outcomes must equal the live run's digest byte for byte.

Response payloads are NOT in the transcript (see
:mod:`repro_torch.transport.wire`): each ``resp`` event is re-executed through
an in-process ``exec_fn`` built from the same engine spec the workers
used, and the recomputed payload checksum is verified against the
recorded one.  A mismatch means the engine is not deterministic across
processes — exactly the failure this contract exists to catch — and
raises :class:`ReplayError` under ``strict`` (the default).

Two recorded facts stand in for the missing payload when re-execution
must NOT produce a clean response:

* ``ck_ok`` — whether the live payload matched its checksum;
* ``n_ids`` — the live payload's row count.

When either says the live core took the corrupt-response path, replay
feeds a synthetic payload engineered to fail verification the same way,
so the replayed core's control flow tracks the live one exactly.

The port's copy of the JAX package's ``transport/replay.py``.  A replay
is bitwise only within one framework and one device type: the port's
``exec_fn`` on the card reproduces the card's payloads, not the JAX
package's (see ``enginehost``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.serving import faults as flt
from repro_torch.serving.router import outcome_digest
from repro_torch.transport.core import MasterConfig, MasterCore
from repro_torch.transport.wire import Transcript


class ReplayError(RuntimeError):
    """Replayed execution diverged from the recorded run."""


@dataclass
class ReplayResult:
    core: MasterCore
    outcomes: list
    replies: list[tuple[int, dict]]
    digest: str
    checksum_mismatches: list[tuple[int, int, int]] = field(
        default_factory=list)          # (rid, recorded, recomputed)


def _corrupt_stand_in(n_ids: int, want_k: int) -> tuple:
    """A payload guaranteed to fail the core's response verification."""
    n = max(int(n_ids), 1)
    dists = np.zeros(n, dtype=np.float32)
    ids = np.zeros(n, dtype=np.int64)
    ck = flt.payload_checksum(dists, ids)
    if n == int(want_k):               # length passes -> break the checksum
        ck = (ck + 1) & 0xFFFFFFFF
    return dists, ids, ck


def replay_transcript(transcript: Transcript, cfg: MasterConfig,
                      centroids: np.ndarray, exec_fn, *,
                      strict: bool = True) -> ReplayResult:
    """Run the recorded event sequence through a fresh core.

    ``exec_fn(q, k, n_probe) -> (dists, ids)`` must be built from the same
    engine spec as the live workers (see
    :func:`repro_torch.transport.enginehost.make_exec_fn`).
    """
    core = MasterCore(cfg, centroids)
    core.start(float(transcript.header.get("t0", 0.0)))
    replies: list[tuple[int, dict]] = []
    mismatches: list[tuple[int, int, int]] = []
    for recorded in transcript.core_events():
        ev = dict(recorded)
        if ev["ev"] == "resp":
            rid = ev["rid"]
            track = core._tracks.get(rid)
            if track is None or track.done:
                # late/duplicate delivery: the core ignores the payload
                # before touching it, so any stand-in works
                ev["dists"] = np.zeros(1, dtype=np.float32)
                ev["ids"] = np.zeros(1, dtype=np.int64)
            else:
                want_k = track.req.k
                accepted = bool(ev.get("ck_ok")) and \
                    int(ev.get("n_ids", -1)) == want_k
                if accepted:
                    dists, ids = exec_fn(track.req.q, want_k,
                                         track.req.n_probe)
                    ck = flt.payload_checksum(dists, ids)
                    if ck != int(ev["checksum"]):
                        mismatches.append((rid, int(ev["checksum"]), ck))
                        if strict:
                            raise ReplayError(
                                f"rid {rid}: replayed payload checksum "
                                f"{ck} != recorded {ev['checksum']} — "
                                f"engine is not deterministic across "
                                f"processes")
                    # feed the recomputed checksum so the replayed core
                    # accepts, matching the live control flow even when a
                    # non-strict mismatch is being tolerated
                    ev["dists"], ev["ids"], ev["checksum"] = dists, ids, ck
                else:
                    dists, ids, ck = _corrupt_stand_in(
                        ev.get("n_ids", 1), want_k)
                    ev["dists"], ev["ids"], ev["checksum"] = dists, ids, ck
        for act in core.handle(ev):
            if act[0] == "reply":
                replies.append((act[1], act[2]))
            # "send"/"timer" actions are not re-driven: their consequences
            # (the response that came back, the timer that fired) are
            # already events later in the transcript
    outcomes = core.outcome_list()
    return ReplayResult(core=core, outcomes=outcomes, replies=replies,
                        digest=outcome_digest(outcomes),
                        checksum_mismatches=mismatches)
