"""Multi-process serving front end of the port: real sockets under the
replica tier's policy.

The discrete-event tier (``repro_torch.serving``) owns the serving
*policy*: admission, routing, health, retries, degradation.  This package
owns the *mechanism*: a master process speaking length-prefixed
msgpack-or-JSON frames over TCP / Unix sockets to N worker subprocesses,
each serving from its own engine on the card, with bounded queues and
explicit backpressure, per-connection timeouts, capped-backoff
reconnects, heartbeats over the real wire, worker respawn, a seeded
wire-fault shim, and a record/replay transcript that keeps
``outcome_digest`` byte-identical between a live socket run and its
in-process replay.  It is the JAX package's ``repro.transport``, module
for module; the frames, transcripts and core decisions are byte-identical
to the reference's, so a port worker serves a reference master and back.

Layering (each module usable without the ones after it):

* ``frames``  — wire format: length-prefixed frames, codecs, array packing
* ``cache``   — exact-key LRU result + routing caches (the Zipf head)
* ``core``    — :class:`MasterCore`, the pure event-driven master state
  machine (never reads a clock; all decisions from event timestamps)
* ``wire``    — the transcript format + shim bookkeeping shared by the
  live driver, the simulator, and replay
* ``sim``     — a virtual-clock loopback driver over ``MasterCore`` for
  deterministic fuzz / property tests (no processes, no sockets)
* ``enginehost`` — the spec-built engine every process serves from
* ``worker``  — the worker subprocess: spec-built engine behind a framed
  request loop (``python -m repro_torch.transport.worker``)
* ``master``  — the live socket driver: selectors loop, supervisor,
  fault shim, recording
* ``replay``  — feed a recorded transcript back through ``MasterCore``
  with payload re-execution + checksum verification
* ``client``  — a small framed client used by the tests, ``chip_smoke.py``
  and ``launch/serve.py --mode net``
"""
from repro_torch.transport.cache import LruCache, ResultCache  # noqa: F401
from repro_torch.transport.core import MasterCore, MasterConfig  # noqa: F401
from repro_torch.transport.frames import (FrameError,  # noqa: F401
                                          FrameReader, encode_frame,
                                          pack_array, unpack_array)
from repro_torch.transport.replay import (ReplayError,  # noqa: F401
                                          replay_transcript)
from repro_torch.transport.sim import LoopbackSim  # noqa: F401
from repro_torch.transport.wire import Transcript, WireShim  # noqa: F401

# enginehost / worker / master / client import torch and sockets; their
# users import them by name, so this package stays light
