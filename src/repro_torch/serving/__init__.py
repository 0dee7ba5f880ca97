"""Async micro-batching serving (queue -> admission -> batcher -> engine):
``server.Server`` is the single-engine composition root, and
``router.ReplicaServer`` the fault-tolerant multi-replica tier over it
(``replica`` pools, ``health`` views, ``faults`` schedules, affinity
routing with retries, hedges and supervisor respawn)."""
from repro_torch.serving.admission import (ACCEPT, DEGRADE, SHED,  # noqa: F401
                                           AdmissionController, Decision,
                                           DegradeLadder, ServiceEMA)
from repro_torch.serving.batcher import (Batch, MicroBatcher,  # noqa: F401
                                         ShapeBucket, assemble, bucket_of,
                                         k_ceilings)
from repro_torch.serving.clock import (Clock, ManualClock,  # noqa: F401
                                       SystemClock)
from repro_torch.serving.queue import (Request, RequestQueue,  # noqa: F401
                                       bursty_arrivals, make_trace,
                                       make_zipf_trace, poisson_arrivals,
                                       zipf_query_ids)
from repro_torch.serving.server import (Outcome, Server,  # noqa: F401
                                        parity_vs_direct, summarize,
                                        trim_topk)
from repro_torch.serving.state import ServingState  # noqa: F401
from repro_torch.serving.faults import (Fault, FaultSchedule,  # noqa: F401
                                        WireDecision, WireSchedule)
from repro_torch.serving.health import HealthView  # noqa: F401
from repro_torch.serving.replica import (Replica, ReplicaPool,  # noqa: F401
                                         ReplicaResponse, WorkingSet)
from repro_torch.serving.router import (HedgePolicy,  # noqa: F401
                                        ReplicaServer, RetryPolicy, Router,
                                        outcome_digest)
