"""Async micro-batching serving (queue -> admission -> batcher -> engine)
on one process and one device; see ``server.Server`` for the composition
root.  The reference's replica tier, router, fault schedules and health
view (ROADMAP.md queue 1, item 12) are not ported yet."""
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
                                       poisson_arrivals)
from repro_torch.serving.server import (Outcome, Server,  # noqa: F401
                                        parity_vs_direct, summarize,
                                        trim_topk)
from repro_torch.serving.state import ServingState  # noqa: F401
