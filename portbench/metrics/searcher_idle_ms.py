"""Device idle time while the host is in the engine's and searcher's stages
(``engine.*``, ``pq.*``, ``rabitq.route``, ``rabitq.sample``,
``rabitq.scan``), their ``wait.*`` spans excluded, in ms per counted call:
the program's stage spans over the profiler's idle gaps
(``portbench/stages.py``)."""
from portbench import stages


def read(ctx):
    st = stages.read(ctx)
    return None if st is None else st.per_call_ms(st.idle_us, "searcher")
