"""Device idle time while the host is in the collector's and re-rank's
stages (``collect``, ``rabitq.band``, ``rerank.*``, ``select``), their
``wait.*`` spans excluded, in ms per counted call
(``portbench/stages.py``)."""
from portbench import stages


def read(ctx):
    st = stages.read(ctx)
    return None if st is None else st.per_call_ms(st.idle_us, "collector")
