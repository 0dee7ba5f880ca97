"""Device time of the operations launched from the collector's and
re-rank's stages (the sorts, compactions and gathers of the collection,
the second pass and the final selection), in ms per counted call
(``portbench/stages.py``)."""
from portbench import stages


def read(ctx):
    st = stages.read(ctx)
    return None if st is None else st.per_call_ms(st.device_us, "collector")
