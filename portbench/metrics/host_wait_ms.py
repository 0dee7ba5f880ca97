"""Host time inside the program's ``wait.*`` spans, the reads that block
until the device has caught up (the card setting the pace), in ms per
counted call (``portbench/stages.py``)."""
from portbench import stages


def read(ctx):
    st = stages.read(ctx)
    return None if st is None else st.per_call_ms(st.self_us, "wait")
