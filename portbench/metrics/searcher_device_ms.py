"""Device time of the operations launched from the engine's and searcher's
stages (routing, stream gather, tables, sample and plan), the scan kernels
(``fused_scan_kernel``, ``rabitq_fused_kernel``) excluded, in ms per
counted call (``portbench/stages.py``)."""
from portbench import stages


def read(ctx):
    st = stages.read(ctx)
    return None if st is None else st.per_call_ms(st.device_us, "searcher")
