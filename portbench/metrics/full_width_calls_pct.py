"""The share of the counted calls, in %, in which the program took a
full-width fall-back: the PQ collector's widened compaction
(``collect.widened``), RaBitQ's dense straggler pass
(``rerank.dense_stragglers``) or its full-width selection
(``select.full_width``) (``portbench/counters.py``)."""
from portbench import counters


def read(ctx):
    c = counters.read(ctx)
    if c is None or not c.calls:
        return None
    return 100.0 * c.full_width_calls / c.calls
