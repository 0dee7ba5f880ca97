"""The share of the (query, lane) pairs the fused scan's grid covers that
the routing probed, in %: the program's ``scan.pairs_probed`` over its
``scan.pairs_passed``, summed over the counted calls
(``portbench/counters.py``).  A scan that walks only the probed lanes
reads 100."""
from portbench import counters


def read(ctx):
    c = counters.read(ctx)
    if c is None or not c.totals.get(counters.PASSED) \
            or counters.PROBED not in c.totals:
        return None
    return 100.0 * c.totals[counters.PROBED] / c.totals[counters.PASSED]
