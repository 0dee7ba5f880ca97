"""The share of the row tiles RaBitQ's masked straggler pass staged, in %:
the program's ``rerank.straggler_tiles_read`` (the 128-row tiles in which
some query of a round of 32 has a straggler) over its
``rerank.straggler_tiles`` (every tile of every round), summed over the
counted calls that took the pass (``portbench/counters.py``).  A dense
pass over every row reads 100.  None where no counted call recorded them:
a program without the masked pass, or calls that gathered their
stragglers under the budget."""
from portbench import counters

READ, TILES = "rerank.straggler_tiles_read", "rerank.straggler_tiles"


def read(ctx):
    c = counters.read(ctx)
    if c is None or not c.totals.get(TILES) or READ not in c.totals:
        return None
    return 100.0 * c.totals[READ] / c.totals[TILES]
