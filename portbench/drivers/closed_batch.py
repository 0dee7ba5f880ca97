"""Closed loop: one caller sends a host tensor of ``traffic["batch"]``
queries, (batch, d), or with ``batch`` 0 one (d,) query, waits for the
answer, and sends the next."""
from portbench import loop


def supply(cfg, x_np, seed, traffic, stream) -> loop.Supply:
    return loop.Supply(cfg, x_np, seed, int(traffic["batch"]),
                       int(traffic["chunk"]), stream=stream)


def run_window(ctx) -> loop.Window:
    return loop.closed_loop(ctx.engine.search, ctx.supply, ctx.seconds,
                            ctx.sync, ctx.reservoir, trace=ctx.trace,
                            profiler_factory=ctx.profiler_factory)
