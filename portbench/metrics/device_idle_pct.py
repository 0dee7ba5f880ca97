"""Share of the traced slice in which nothing ran on the card (profiler):
100 * (1 - the union of the device's operations / the slice's wall time)."""


def read(ctx):
    tr = ctx.profile
    if tr is None or not tr.n_calls or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
