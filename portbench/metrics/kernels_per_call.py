"""Device kernels per call of the traced slice (profiler): every kernel,
the port's own and PyTorch's; copies and sets are not kernels."""


def read(ctx):
    tr = ctx.profile
    if tr is None or not tr.n_calls:
        return None
    return len(tr.kernels()) / tr.n_calls
