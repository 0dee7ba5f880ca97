"""The bound-fused RaBitQ scan's (#5, ``rabitq_fused_kernel``) share of its
roofline over the traced slice: the least time its work needs at the
published H100 peaks (``roofline.rabitq_scan_work``), summed over the
counted calls, over the kernel's device time in them (profiler)."""
from portbench import roofline

KERNEL = "rabitq_fused_kernel"


def read(ctx):
    tr = ctx.profile
    if tr is None or not tr.n_calls:
        return None
    seconds = roofline.kernel_seconds(tr, KERNEL)
    if seconds <= 0:
        return None
    eng = ctx.engine
    ivf = eng.index.ivf
    d = eng.index.vectors.shape[1]
    need = 0.0
    for rec in ctx.window.traced[-tr.n_calls:]:
        qs = rec.queries.reshape(-1, d)
        lanes, pairs = roofline.probe_counts(ivf.centroids, ivf.cluster_sizes,
                                             qs, eng.n_probe)
        rows_cert, pairs_cert = roofline.inline_pairs(rec.result)
        need += roofline.bound(*roofline.rabitq_scan_work(
            qs.shape[0], eng.n_probe, d, ivf.n_clusters, eng.m, lanes,
            pairs, rows_cert, pairs_cert))[0]
    return 100.0 * need / seconds
