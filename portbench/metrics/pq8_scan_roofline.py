"""The batched fused PQ scan's share of its roofline where its LUT is staged
in chunks (``fused_scan_chunked_kernel``: a query's LUT past a block's
shared memory, as at 8-bit codes and M = 240): the least time its work
needs at the published H100 peaks (``roofline.fused_scan_work`` at the
configuration's code width: the LUT once a query, a code's bits a
sub-quantizer), summed over the counted calls, over the kernel's device
time in them (profiler).  None without a device trace or where the kernel
never ran (a whole-LUT scan, or a program without the chunked kernel)."""
from portbench import roofline

KERNEL = "fused_scan_chunked_kernel"


def read(ctx):
    tr = ctx.profile
    if tr is None or not tr.n_calls:
        return None
    seconds = roofline.kernel_seconds(tr, KERNEL)
    if seconds <= 0:
        return None
    eng = ctx.engine
    ivf = eng.index.ivf
    m_sub, d = eng.index.codes.shape[1], eng.index.vectors.shape[1]
    n_bits = int(ctx.cfg["index"]["pq_bits"])
    need = 0.0
    for rec in ctx.window.traced[-tr.n_calls:]:
        qs = rec.queries.reshape(-1, d)
        lanes, pairs = roofline.probe_counts(ivf.centroids, ivf.cluster_sizes,
                                             qs, eng.n_probe)
        rows_pred, pairs_pred = roofline.inline_pairs(rec.result)
        need += roofline.bound(*roofline.fused_scan_work(
            qs.shape[0], eng.n_probe, m_sub, n_bits, d, eng.m, lanes, pairs,
            rows_pred, pairs_pred))[0]
    return 100.0 * need / seconds
