"""The codebook sample's ADC (``pq_sample_adc_kernel``) share of its
roofline over the traced slice: the least time its work needs at the
published H100 peaks (``pass_work.sample_adc_work``), summed over the
counted calls, over the kernel's device time in them (profiler).  The
sampled lanes are those of each query's ``min(SAMPLE_TILES, n_probe)``
nearest clusters, the searcher's own sample.  None without a device trace
or where the kernel never ran."""
from portbench import pass_work, roofline

KERNEL = "pq_sample_adc_kernel"


def read(ctx):
    tr = ctx.profile
    if tr is None or not tr.n_calls:
        return None
    seconds = roofline.kernel_seconds(tr, KERNEL)
    if seconds <= 0:
        return None
    from repro_torch.index.search import SAMPLE_TILES
    eng = ctx.engine
    ivf = eng.index.ivf
    m_sub, d = eng.index.codes.shape[1], eng.index.vectors.shape[1]
    k_codes = eng.index.pq.centroids.shape[1]
    n_bits = int(ctx.cfg["index"]["pq_bits"])
    st = min(SAMPLE_TILES, eng.n_probe)
    need = 0.0
    for rec in ctx.window.traced[-tr.n_calls:]:
        qs = rec.queries.reshape(-1, d)
        lanes, pairs = roofline.probe_counts(ivf.centroids,
                                             ivf.cluster_sizes, qs, st)
        need += roofline.bound(*pass_work.sample_adc_work(
            qs.shape[0], m_sub, n_bits, k_codes, st * ivf.cap, lanes,
            pairs))[0]
    return 100.0 * need / seconds
