"""The share of the card's busy time that a call's probed work needs, over
the traced slice: the least time of the three stages whose work the query's
probe decides, summed over the counted calls, over the device's busy time in
them (``Trace.busy_us``).  The three are each counted as their own roofline
shares count them:

- the fused scan (``roofline.fused_scan_work``): the probed lanes' codes,
  the outputs of the probed (query, lane) pairs, the rows ranked inline;
- the codebook sample's ADC (``pass_work.sample_adc_work``): the lanes of
  each query's ``min(SAMPLE_TILES, n_probe)`` nearest clusters;
- the second pass (``pass_work.second_pass_work``): the selected rows the
  scan did not rank inline.

Nothing of a lane no query probes, or of a dense (B, n) array, is counted:
the passes over every lane of the stream (the lane mask, the scan's dense
outputs, the compaction) take the rest of the busy time.  None without a
device trace."""
from portbench import pass_work, roofline


def call_seconds(eng, n_bits: int, qs, res) -> float:
    """The least seconds of one call's probed work: the three stages'
    ``roofline.bound`` of the (B, d) queries ``qs`` and the call's
    ``SearchResult`` ``res`` on the IVF+PQ engine ``eng``."""
    from repro_torch.index.search import SAMPLE_TILES
    ivf = eng.index.ivf
    m_sub, d = eng.index.codes.shape[1], eng.index.vectors.shape[1]
    k_codes = eng.index.pq.centroids.shape[1]
    b = qs.shape[0]
    lanes, pairs = roofline.probe_counts(ivf.centroids, ivf.cluster_sizes,
                                         qs, eng.n_probe)
    scan = roofline.fused_scan_work(b, eng.n_probe, m_sub, n_bits, d, eng.m,
                                    lanes, pairs, *roofline.inline_pairs(res))
    st = min(SAMPLE_TILES, eng.n_probe)
    s_lanes, s_pairs = roofline.probe_counts(ivf.centroids,
                                             ivf.cluster_sizes, qs, st)
    sample = pass_work.sample_adc_work(b, m_sub, n_bits, k_codes,
                                       st * ivf.cap, s_lanes, s_pairs)
    second = pass_work.second_pass_work(d,
                                        *pass_work.second_pass_counts(res))
    return sum(roofline.bound(*w)[0] for w in (scan, sample, second))


def read(ctx):
    tr = ctx.profile
    if tr is None or not tr.n_calls:
        return None
    busy = tr.busy_us() * 1e-6
    if busy <= 0:
        return None
    eng = ctx.engine
    d = eng.index.vectors.shape[1]
    n_bits = int(ctx.cfg["index"]["pq_bits"])
    need = sum(call_seconds(eng, n_bits, rec.queries.reshape(-1, d),
                            rec.result)
               for rec in ctx.window.traced[-tr.n_calls:])
    return 100.0 * need / busy
