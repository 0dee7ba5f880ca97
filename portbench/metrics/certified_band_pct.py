"""The share of the greedy bounded re-rank's band, in %, that the scan's
inline exact leg certified (Alg. 3's first phase): 100 x the sum of
``n_reranked - n_second_pass`` over the sum of ``n_reranked``, over the
counted calls' queries (``SearchResult``'s work counters).  It falls where
work moves from the scan to the straggler pass."""


def read(ctx):
    tr, win = ctx.profile, ctx.window
    if tr is None or not tr.n_calls or win is None or not win.traced:
        return None
    band = certified = 0
    for rec in win.traced[-tr.n_calls:]:
        reranked = int(rec.result.n_reranked.sum().item())
        band += reranked
        certified += reranked - int(rec.result.n_second_pass.sum().item())
    return 100.0 * certified / band if band else None
