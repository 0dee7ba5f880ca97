"""Exact distance computations per query (``SearchResult.n_reranked``),
the mean over the traced slice's queries: the collector and re-rank
layer's work."""
import torch


def read(ctx):
    recs = ctx.window.traced if ctx.window is not None else []
    if not recs:
        return None
    counts = torch.cat([r.result.n_reranked.reshape(-1).to(torch.float64)
                        for r in recs])
    return float(counts.mean().item())
