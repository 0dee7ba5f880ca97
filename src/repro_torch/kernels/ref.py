"""Plain PyTorch versions of the port's kernels.

Each function mirrors the same-named oracle in the JAX package's
``kernels/ref.py`` and is the CPU path behind ``kernels.ops``.  On the card
``chip_smoke.py`` holds each CUDA kernel against these on the same inputs.

Summation order is part of the contract.  The ADC sum runs over the
sub-quantizers in ascending order in fp32, exactly as the CUDA kernels add
it, so a CPU and a CUDA run of the port give bit-identical estimates and
therefore identical bucket ids, histograms, thresholds and selections.  The
exact distances, the RaBitQ code products and bounds come from
``core/numerics.py``, which fixes their order of operations the same way.
"""
from __future__ import annotations

import math

import torch

from repro_torch import spans
from repro_torch.core import numerics

INF = float("inf")
EXACT_CHUNK = 1 << 18     # (query, slot) entries per exact-distance gather
                          # (128 MB of fp32 rows at d=128; fewer chunks,
                          # fewer launches of the fixed-order sum)


def pq_adc_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """(n, M) shared codes + (B, M, K) per-query LUTs -> (B, n) squared
    estimates, summed over m in ascending order."""
    idx = codes.long()
    acc = luts[:, 0, :][:, idx[:, 0]]
    for m in range(1, codes.shape[1]):
        acc = acc + luts[:, m, :][:, idx[:, m]]
    return acc


def pq_sample_adc_batch(codes: torch.Tensor, luts: torch.Tensor,
                        pos: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """(n, M) shared codes, (B, M, K) per-query LUTs and per-query lanes
    ``pos`` (B, w) (stream positions) with ``ok`` (B, w) -> (B, w) squared
    estimates of the rows ``pos``, summed over m in ascending order, +inf
    off ``ok``: the codebook sample's ADC."""
    sc = codes[pos]                                          # (B, w, M)
    acc = torch.gather(luts[:, 0, :], 1, sc[:, :, 0].long())
    for m in range(1, sc.shape[2]):
        acc = acc + torch.gather(luts[:, m, :], 1, sc[:, :, m].long())
    return torch.where(ok, acc, INF)


def bucketize_batch(dists: torch.Tensor, d_min: torch.Tensor,
                    delta: torch.Tensor, ew_maps: torch.Tensor,
                    m: int) -> torch.Tensor:
    """(B, n) distances, per-query codebook params -> (B, n) Eq. 6 bucket ids,
    with overflow bucket ``m``.  A NaN bin (a NaN distance, +inf against a
    d_min of +inf, or 0 / 0 where delta is 0) maps to bin 0, as the JAX
    oracle's conversion and the kernels' ``bbc::bucket_of`` map it."""
    n_ew = ew_maps.shape[1]
    bin_f = torch.floor((dists - d_min[:, None]) / delta[:, None])
    overflow = bin_f >= n_ew
    bin_id = torch.nan_to_num(bin_f, nan=0.0).clamp(0, n_ew - 1).long()
    bucket = torch.gather(ew_maps.long(), 1, bin_id)
    return torch.where(overflow, m, bucket).to(torch.int32)


def histogram_batch(bucket: torch.Tensor, valid: torch.Tensor,
                    m: int) -> torch.Tensor:
    """(B, m+1) int32 counts of the valid lanes per bucket."""
    hist = torch.zeros(bucket.shape[0], m + 1, dtype=torch.int64,
                       device=bucket.device)
    hist.scatter_add_(1, bucket.long(), valid.to(torch.int64))
    return hist.to(torch.int32)


def bucket_hist_batch(dists: torch.Tensor, valid: torch.Tensor,
                      d_min: torch.Tensor, delta: torch.Tensor,
                      ew_maps: torch.Tensor, m: int):
    """Batched Eq. 6 + histogram.  Returns (bucket (B, n), hist (B, m+1))."""
    bucket = bucketize_batch(dists, d_min, delta, ew_maps, m)
    return bucket, histogram_batch(bucket, valid, m)


def codebook_from_topk(topk: torch.Tensor, m: int, n_ew: int = 256):
    """Equal-depth codebooks from ascending local top-k rows (B, k):
    returns (edges (B, m+1), d_min (B,), delta (B,), ew_map (B, n_ew)
    int32), the fields of ``buffer.BucketCodebook``.

    +inf entries (fewer valid lanes than k) are clamped to the row's largest
    finite value; a row with none falls back to an all-zero range.  The
    range keeps a 2% margin above d_max and the edges are made strictly
    increasing, exactly as the reference does."""
    dev = topk.device
    finite = torch.isfinite(topk)
    top_finite = torch.where(finite, topk, -INF).amax(dim=-1)
    top_finite = torch.where(torch.isfinite(top_finite), top_finite, 0.0)
    topk = torch.where(finite, topk, top_finite[:, None])
    d_min = topk[:, 0]
    d_max = topk[:, -1]
    k = topk.shape[-1]
    span = torch.maximum(d_max - d_min, torch.full_like(d_max, 1e-6)) * 1.02
    delta = span / n_ew
    # jnp.linspace(0, k-1, m+1) in float32: (k-1) * (i/m), then the endpoint
    step = torch.arange(m, dtype=torch.float32, device=dev) / m
    pos = torch.cat([(k - 1.0) * step,
                     torch.full((1,), k - 1.0, device=dev)])
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=k - 1)
    frac = pos - lo.to(torch.float32)
    edges = topk[:, lo] + (topk[:, hi] - topk[:, lo]) * frac
    eps = span * 1e-7
    edges = edges + eps[:, None] * torch.arange(m + 1, dtype=torch.float32,
                                                device=dev)
    centers = d_min[:, None] + (torch.arange(
        n_ew, dtype=torch.float32, device=dev) + 0.5) * delta[:, None]
    ew_map = torch.searchsorted(edges.contiguous(), centers.contiguous(),
                                right=True) - 1
    ew_map = ew_map.clamp(0, m - 1).to(torch.int32)
    return edges, d_min, delta, ew_map


def sample_values(vals: torch.Tensor, ok: torch.Tensor | None,
                  sqrt: bool) -> torch.Tensor:
    """A codebook sample's lanes as its plan ranks them: squared PQ
    estimates (``sqrt``) become ``ok ? sqrt(clamp(vals, min=0)) : +inf``,
    other values ``ok ? vals : +inf`` (``vals`` itself where ``ok`` is
    None)."""
    if sqrt:
        vals = numerics.sqrt_rn(torch.clamp(vals, min=0.0))
    return vals if ok is None else torch.where(ok, vals, INF)


def sample_plan_batch(vals: torch.Tensor, ok: torch.Tensor | None, k_cb: int,
                      m: int, n_ew: int = 256, rank: int | None = None,
                      sqrt: bool = False, margin: int = 0,
                      cap: int | None = None, presorted: bool = False):
    """A query batch's sample plan from (B, w) sample values: the
    equal-depth codebooks over each row's ``k_cb`` smallest (``sample_values``
    of ``vals``, ``ok`` and ``sqrt``; ``torch.topk``'s order, NaN last),
    and with a ``rank`` (1 to w) the Eq. 6 bucket of each row's rank-th
    smallest, plus ``margin`` and at most ``cap`` where either is given.
    ``presorted`` rows are already ascending (a caller's top-k; ``ok`` and
    ``sqrt`` do not apply) and ``k_cb`` is their width.  Returns
    (``codebook_from_topk``'s four fields, tau (B,) int32 or None)."""
    k_cb = min(k_cb, vals.shape[-1])
    if presorted:
        srt = vals
    else:
        s = sample_values(vals, ok, sqrt)
        srt = torch.topk(s, max(k_cb, rank or 0), dim=-1, largest=False,
                         sorted=True).values
    cb = codebook_from_topk(srt[:, :k_cb], m, n_ew)
    if rank is None:
        return cb, None
    tau = bucketize_batch(srt[:, rank - 1:rank], cb[1], cb[2], cb[3], m)[:, 0]
    if margin or cap is not None:
        tau = torch.clamp(tau + margin, max=m if cap is None else cap).to(
            torch.int32)
    return cb, tau


def l2_exact_batch(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """(n, d) shared vectors, (B, d) queries -> (B, n) exact distances: the
    sum of (x - q)^2 in ascending coordinate order (``numerics.exact_dist``),
    as the CUDA kernels add it, rather than the JAX oracle's norm-identity
    matmul."""
    return numerics.exact_dist(x[None], qs[:, None])


def l2_exact_batch_masked(x: torch.Tensor, qs: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """(n, d) shared vectors, (B, d) queries, (B, n) ``mask`` -> (B, n)
    exact distances on the mask (``l2_exact_batch``'s), +inf off it."""
    return torch.where(mask, l2_exact_batch(x, qs), float("inf"))


def masked_tiles(mask: torch.Tensor, rows: int = 128,
                 group: int = 32) -> torch.Tensor:
    """(ceil(B / group), ceil(n / rows)) uint8: 1 where a group of queries
    has a set pair in a tile of rows of the (B, n) ``mask``, the tiles the
    masked pass stages."""
    b, n = mask.shape
    pad = torch.zeros(-(-b // group) * group, -(-n // rows) * rows,
                      dtype=torch.bool, device=mask.device)
    pad[:b, :n] = mask
    return pad.reshape(pad.shape[0] // group, group, -1, rows).any(
        dim=3).any(dim=1).to(torch.uint8)


def l2_gather_rows(vectors: torch.Tensor, ids: torch.Tensor,
                   qs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, d) vectors, per-query id rows ``ids`` (B, w) (-1 allowed off
    ``mask``), (B, d) queries, (B, w) ``mask`` -> (B, w) exact distances of
    the rows ``ids`` to their query on ``mask``, +inf off it.

    Only the masked (query, slot) entries are gathered, ``EXACT_CHUNK`` at
    a time, so no (B, w, d) block is ever materialized; the squares are
    added by ``numerics.ordered_sum`` (log2(d) launches a chunk on a card,
    where ``numerics.exact_dist``'s ascending order would take d), the
    order the CUDA kernel adds them in."""
    out = torch.full(ids.shape, INF, dtype=qs.dtype, device=qs.device)
    with spans.span("wait.rerank_nonzero"):
        rows, cols = mask.nonzero(as_tuple=True)
    for i in range(0, rows.shape[0], EXACT_CHUNK):
        r, c = rows[i:i + EXACT_CHUNK], cols[i:i + EXACT_CHUNK]
        diff = vectors[ids[r, c].clamp(min=0)] - qs[r]
        out[r, c] = numerics.sqrt_rn(numerics.ordered_sum(diff * diff))
    return out


def fused_scan_batch(codes, vectors, valid, luts, qs, d_min, delta, ew_maps,
                     m: int, tau_pred):
    """Plain version of the batched fused scan.

    Returns (est (B, n), bucket (B, n), hist (B, m+1), early (B, n),
    nmiss (B,)): ``early`` is the exact distance on valid lanes whose bucket
    is at or below ``tau_pred`` and +inf elsewhere, and ``nmiss`` counts the
    valid lanes above it."""
    est = numerics.sqrt_rn(torch.clamp(pq_adc_batch(codes, luts), min=0.0))
    est = torch.where(valid, est, INF)
    bucket = bucketize_batch(est, d_min, delta, ew_maps, m)
    hist = histogram_batch(bucket, valid, m)
    pred = valid & (bucket <= tau_pred[:, None])
    early = torch.where(pred, l2_exact_batch(vectors, qs), INF)
    nmiss = torch.sum(valid & ~pred, dim=1).to(torch.int32)
    return est, bucket, hist, early, nmiss


def fused_rabitq_scan_batch(codes, vectors, s2, norm_o, f_o, cl, g, qs, nq,
                            valid, d_min, delta, ew_maps, m: int, tau_inline,
                            eps0: float = 3.0):
    """Plain version of the bound-fused RaBitQ scan; ``g`` (B, d) are the
    rotated queries and ``nq`` (B, C) the query-centroid distances.

    Returns ``(est, lb, ub, bucket_lb, bucket_ub, hist_lb, hist_ub, exact,
    certified, nmiss)``: (B, n) lanes, (B, m+1) histograms over the valid
    lanes, and (B,) counts of the valid lanes not certified.  ``exact`` is
    the exact distance on certified lanes (valid, lower-bound bucket at or
    below ``tau_inline``) and +inf elsewhere."""
    est, lb, ub = numerics.rabitq_bounds_stream(codes, s2, norm_o, f_o, cl,
                                                g, nq, valid, eps0)
    bucket_lb = bucketize_batch(lb, d_min, delta, ew_maps, m)
    bucket_ub = bucketize_batch(ub, d_min, delta, ew_maps, m)
    hist_lb = histogram_batch(bucket_lb, valid, m)
    hist_ub = histogram_batch(bucket_ub, valid, m)
    certified = valid & (bucket_lb <= tau_inline[:, None])
    exact = torch.where(certified, l2_exact_batch(vectors, qs), INF)
    nmiss = torch.sum(valid & ~certified, dim=1).to(torch.int32)
    return (est, lb, ub, bucket_lb, bucket_ub, hist_lb, hist_ub, exact,
            certified, nmiss)


def rabitq_sample_ub_batch(codes, s2, norm_o, f_o, cl, offsets, clusters,
                           cap: int, g, nq, eps0: float = 3.0):
    """Plain version of the codebook sample's RaBitQ upper bounds.

    ``codes`` (n, d) int8 +-1, ``s2``, ``norm_o``, ``f_o`` (n,) and ``cl``
    (n,) int32 are the shared stream; ``offsets`` (C + 1,) its cluster
    starts; ``clusters`` (B, t) each query's sampled clusters, each padded
    to ``cap`` lanes (``ivf.tile_positions``' lanes); ``g`` (B, d) the
    rotated queries and ``nq`` (B, C) the query-centroid distances.
    Returns ``(ub (B, t*cap), ok (B, t*cap))``: the upper bound of each
    sampled lane, +inf off ``ok``, the lanes inside their cluster.  One
    gather of the sampled code rows in query chunks of at most
    ``numerics.CHUNK`` products, summed by ``numerics.ordered_sum``."""
    offs = offsets[clusters]
    sizes = offsets[clusters + 1] - offs
    lane = torch.arange(cap, device=clusters.device)
    ok = lane < sizes[..., None]
    b = clusters.shape[0]
    pos = torch.where(ok, offs[..., None] + lane, 0).reshape(b, -1)
    ok = ok.reshape(b, -1)
    w, d = pos.shape[1], codes.shape[1]
    s1 = torch.empty(b, w, dtype=torch.float32, device=g.device)
    step = max(1, numerics.CHUNK // max(w * d, 1))
    for i in range(0, b, step):
        c = codes[pos[i:i + step]].to(torch.float32)
        s1[i:i + step] = numerics.ordered_sum(c * g[i:i + step, None, :])
    nq_l = torch.gather(nq, 1, cl.long()[pos])
    _, _, ub = numerics.rabitq_bounds(s1, s2[pos], nq_l, norm_o[pos],
                                      f_o[pos], d, eps0)
    return torch.where(ok, ub, INF), ok


def probe_mask_batch(cluster_of: torch.Tensor, probed: torch.Tensor,
                     n_clusters: int,
                     live: torch.Tensor | None = None) -> torch.Tensor:
    """(B, n) lane mask: lane j is set for query b iff ``cluster_of[j]`` is
    in ``probed[b]`` (and ``live[j]``, where given).  ``ivf.probe_mask``'s
    scatter and gather; its ``& valid`` is left out, since a padding lane's
    cluster is ``n_clusters``, whose column is cleared."""
    hit = torch.zeros(probed.shape[0], n_clusters + 1, dtype=torch.bool,
                      device=probed.device)
    hit.scatter_(1, probed, True)
    hit[:, n_clusters] = False
    mask = hit[:, cluster_of]
    return mask if live is None else mask & live[None, :]


def spec_compact_batch(bucket: torch.Tensor, valid: torch.Tensor,
                       tau_spec: torch.Tensor, budget: int):
    """Stream-order compaction of the valid lanes at or below ``tau_spec``
    (B,) into a ``budget``-wide position buffer (the speculative half of
    the shard collector; ``tau_spec = -1`` compacts nothing).

    Returns ``(pos (B, budget) int32, ok (B, budget), count (B,) int32)``:
    ``pos`` holds the stream positions of the FIRST ``budget`` matching
    lanes in stream order and the sentinel ``n`` past the fill, ``ok`` is
    ``pos < n``, and ``count`` the true total of matching lanes, above
    ``budget`` on overflow.  A cumulative-sum scatter in int64, so unlike
    the JAX oracle's int32 composite sort key it has no limit on n*(m+2)."""
    b, n = bucket.shape
    match = valid & (bucket <= tau_spec[:, None])
    rank = torch.cumsum(match, dim=1) - 1
    keep = match & (rank < budget)
    # kept lanes land at their rank; the rest go to a dump column
    slot = torch.where(keep, rank, budget)
    lane = torch.arange(n, dtype=torch.int32, device=bucket.device)
    pos = torch.full((b, budget + 1), n, dtype=torch.int32,
                     device=bucket.device)
    pos.scatter_(1, slot, torch.where(keep, lane, n))
    pos = pos[:, :budget].contiguous()
    return pos, pos < n, match.sum(dim=1).to(torch.int32)


def rabitq_est_tiles(codes: torch.Tensor, norm_o: torch.Tensor,
                     f_o: torch.Tensor, v: torch.Tensor, norm_q: torch.Tensor,
                     valid: torch.Tensor, eps0: float = 3.0):
    """Plain version of the RaBitQ estimator over T probed tiles at once:
    codes (T, cap, d) int8 +-1, norm_o/f_o/valid (T, cap), v (T, d) each
    tile's rotated unit query residual, norm_q (T,).  Returns (est, lb, ub),
    each (T, cap) and +inf off ``valid``.

    The JAX formula (``kernels/ref.py rabitq_est``) with one fp32 rounding
    per operation in its order: s1 = sum_j code[j] v[j] in ascending j,
    then ``/ sqrt(d)``, ``/ f_o``, the error bound, ``scale = (2 nq) no``,
    ``base = nq^2 + no^2`` and sqrt(max(base - scale * t, 0)) for t in (ip,
    ip + err, ip - err): the order the CUDA kernel evaluates its ``__f*_rn``
    intrinsics in, so the two agree to the bit."""
    d = codes.shape[-1]
    s1 = torch.zeros(codes.shape[:-1], dtype=torch.float32,
                     device=codes.device)
    for j in range(d):
        s1 = s1 + codes[..., j].to(torch.float32) * v[:, j, None]
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which the kernel's __fdiv_rn does not do
    ip = (s1 / s1.new_tensor(math.sqrt(d))) / f_o
    err = numerics.lane_err(f_o, d, eps0)
    nq = norm_q[:, None]
    scale = (2.0 * nq) * norm_o
    base = nq * nq + norm_o * norm_o

    def dist(t):
        return torch.where(valid, numerics.sqrt_rn(
            torch.clamp(base - scale * t, min=0.0)), INF)

    return dist(ip), dist(ip + err), dist(ip - err)


# The single-query forms: row 0 of the batched plain versions (T = 1 for
# the RaBitQ estimator).

def rabitq_est(codes, norm_o, f_o, v, norm_q, eps0: float = 3.0):
    """(n, d) codes, (n,) factors, (d,) v, scalar norm_q -> (est, lb, ub)."""
    out = rabitq_est_tiles(codes[None], norm_o[None], f_o[None], v[None],
                           torch.as_tensor(norm_q, dtype=torch.float32,
                                           device=codes.device).reshape(1),
                           torch.ones(1, codes.shape[0], dtype=torch.bool,
                                      device=codes.device), eps0)
    return tuple(t[0] for t in out)


def pq_adc(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """(n, M) codes, (M, K) LUT -> (n,) squared estimates."""
    return pq_adc_batch(codes, lut[None])[0]


def l2_exact(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(n, d) vectors, (d,) query -> (n,) exact distances."""
    return l2_exact_batch(x, q[None])[0]


def bucket_hist(dists, valid, d_min, delta, ew_map, m: int):
    """(n,) distances, one codebook -> (bucket (n,), hist (m+1,))."""
    bucket, hist = bucket_hist_batch(dists[None], valid[None],
                                     d_min.reshape(1), delta.reshape(1),
                                     ew_map.reshape(1, -1), m)
    return bucket[0], hist[0]


def fused_scan(codes, vectors, valid, lut, q, d_min, delta, ew_map, m: int,
               tau_pred):
    """One query's fused scan: (est (n,), bucket (n,), hist (m+1,),
    early (n,), nmiss ())."""
    out = fused_scan_batch(codes, vectors, valid[None], lut[None], q[None],
                           d_min.reshape(1), delta.reshape(1),
                           ew_map.reshape(1, -1), m,
                           torch.as_tensor(tau_pred, dtype=torch.int32,
                                           device=codes.device).reshape(1))
    return tuple(t[0] for t in out)


def shard_collect_batch(dists: torch.Tensor, valid: torch.Tensor,
                        d_min: torch.Tensor, delta: torch.Tensor,
                        ew_maps: torch.Tensor, m: int, tau_spec: torch.Tensor,
                        budget: int):
    """Plain version of the fused shard collector: Eq. 6 bucketize, the
    (B, m+1) histogram of the valid lanes, and ``spec_compact_batch`` at
    the provisional ``tau_spec``.  Returns ``(bucket (B, n), hist (B, m+1),
    spec_pos (B, budget), spec_ok (B, budget), spec_count (B,))``."""
    bucket, hist = bucket_hist_batch(dists, valid, d_min, delta, ew_maps, m)
    pos, ok, count = spec_compact_batch(bucket, valid, tau_spec, budget)
    return bucket, hist, pos, ok, count
