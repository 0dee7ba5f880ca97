"""The plain reference of the benchmark and the comparison that decides
``correct``.

Exact k-nearest-neighbour search under L2 in plain PyTorch, in float64, from
the corpus and the queries the benchmark made; nothing of the program is
imported or read.  ``compare`` judges what the timed calls returned:

- the selection, as the share of the exact top-k that each query got back
  (``recall``, reported as the end-to-end metric ``recall_at_k``);
- the re-rank, as the relative gap between each reported distance and the
  exact distance of the id it was reported with (``dist_err``), and the
  order of the rows (``unsorted_rows``: the queries whose exactly ranked
  rows ever decrease).  ``exact_rows`` says which rows a configuration
  reports exactly.  ``"all"``: every row, in ascending order (IVF+PQ).
  ``"suffix"``: IVF+RaBitQ+BBC lists the rows its bounds certify first,
  each with its estimate, then its re-ranked rows by exact distance, the
  k-th always among them.  There ``dist_err`` reads the k-th row; a row
  counts as exact where its gap is at most ``exact_tol``, the rows after a
  query's last estimate are held to ascending order, and
  ``exact_before_estimate`` is the largest number, over the queries, of
  exact rows listed before the query's last estimate: an estimate that
  follows re-ranked rows raises it, while a certified row's estimate that
  happens to fall within ``exact_tol`` of its distance adds one.

A row with the wrong shape, an id out of range, a repeated id or a distance
that is not finite reads ``dist_err = inf``.

``control_search`` is the control: the same search in the precision below
the configuration's float32, TF32 (operands rounded to a 10-bit mantissa,
products summed in float32), put in the program's place.
"""
from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROW_BLOCK = 1 << 17       # corpus rows per block of the exact scan
QUERY_BLOCK = 64          # queries per block


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(1)


def exact_topk(x: torch.Tensor, qs: torch.Tensor, k: int):
    """The exact top-k of each query: (dists float64 ascending, ids int64).
    Squared distances ``|x|^2 - 2 x.q + |q|^2`` in float64, corpus rows in
    blocks, a running top-k."""
    out_d, out_i = [], []
    for q0 in range(0, qs.shape[0], QUERY_BLOCK):
        q = qs[q0:q0 + QUERY_BLOCK].to(torch.float64)
        qn = _sq_norms(q)[:, None]
        best_d = torch.empty(q.shape[0], 0, dtype=torch.float64,
                             device=x.device)
        best_i = torch.empty(q.shape[0], 0, dtype=torch.int64,
                             device=x.device)
        for r0 in range(0, x.shape[0], ROW_BLOCK):
            xb = x[r0:r0 + ROW_BLOCK].to(torch.float64)
            d2 = qn - 2.0 * q @ xb.T + _sq_norms(xb)[None, :]
            ids = torch.arange(r0, r0 + xb.shape[0],
                               device=x.device).expand(q.shape[0], -1)
            cat_d = torch.cat([best_d, d2], 1)
            cat_i = torch.cat([best_i, ids], 1)
            w = min(k, cat_d.shape[1])
            best_d, pos = torch.topk(cat_d, w, dim=1, largest=False,
                                     sorted=True)
            best_i = torch.gather(cat_i, 1, pos)
        out_d.append(best_d.clamp(min=0).sqrt())
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def exact_dists(x: torch.Tensor, qs: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """float64 distances of rows ``ids`` (b, w) to the queries (b, d),
    summed from the differences."""
    out = []
    for q0 in range(0, qs.shape[0], QUERY_BLOCK):
        rows = x[ids[q0:q0 + QUERY_BLOCK]].to(torch.float64)
        diff = rows - qs[q0:q0 + QUERY_BLOCK, None, :].to(torch.float64)
        out.append((diff * diff).sum(-1).sqrt())
    return torch.cat(out)


def _row_valid(ids: torch.Tensor, dists: torch.Tensor, n: int,
               k: int) -> torch.Tensor:
    """(b,) True where a row has k ids in range, no id twice and finite
    distances."""
    in_range = ((ids >= 0) & (ids < n)).all(1)
    srt = torch.sort(ids, dim=1).values
    distinct = (srt[:, 1:] != srt[:, :-1]).all(1)
    return in_range & distinct & torch.isfinite(dists).all(1)


def compare(x: torch.Tensor, qs: torch.Tensor, ids, dists, k: int,
            exact_rows: str = "all", exact_tol: float = 0.0) -> dict:
    """Judge returned ``ids``/``dists`` (b, k) for the queries ``qs`` (b, d)
    against the exact search over ``x`` (n, d).  Returns the mean recall,
    the per-query recalls, ``dist_err`` (the largest relative gap between a
    reported distance and the exact distance of its id, over the rows
    ``exact_rows`` names; inf where a row is malformed), ``unsorted_rows``
    and ``exact_before_estimate`` (see the module's docstring)."""
    if exact_rows not in ("all", "suffix"):
        raise ValueError(f"exact_rows must be 'all' or 'suffix', got "
                         f"{exact_rows!r}")
    b = qs.shape[0]
    ids = torch.as_tensor(ids).to(x.device, torch.int64).reshape(b, -1)
    dists = torch.as_tensor(dists).to(x.device, torch.float64).reshape(b, -1)
    if ids.shape != (b, k) or dists.shape != (b, k):
        return {"recall": 0.0, "recalls": [0.0] * b, "dist_err": math.inf,
                "unsorted_rows": b, "exact_before_estimate": k,
                "malformed": b}
    qs = torch.as_tensor(qs).to(x.device, torch.float32)
    ok = _row_valid(ids, dists, x.shape[0], k)
    safe = torch.where(ok[:, None], ids, 0).clamp(0, x.shape[0] - 1)
    _, gt = exact_topk(x, qs, k)
    gs = torch.sort(gt, dim=1).values
    pos = torch.searchsorted(gs, safe).clamp(max=k - 1)
    hits = (torch.gather(gs, 1, pos) == safe).sum(1).double() / k
    recalls = torch.where(ok, hits, 0.0).tolist()
    exact = exact_dists(x, qs, safe)
    err = (dists - exact).abs() / exact.clamp(min=1e-30)
    falls = dists[:, 1:] < dists[:, :-1]          # (b, k-1): row j+1 < row j
    col = torch.arange(k, device=x.device)[None, :]
    if exact_rows == "all":
        before = torch.zeros(b, dtype=torch.int64, device=x.device)
    else:
        estimate = err > exact_tol
        last = torch.where(estimate, col, -1).max(1).values[:, None]
        before = ((~estimate) & (col < last)).sum(1)
        falls = falls & (col[:, 1:] > last + 1)
        err = err[:, -1:]
    per_query = torch.where(ok, err.max(1).values, math.inf)
    return {"recall": sum(recalls) / b, "recalls": recalls,
            "dist_err": float(per_query.max().item()),
            "unsorted_rows": int(falls.any(1).sum().item()),
            "exact_before_estimate": int(before.max().item()),
            "malformed": int((~ok).sum().item())}


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    to even), as the tensor cores read their operands."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def control_search(x: torch.Tensor, qs: torch.Tensor, k: int):
    """The control: exact search with the product ``x.q`` taken from TF32
    operands (summed in float32), squared norms in float32.  Returns
    (dists float32, ids int64) as the program would."""
    out_d, out_i = [], []
    xt = to_tf32(x)
    xn = _sq_norms(x)
    for q0 in range(0, qs.shape[0], QUERY_BLOCK):
        q = qs[q0:q0 + QUERY_BLOCK].to(torch.float32)
        d2 = _sq_norms(q)[:, None] - 2.0 * (to_tf32(q) @ xt.T) + xn[None, :]
        vals, ids = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        out_d.append(vals.clamp(min=0).sqrt())
        out_i.append(ids)
    return torch.cat(out_d), torch.cat(out_i)
