"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

The port of the JAX package's ``repro.models.moe``.  Each (token, choice)
takes a position inside its expert's capacity buffer from its rank among
the row's choices of that expert; a gather builds the (B, E, C, d) expert
batch from the int32 slot-to-token map, and the experts run as batched
SwiGLU products.  The same (token, choice) pairs are dropped as in the
reference:

* the same capacity, ``min(int(max(S*k/E*cf, 4)), S)``, per batch row;
* top-k with the reference's tie order (the lower expert index first):
  a stable descending sort, since ``torch.topk`` promises no order;
* each pair's rank from a stable argsort of the row by expert id.

The combine gathers each token's k slots and sums them in choice order,
with no float atomics: the reference's scatter-add (``.at[].add``) would
be ``index_add_`` here, whose order on the card is not fixed.

On a mesh (``DTensor`` activations) the router and the expert products
run as ``DTensor`` ops, the experts sharded over "model" at the
reference's constraints; the slot maps, the dispatch and the combine run
row by row on each rank's batch rows (``shard.local_rows``: DTensor has
no sharding rule for ``searchsorted`` or an indexed gather).  So the
combine gathers every expert's rows to the rank, where the reference
reduces the weighted (S, d) sums.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as shard
from repro_torch.models.layers import Params, normal


class MoE(Params):
    """``router`` (d, E) and the stacked experts ``w_gate``, ``w_up``
    (E, d, ff) and ``w_down`` (E, ff, d): the reference's ``init_moe``."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, dtype,
                 device, gen=None):
        super().__init__()
        s1, s2 = float(d_model) ** -0.5, float(d_ff) ** -0.5
        self.router = normal(gen, (d_model, n_experts), dtype, device, s1)
        self.w_gate = normal(gen, (n_experts, d_model, d_ff), dtype, device,
                             s1)
        self.w_up = normal(gen, (n_experts, d_model, d_ff), dtype, device, s1)
        self.w_down = normal(gen, (n_experts, d_ff, d_model), dtype, device,
                             s2)

    def forward(self, x, top_k: int, capacity_factor: float = 1.25):
        return moe_forward(self, x, top_k, capacity_factor)


class Routing(NamedTuple):
    """One call's dispatch: which (token, choice) pairs go where."""
    sel: torch.Tensor           # (B, S, k) int64 expert of each choice
    gate: torch.Tensor          # (B, S, k) fp32 renormalised gate
    slot: torch.Tensor          # (B, S*k) int64, E*C = dropped
    tok_for_slot: torch.Tensor  # (B, E*C) int64 token of each slot, S = empty
    capacity: int


def capacity_of(s: int, top_k: int, n_experts: int, cf: float) -> int:
    return min(int(max(s * top_k / n_experts * cf, 4)), s)


def route(p, x: torch.Tensor, top_k: int,
          capacity_factor: float = 1.25) -> Routing:
    """Top-k routing and the capacity-bounded slot maps, per batch row."""
    s = x.shape[1]
    e = p["router"].shape[1]
    logits = torch.einsum("bsd,de->bse", x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    capacity = capacity_of(s, top_k, e, capacity_factor)
    sel, gate, slot, tok = shard.local_rows(
        lambda pr: _slots(pr, top_k, capacity), probs)
    return Routing(sel, gate, slot, tok, capacity)


def _slots(probs: torch.Tensor, top_k: int, capacity: int):
    """(sel, gate, slot, tok_for_slot) of ``Routing`` from the router's
    probabilities, row by row."""
    b, s, e = probs.shape
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, sel = vals[..., :top_k], idx[..., :top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    t = s * top_k
    flat_sel = sel.reshape(b, t)
    order = torch.argsort(flat_sel, dim=-1, stable=True)
    sorted_sel = torch.gather(flat_sel, 1, order)
    # index of the first occurrence of each expert id in the sorted row
    first = torch.searchsorted(sorted_sel, sorted_sel, side="left")
    rank_sorted = torch.arange(t, device=probs.device)[None, :] - first
    pos = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    dropped = e * capacity
    slot = torch.where(pos < capacity, flat_sel * capacity + pos,
                       torch.full_like(pos, dropped))
    rows = torch.arange(s, device=probs.device).repeat_interleave(top_k)
    tok = torch.full((b, dropped + 1), s, dtype=torch.int64,
                     device=probs.device)
    tok.scatter_(1, slot, rows.expand(b, t).contiguous())
    # every kept slot is written once; the dropped pairs all land on the
    # spare last slot, which is cut off
    return sel, gate, slot, tok[:, :dropped]


def moe_forward(p, x: torch.Tensor, top_k: int,
                capacity_factor: float = 1.25) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): top-k routing, capacity bounded PER ROW;
    the experts see a (B, E, C, d) batch, expert-parallel over "model" on
    a mesh."""
    e = p["router"].shape[1]
    x = shard.rows(x)
    r = route(p, x, top_k, capacity_factor)
    c = r.capacity

    def dispatch(x, tok):
        # a gather driven by the int slot-to-token map
        b, _, d = x.shape
        x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
        return torch.gather(x_pad, 1, tok[..., None].expand(
            b, e * c, d)).reshape(b, e, c, d)

    xe = shard.constrain(shard.local_rows(dispatch, x, r.tok_for_slot),
                         shard.BATCH, "model", None, None)
    h = F.silu(torch.einsum("becd,edf->becf", xe, p["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", xe, p["w_up"])
    h = shard.constrain(h, shard.BATCH, "model", None, None)
    ye = torch.einsum("becf,efd->becd", h, p["w_down"])     # (B, E, C, d)
    ye = shard.constrain(ye, shard.BATCH, "model", None, None)

    def combine(ye, slot, gate):
        # each token gathers its k slots (a dropped pair reads the zero
        # row) and sums them in choice order
        b, s = slot.shape[0], slot.shape[1] // top_k
        d = ye.shape[-1]
        ye_pad = torch.cat([ye.reshape(b, e * c, d), ye.new_zeros(b, 1, d)],
                           1)
        got = torch.gather(ye_pad, 1, slot[..., None].expand(
            b, s * top_k, d)).reshape(b, s, top_k, d)
        w = gate.to(ye.dtype)
        y = got[:, :, 0] * w[..., 0, None]
        for j in range(1, top_k):
            y = y + got[:, :, j] * w[..., j, None]
        return y

    return shard.local_rows(combine, ye, r.slot, r.gate)
