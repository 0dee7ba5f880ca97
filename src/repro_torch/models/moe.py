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
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

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
    b, s, _ = x.shape
    e = p["router"].shape[1]
    logits = torch.einsum("bsd,de->bse", x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, sel = vals[..., :top_k], idx[..., :top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    capacity = capacity_of(s, top_k, e, capacity_factor)

    t = s * top_k
    flat_sel = sel.reshape(b, t)
    order = torch.argsort(flat_sel, dim=-1, stable=True)
    sorted_sel = torch.gather(flat_sel, 1, order)
    # index of the first occurrence of each expert id in the sorted row
    first = torch.searchsorted(sorted_sel, sorted_sel, side="left")
    rank_sorted = torch.arange(t, device=x.device)[None, :] - first
    pos = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    dropped = e * capacity
    slot = torch.where(pos < capacity, flat_sel * capacity + pos,
                       torch.full_like(pos, dropped))
    rows = torch.arange(s, device=x.device).repeat_interleave(top_k)
    tok = torch.full((b, dropped + 1), s, dtype=torch.int64, device=x.device)
    tok.scatter_(1, slot, rows.expand(b, t).contiguous())
    # every kept slot is written once; the dropped pairs all land on the
    # spare last slot, which is cut off
    return Routing(sel, gate, slot, tok[:, :dropped], capacity)


def moe_forward(p, x: torch.Tensor, top_k: int,
                capacity_factor: float = 1.25) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): top-k routing, capacity bounded PER ROW;
    the experts see a (B, E, C, d) batch."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    r = route(p, x, top_k, capacity_factor)
    c = r.capacity

    # dispatch: a gather driven by the int slot-to-token map
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    xe = torch.gather(x_pad, 1, r.tok_for_slot[..., None].expand(
        b, e * c, d)).reshape(b, e, c, d)

    h = F.silu(torch.einsum("becd,edf->becf", xe, p["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", xe, p["w_up"])
    ye = torch.einsum("becf,efd->becd", h, p["w_down"])     # (B, E, C, d)

    # combine: each token gathers its k slots (a dropped pair reads the
    # zero row) and sums them in choice order
    ye_pad = torch.cat([ye.reshape(b, e * c, d), ye.new_zeros(b, 1, d)], 1)
    got = torch.gather(ye_pad, 1, r.slot[..., None].expand(
        b, s * top_k, d)).reshape(b, s, top_k, d)
    w = r.gate.to(x.dtype)
    y = got[:, :, 0] * w[..., 0, None]
    for j in range(1, top_k):
        y = y + got[:, :, j] * w[..., j, None]
    return y
