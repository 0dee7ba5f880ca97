"""Roofline terms of a model step: the analytic cost model (FLOPs, model
FLOPs, active parameters and HBM bytes from a config's shapes) and the
collective bytes a sharded step sends.

The port of the JAX package's ``repro.launch.roofline``.  The analytic
half is plain arithmetic on a config, the same numbers.  The other half
differs by design.  The reference parses the compiled HLO text of a dry
run (``_shape_bytes``, ``_group_size``, ``collective_bytes``) and scales
the collectives inside while loops by estimated trip counts
(``collective_bytes_nested``, ``depth_trips_for``), because the text
shows a loop body once.  The port runs the step eagerly on ``DTensor``s
(``launch/dryrun.py``), so every loop trip issues its collectives, and
``CollectiveCounter`` counts them as they are issued: no HLO, no parser,
no nesting multiplier.  The byte rule is the reference's: an all-gather
operand is its output over the group, a reduce-scatter operand the
unscattered input, any other the input.  ``LiveBytes`` tracks the peak of
the step's live buffers in place of XLA's ``memory_analysis``.

The peaks are one NVIDIA H100 SXM's, from NVIDIA's data sheet (dense
rates at the 700 W power limit), not a measurement.  ``LINK_BW`` is
NVLink's, which holds within one 8-card NVLink domain only: a 256-card
axis crosses nodes and their slower network.
"""
from __future__ import annotations

import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989e12        # bf16 dense tensor-core FLOP/s, one H100 SXM
HBM_BW = 3.35e12           # HBM3 bytes/s, one H100 SXM
LINK_BW = 450e9            # NVLink bytes/s per direction, one H100 SXM


def _attn_layer_flops(cfg, B, S, S_kv, causal_full=True):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    proj = 2 * B * S * d * (2 * h * hd) + 2 * B * S * d * (2 * kv * hd)
    # flash computes the full S x S_kv block grid (masked lanes included)
    attn = 2 * 2 * B * h * S * S_kv * hd
    return proj + attn


def _dense_mlp_flops(cfg, B, S, n_mats=3):
    return 2 * B * S * cfg.d_model * cfg.d_ff * n_mats


def _moe_mlp_flops(cfg, B, S):
    cf = cfg.capacity_factor
    router = 2 * B * S * cfg.d_model * cfg.n_experts
    tokens = B * S * cfg.top_k * cf           # E * C dispatch slots
    experts = 2 * tokens * cfg.d_model * cfg.d_ff * 3
    return router + experts


def _ssm_layer_flops(cfg, B, S):
    sd = cfg.ssm_dims()
    d = cfg.d_model
    lc = min(cfg.ssm_chunk, S)
    f = 2 * B * S * d * sd.d_in_proj                       # in_proj
    f += 2 * B * S * sd.d_conv_ch * sd.conv_width          # conv
    f += 2 * B * S * lc * sd.d_state                       # CB scores
    f += 2 * B * S * lc * sd.n_heads * sd.headdim          # intra mat @ x
    f += 2 * 2 * B * S * sd.d_state * sd.n_heads * sd.headdim  # inter+state
    f += 2 * B * S * sd.d_inner * d                        # out_proj
    return f


def _ssm_decode_flops(cfg, B):
    sd = cfg.ssm_dims()
    f = 2 * B * cfg.d_model * sd.d_in_proj
    f += 2 * 2 * B * sd.n_heads * sd.headdim * sd.d_state  # state upd + read
    f += 2 * B * sd.d_inner * cfg.d_model
    return f


def forward_flops(cfg, B: int, S: int, S_kv: int | None = None) -> float:
    """Exact global forward FLOPs for one pass (decode: S=1, S_kv=cache)."""
    S_kv = S_kv if S_kv is not None else S
    fam = cfg.family
    if fam in ("dense", "vlm"):
        # vlm: patches extend the sequence in train/prefill only; during
        # decode they are already in the cache (S == 1)
        pat = cfg.n_patches if (fam == "vlm" and S > 1) else 0
        S_eff = S + pat
        Skv_eff = S_kv + pat if S_kv == S else S_kv
        per = _attn_layer_flops(cfg, B, S_eff, Skv_eff) + _dense_mlp_flops(
            cfg, B, S_eff)
        return cfg.n_layers * per
    if fam == "moe":
        per = _attn_layer_flops(cfg, B, S, S_kv) + _moe_mlp_flops(cfg, B, S)
        return cfg.n_layers * per
    if fam == "ssm":
        if S == 1 and S_kv > 1:
            return cfg.n_layers * _ssm_decode_flops(cfg, B)
        return cfg.n_layers * _ssm_layer_flops(cfg, B, S)
    if fam == "hybrid":
        if S == 1 and S_kv > 1:
            ssm = cfg.n_layers * _ssm_decode_flops(cfg, B)
        else:
            ssm = cfg.n_layers * _ssm_layer_flops(cfg, B, S)
        shared = cfg.n_segments * (
            _attn_layer_flops(cfg, B, S, S_kv) + _dense_mlp_flops(cfg, B, S))
        return ssm + shared
    if fam == "encdec":
        F = cfg.n_frames
        dec_n = cfg.dec_layers or cfg.n_layers
        enc = cfg.n_layers * (_attn_layer_flops(cfg, B, F, F)
                              + _dense_mlp_flops(cfg, B, F, n_mats=2))
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
        self_a = _attn_layer_flops(cfg, B, S, S_kv)
        cross = (2 * B * S * d * 2 * h * hd           # q, o at S
                 + 2 * B * F * d * 2 * kv * hd        # k, v at F
                 + 2 * 2 * B * h * S * F * hd)        # scores + pv
        dec = dec_n * (self_a + cross + _dense_mlp_flops(cfg, B, S, n_mats=2))
        if S == 1 and S_kv > 1:
            enc = 0.0  # decode step consumes a precomputed encoder output
        return enc + dec
    raise ValueError(fam)


def head_flops(cfg, B, S, mode) -> float:
    if mode == "train":
        return 2 * B * S * cfg.d_model * cfg.vocab
    return 2 * B * cfg.d_model * cfg.vocab  # last-token logits


def analytic_flops(cfg, mode: str, seq: int, batch: int) -> float:
    """Global FLOPs for one step."""
    if mode == "train":
        fwd = forward_flops(cfg, batch, seq) + head_flops(cfg, batch, seq, mode)
        mult = 4.0 if cfg.remat else 3.0   # fwd + 2x bwd (+1x remat recompute)
        opt = 12.0 * _total_params(cfg)
        return fwd * mult + opt
    if mode == "prefill":
        return forward_flops(cfg, batch, seq) + head_flops(cfg, batch, seq, mode)
    # decode: one token against a seq-long cache
    return (forward_flops(cfg, batch, 1, S_kv=seq)
            + head_flops(cfg, batch, 1, mode))


def _total_params(cfg) -> int:
    emb = cfg.vocab * cfg.d_model * 2
    if cfg.family == "moe":
        d, ff = cfg.d_model, cfg.d_ff
        per = (2 * cfg.d_model * cfg.hd * (cfg.n_heads + cfg.n_kv)
               + 3 * d * ff * cfg.n_experts + d * cfg.n_experts)
        return emb + cfg.n_layers * per
    dense_eq = active_param_count(cfg)
    return emb + dense_eq


def _dtype_bytes(cfg) -> int:
    return 2 if cfg.dtype == torch.bfloat16 else 4


def _act_layer_bytes(cfg, B, S) -> float:
    """HBM bytes written+read for one layer's major intermediates, one pass.
    Flash attention scores stay in VMEM (fused) by design — q/k/v/out only."""
    dt = _dtype_bytes(cfg)
    d, ff, h, kv, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv, cfg.hd)
    fam = cfg.family
    if fam in ("dense", "vlm", "moe", "encdec"):
        qkvo = B * S * hd * (2 * h + 2 * kv)
        if fam == "moe":
            mlp = B * S * cfg.top_k * cfg.capacity_factor * (2 * ff + 2 * d)
        else:
            mlp = B * S * 3 * ff
        resid = 4 * B * S * d
        return 2 * dt * (qkvo + mlp + resid)     # write + read
    sd = cfg.ssm_dims()
    inner = B * S * (sd.d_in_proj + sd.d_conv_ch + 2 * sd.d_inner)
    return 2 * dt * (inner + 2 * B * S * d)


def analytic_bytes(cfg, mode: str, seq: int, batch: int, n_chips: int,
                   n_mb: int = 8) -> float:
    """Per-chip HBM traffic for one step (the memory roofline term)."""
    dt = _dtype_bytes(cfg)
    n_par = _total_params(cfg)
    par_chip = n_par * dt / n_chips          # fully sharded (model x data)
    if mode == "train":
        layer_passes = 3.0 if cfg.remat else 2.0   # fwd + recompute + bwd≈1
        # weights: re-read per microbatch per pass + grad write/read + Adam
        w = par_chip * (layer_passes * n_mb) + 2 * par_chip + 20 * (
            n_par / n_chips)
        acts = (_act_layer_bytes(cfg, batch, seq) * _layer_count(cfg)
                * (1 + layer_passes)) / n_chips
        head = 3 * batch * seq * cfg.vocab * dt / n_chips  # chunked loss
        return w + acts + head
    if mode == "prefill":
        acts = (_act_layer_bytes(cfg, batch, seq) * _layer_count(cfg)) / n_chips
        return par_chip + acts
    # decode: weights + full cache read + small writes
    cache = _cache_bytes(cfg, batch, seq)
    return par_chip + cache / n_chips + (
        _act_layer_bytes(cfg, batch, 1) * _layer_count(cfg)) / n_chips


def _layer_count(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers + cfg.n_segments
    if cfg.family == "encdec":
        return cfg.n_layers + (cfg.dec_layers or cfg.n_layers)
    return cfg.n_layers


def _cache_bytes(cfg, batch, seq) -> float:
    dt = _dtype_bytes(cfg)
    if cfg.family in ("dense", "moe", "vlm"):
        per = cfg.n_layers * batch * seq * 2 * cfg.n_kv * cfg.hd
        if getattr(cfg, "kv_quant", False):
            return per + cfg.n_layers * batch * seq * 2 * 4  # int8 + scales
        return per * dt
    sd = cfg.ssm_dims() if cfg.d_state else None
    if cfg.family == "ssm":
        return cfg.n_layers * batch * sd.n_heads * sd.headdim * sd.d_state * 4
    if cfg.family == "hybrid":
        ssm = cfg.n_layers * batch * sd.n_heads * sd.headdim * sd.d_state * 4
        attn = cfg.n_segments * batch * seq * 2 * cfg.n_kv * cfg.hd * dt
        return ssm + attn
    if cfg.family == "encdec":
        dec_n = cfg.dec_layers or cfg.n_layers
        return dec_n * batch * seq * 2 * cfg.n_kv * cfg.hd * dt
    raise ValueError(cfg.family)


def model_flops(cfg, mode: str, seq: int, batch: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params.

    N excludes embedding tables (standard convention); MoE uses active
    experts only.  D = total tokens processed by the step."""
    n = active_param_count(cfg)
    if mode == "train":
        per_tok = 6 * n
        d_tok = batch * seq
    elif mode == "prefill":
        per_tok = 2 * n
        d_tok = batch * seq
    else:  # decode: one token per sequence
        per_tok = 2 * n
        d_tok = batch
    return float(per_tok) * float(d_tok)


def active_param_count(cfg) -> int:
    """Backbone parameters touched per token (analytic, excl. embeddings)."""
    d, ff, L_ = cfg.d_model, cfg.d_ff, cfg.n_layers
    hd = cfg.hd
    attn = d * hd * cfg.n_heads * 2 + d * hd * cfg.n_kv * 2   # q,o + k,v
    mlp = 3 * d * ff                                           # swiglu
    if cfg.family == "dense" or cfg.family == "vlm":
        return L_ * (attn + mlp)
    if cfg.family == "moe":
        active_mlp = 3 * d * ff * cfg.top_k + d * cfg.n_experts
        return L_ * (attn + active_mlp)
    if cfg.family == "ssm":
        sd = cfg.ssm_dims()
        ssm = (d * sd.d_in_proj + sd.d_inner * d
               + sd.conv_width * sd.d_conv_ch)
        return L_ * ssm
    if cfg.family == "hybrid":
        sd = cfg.ssm_dims()
        ssm = (d * sd.d_in_proj + sd.d_inner * d
               + sd.conv_width * sd.d_conv_ch)
        shared = attn + mlp
        return L_ * ssm + cfg.n_segments * shared
    if cfg.family == "encdec":
        dec_n = cfg.dec_layers or cfg.n_layers
        enc = cfg.n_layers * (attn + 2 * d * ff)
        dec = dec_n * (2 * attn + 2 * d * ff)
        return enc + dec
    raise ValueError(cfg.family)


# --------------------------------------------------------------------------
# What a sharded step sends and holds, counted as it runs
# --------------------------------------------------------------------------

def _local_only(types) -> bool:
    """True when no ``DTensor`` takes part: the dispatch modes below see
    the per-rank ops DTensor issues, not the DTensor-level ones."""
    from torch.distributed.tensor import DTensor
    return not any(issubclass(t, DTensor) for t in types)


# op name (``_c10d_functional`` unless named) -> the reference's kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",      # ``_dtensor`` namespace
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


class CollectiveCounter(TorchDispatchMode):
    """Operand bytes of every collective the ranks' ops issue while the
    mode is on, by kind: ``counts()`` gives the reference's
    ``collective_bytes`` dict (its five kinds, ``broadcast``, which HLO
    does not have, ``total`` and ``op_counts``).  An all-gather's operand
    is the shard it sends (its output over the group) and a
    reduce-scatter's the unscattered input, as the reference counts them.
    On a CPU mesh (the dry run's fake group) DTensor moves a shard between
    dimensions by an all-gather and a local chunk, not an all-to-all: the
    same operand bytes, counted as an all-gather."""

    KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute", "broadcast")

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(self.KINDS, 0)
        self.ops = dict.fromkeys(self.KINDS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _local_only(types):
            return NotImplemented
        ns = func.namespace
        kind = (_COLLECTIVES.get(func._opname)
                if ns in ("_c10d_functional", "_dtensor") else None)
        if kind is not None:
            self.bytes[kind] += sum(
                t.numel() * t.element_size()
                for t in tree_leaves(args[0]) if isinstance(t, torch.Tensor))
            self.ops[kind] += 1
        return func(*args, **(kwargs or {}))

    def counts(self) -> dict:
        out: dict = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        out["op_counts"] = dict(self.ops)
        return out


class Flops(TorchDispatchMode):
    """FLOPs of a step on a mesh, by ``torch.utils.flop_counter``'s
    formulas.  By default each ``DTensor`` op counts once at its global
    shape (the whole mesh's work, as ``FlopCounterMode`` counts it), and
    an op a model runs on its local shards itself (``shard.by_queries``)
    counts times the number of ranks that split it (``shard.split()``).
    With ``per_rank`` it counts the ops this rank runs on its shards (the
    per-rank ops DTensor issues): the counterpart of the reference's
    per-device HLO FLOPs; over the even share (the global count over the
    ranks) it is the work a layout repeats on every rank.  The global
    counter goes on top of the mode stack, where it sees ``DTensor`` ops,
    the per-rank one below ``LiveBytes``, where DTensor's own ops reach
    it."""

    def __init__(self, per_rank: bool = False):
        super().__init__()
        self.per_rank = per_rank
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        from repro_torch.models import sharding as shard
        whole = not _local_only(types)
        if whole and self.per_rank:
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            n = count(*args, **kwargs, out_val=out)
            self.flops += n if whole or self.per_rank else n * shard.split()
        return out


class LiveBytes(TorchDispatchMode):
    """The peak, over the mode's lifetime, of the bytes held by the buffers
    that the step's ops made and that are still alive: each op's output
    (a ``DTensor``'s local shard on this rank), each storage counted once,
    from the op that made it until it is freed.  Storages of ``held``
    (the step's inputs) are not counted, and neither are the tensors that
    DTensor makes at global shape to infer an op's output (the mode sees
    the ``DTensor`` op and not what runs inside it).  With meta tensors
    nothing is allocated: it is the step's transient memory, the
    counterpart of XLA's ``temp_size_in_bytes``."""

    def __init__(self, held=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: dict = {}
        self._held = {id(_local(t).untyped_storage()) for t in held}

    def _free(self, key: int, nbytes: int) -> None:
        self._refs.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = _local(t).untyped_storage()
            key = id(st)
            if key in self._refs or key in self._held:
                continue
            nbytes = st.nbytes()
            self._refs[key] = weakref.ref(
                st, lambda _, k=key, n=nbytes: self._free(k, n))
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor``; any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def roofline_terms(cost: dict[str, Any], coll: dict, n_chips: int,
                   model_flops_global: float,
                   analytic_flops_global: float | None = None,
                   analytic_bytes_chip: float | None = None) -> dict:
    """The reference's roofline record, with the H100's peaks.  ``cost``
    holds the measured per-chip ``flops`` and ``bytes accessed`` (the dry
    run: counted FLOPs over the chips; no byte count)."""
    hlo_flops = float(cost.get("flops", 0.0) or 0.0)
    hlo_bytes = float(cost.get("bytes accessed", 0.0) or 0.0)
    flops_chip = (analytic_flops_global / n_chips
                  if analytic_flops_global else hlo_flops)
    bytes_chip = (analytic_bytes_chip
                  if analytic_bytes_chip is not None else hlo_bytes)
    compute_s = flops_chip / PEAK_FLOPS
    memory_s = bytes_chip / HBM_BW
    coll_s = coll["total"] / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "analytic_flops_per_chip": flops_chip,
        "analytic_bytes_per_chip": bytes_chip,
        "hlo_flops_per_chip_measured": hlo_flops,
        "hlo_bytes_per_chip_measured": hlo_bytes,
        "collective_bytes_per_chip": coll["total"],
        "collective_breakdown": {k: v for k, v in coll.items()
                                 if k not in ("total", "op_counts")},
        "collective_op_counts": coll["op_counts"],
        "model_flops_global": model_flops_global,
        "useful_flops_ratio": (model_flops_global / (flops_chip * n_chips)
                               if flops_chip else 0.0),
        "roofline_fraction": (model_flops_global / n_chips / PEAK_FLOPS
                              / max(max(terms.values()), 1e-30)),
    }
