"""The analytic cost model of a model step: FLOPs, model FLOPs, active
parameters and HBM bytes from a config's shapes.

The port of the analytic half of the JAX package's
``repro.launch.roofline`` (plain arithmetic on a config, the same
numbers); its other half, the collective bytes parsed from a compiled
dry run's HLO text, has no torch counterpart and waits for the port of
``launch/dryrun.py`` and ``launch/mesh.py``.  FLOPs come from the
inventory of every matrix product the models compute; memory bytes from
a traffic model of the weights, the optimizer state and each layer's
major intermediates.

The peaks are one NVIDIA H100 SXM's, from NVIDIA's data sheet (dense
rates at the 700 W power limit), not a measurement.
"""
from __future__ import annotations

import torch

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
