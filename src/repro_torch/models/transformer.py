"""Decoder-only LM stack covering the dense, MoE, SSM, hybrid and VLM
families.

The port of the JAX package's ``repro.models.transformer``.  Each layer is
an ``nn.Module`` (``AttnBlock``, ``SSMBlock``) and the stack is an
``nn.ModuleList``, run in a Python loop (the reference stacks the layers
on a leading axis and scans them).  Hybrid models (Zamba2) run segments:
``ssm_per_segment`` Mamba2 layers, then one SHARED attention block applied
once per segment.  VLMs prepend projected ``patch_embeds``.

Modes:
  forward(tokens | patches)       -> logits             (forward compute)
  lm_loss(tokens, targets)        -> mean next-token NLL (training)
  prefill_last_logits(tokens)     -> last logits        (the reference's)
  prefill(tokens, caches)         -> last logits, caches (fills the caches)
  decode_step(token, caches, pos) -> logits, caches     (one step)

Decode caches are the reference's dict of layer-stacked tensors, updated
in place at ``pos`` and returned.  ``kv_quant`` keeps an int8 KV cache
with a per-position scale, quantising only the new position each step.
The reference's sharding hints (``shard.constrain``: the
sequence-parallel residual stream) sit where the reference has them and
act on ``DTensor``s only (``models/sharding.py``), as do the layouts
DTensor needs besides (a layer's input gathered, heads whole, branch
outputs placed as the stream).  With ``cfg.remat`` each layer (for the
hybrid, the shared attention block, as the reference wraps them) runs
under ``torch.utils.checkpoint`` while autograd records, so its
activations are recomputed in the backward; serving records nothing and
recomputes nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding as shard
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Params, full, normal


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Language-model architecture configuration."""
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM
    d_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    # hybrid (Zamba2-style shared attention)
    ssm_per_segment: int = 0    # >0 => hybrid: segments of ssm + shared attn
    # frontends (vlm / audio stubs)
    n_patches: int = 0          # vlm: prepended image patch embeddings
    n_frames: int = 0           # audio: encoder frame count (encdec only)
    dec_layers: int = 0         # encdec: decoder depth (n_layers = encoder)
    dtype: Any = torch.float32
    remat: bool = False         # activation checkpointing (training only)
    kv_quant: bool = False      # int8 KV cache (decode path), per position

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_dims(self) -> L.AttnDims:
        return L.AttnDims(self.d_model, self.n_heads, self.n_kv, self.hd,
                          self.qkv_bias, self.rope_theta)

    def ssm_dims(self) -> ssm_mod.SSMDims:
        return ssm_mod.SSMDims(self.d_model, self.d_state, self.ssm_expand,
                               self.ssm_headdim)

    @property
    def n_segments(self) -> int:
        if self.ssm_per_segment <= 0:
            raise ValueError(f"{self.arch_id} is not a hybrid")
        return self.n_layers // self.ssm_per_segment


# --------------------------------------------------------------------------
# blocks and init
# --------------------------------------------------------------------------

class AttnBlock(Params):
    """``ln1``, ``attn``, ``ln2`` and ``mlp`` (SwiGLU) or ``moe``: a dense,
    MoE or VLM layer, and the hybrid's shared block."""

    def __init__(self, cfg: LMConfig, device, gen=None, moe: bool = False):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.ln1 = full((cfg.d_model,), 1.0, dt, device)
        self.ln2 = full((cfg.d_model,), 1.0, dt, device)
        self.attn = L.Attention(cfg.attn_dims(), dt, device, gen)
        if moe:
            self.moe = moe_mod.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, dt,
                                   device, gen)
        else:
            self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, dt, device, gen)

    def forward(self, x, positions):
        return _attn_layer(self, x, self.cfg, positions)


class SSMBlock(Params):
    """``ln1`` and ``ssm``: a Mamba2 layer."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = full((cfg.d_model,), 1.0, cfg.dtype, device)
        self.ssm = ssm_mod.SSM(cfg.ssm_dims(), cfg.dtype, device, gen)

    def forward(self, x):
        return _ssm_layer(self, x, self.cfg)


class LM(Params):
    """The reference's ``init_lm`` pytree as modules: ``embed``,
    ``final_norm``, ``unembed``, ``layers`` (a ModuleList; for the hybrid,
    one ModuleList of SSM blocks per segment), ``shared_attn`` (hybrid)
    and ``patch_proj`` (vlm)."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.embed = normal(gen, (cfg.vocab, cfg.d_model), dt, device, 0.02)
        self.final_norm = full((cfg.d_model,), 1.0, dt, device)
        self.unembed = normal(gen, (cfg.d_model, cfg.vocab), dt, device,
                              float(cfg.d_model) ** -0.5)
        if cfg.family in ("dense", "moe", "vlm"):
            self.layers = nn.ModuleList(
                AttnBlock(cfg, device, gen, moe=cfg.family == "moe")
                for _ in range(cfg.n_layers))
        elif cfg.family == "ssm":
            self.layers = nn.ModuleList(SSMBlock(cfg, device, gen)
                                        for _ in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            self.layers = nn.ModuleList(
                nn.ModuleList(SSMBlock(cfg, device, gen)
                              for _ in range(cfg.ssm_per_segment))
                for _ in range(cfg.n_segments))
            self.shared_attn = AttnBlock(cfg, device, gen)
        else:
            raise ValueError(cfg.family)
        if cfg.family == "vlm":
            # frontend stub: projection applied to precomputed patch embeds
            self.patch_proj = normal(gen, (cfg.d_model, cfg.d_model), dt,
                                     device, 0.02)

    def forward(self, tokens, patch_embeds=None):
        return forward(self, self.cfg, tokens, patch_embeds)


def init_lm(gen: torch.Generator | None, cfg: LMConfig, device) -> LM:
    """Parameters with the reference's shapes, scales and dtypes, drawn
    from ``gen`` (left empty without one, and on the meta device)."""
    return LM(cfg, device, gen)


# --------------------------------------------------------------------------
# layer bodies
# --------------------------------------------------------------------------

def _attn_layer(lp, h, cfg: LMConfig, positions, caches: dict | None = None,
                i: int = 0):
    """One attention layer over a whole sequence (causal, rope); with
    ``caches``, its (k, v) go into layer ``i``'s caches at [0, S)."""
    z = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    att, (k, v) = L.attn_prefill(lp["attn"], z, cfg.attn_dims(), positions)
    if caches is not None:
        s = k.shape[1]
        if cfg.kv_quant:
            for name, new in (("k", k), ("v", v)):
                codes, scale = _quantize(new)
                caches[name][i, :, :s] = codes
                caches[f"{name}_scale"][i, :, :s] = scale
        else:
            caches["k"][i, :, :s] = k
            caches["v"][i, :, :s] = v
    return _mlp_half(lp, h + shard.sp(att), cfg)


def _ssm_layer(lp, h, cfg: LMConfig, caches: dict | None = None,
               at: tuple = ()):
    """One Mamba2 layer over a whole sequence; with ``caches``, the state
    and conv tail after it go into ``caches["h"][at]`` and
    ``caches["conv"][at]``."""
    z = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    out = ssm_mod.ssm_forward(lp["ssm"], z, cfg.ssm_dims(),
                              chunk=cfg.ssm_chunk,
                              return_state=caches is not None)
    if caches is None:
        return h + shard.sp(out)
    y, (nh, nconv) = out
    caches["h"][at].copy_(nh)
    caches["conv"][at].copy_(nconv)
    return h + shard.sp(y)


def _mlp_half(lp, h, cfg: LMConfig):
    """The second half of an attention block: the residual MLP or MoE."""
    z = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        return h + shard.sp(moe_mod.moe_forward(lp["moe"], z, cfg.top_k,
                                           cfg.capacity_factor))
    return h + shard.sp(L.swiglu(lp["mlp"], z))


def _maybe_remat(cfg: LMConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward under ``cfg.remat``."""
    return L.recompute(fn, *args) if cfg.remat else fn(*args)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _embed(params, cfg: LMConfig, tokens, patch_embeds=None):
    x = shard.lookup(params["embed"], tokens)
    if cfg.family == "vlm":
        if patch_embeds is None:
            raise ValueError("a vlm forward takes patch_embeds")
        pe = patch_embeds.to(x.dtype) @ params["patch_proj"]
        x = torch.cat([pe, x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions


def forward(params, cfg: LMConfig, tokens, patch_embeds=None):
    """tokens (B, S) -> logits (B, S, vocab).  For a vlm, ``patch_embeds``
    (B, n_patches, d) are projected and prepended (their logits come out
    too)."""
    return _hidden(params, cfg, tokens, patch_embeds) @ params["unembed"]


def _hidden(params, cfg: LMConfig, tokens, patch_embeds=None,
            caches: dict | None = None):
    """The backbone without the unembed projection.  With ``caches`` it
    also writes the prompt's decode state into them (``prefill``)."""
    x, positions = _embed(params, cfg, tokens, patch_embeds)
    x = shard.sp(x)
    if cfg.family in ("dense", "moe", "vlm"):
        for i, lp in enumerate(params["layers"]):
            x = shard.sp(_maybe_remat(cfg, _attn_layer, lp, x, cfg,
                                      positions, caches, i))
    elif cfg.family == "ssm":
        for i, lp in enumerate(params["layers"]):
            x = shard.sp(_maybe_remat(cfg, _ssm_layer, lp, x, cfg, caches,
                                      (i,)))
    elif cfg.family == "hybrid":
        for i, seg in enumerate(params["layers"]):
            for j, lp in enumerate(seg):
                x = shard.sp(_ssm_layer(lp, x, cfg, caches, (i, j)))
            x = shard.sp(_maybe_remat(cfg, _attn_layer, params["shared_attn"],
                                      x, cfg, positions, caches, i))
    else:
        raise ValueError(cfg.family)
    return shard.rows(L.rms_norm(x, params["final_norm"], cfg.norm_eps))


def prefill(params, cfg: LMConfig, tokens, caches: dict | None = None,
            patch_embeds=None):
    """The whole-sequence backbone, logits of the LAST position only.
    With ``caches`` (the serving prefill) the prompt's decode state goes
    into them (the KV caches at positions [0, S), the SSM state and conv
    tail after the prompt), so that ``decode_step`` continues at ``pos =
    S``.  Returns (last logits, caches)."""
    x = _hidden(params, cfg, tokens, patch_embeds, caches)
    return x[:, -1, :] @ params["unembed"], caches


def prefill_last_logits(params, cfg: LMConfig, tokens, patch_embeds=None):
    """The whole-sequence backbone, logits of the LAST position only."""
    return prefill(params, cfg, tokens, None, patch_embeds)[0]


LOSS_CHUNK = 1024  # sequence chunk for the cross-entropy (bounds (B,c,V) temp)


def _chunk_ll(xc, tc, unembed):
    """Sum of the targets' log-probabilities over one chunk, in fp32."""
    logp = torch.log_softmax((xc @ unembed).float(), dim=-1)
    # row by row on each rank's rows: DTensor's gather backward makes its
    # zeros at the global shape on every rank
    return shard.local_rows(_pick, logp, tc).sum()


def _pick(logp, tc):
    return torch.gather(logp, -1, tc[..., None].long())


def chunked_nll(x, targets, unembed):
    """Mean negative log-likelihood of ``targets`` (B, S) under ``x @
    unembed`` (x: (B, S, d)), over sequence chunks of ``LOSS_CHUNK`` (the
    whole sequence when it does not divide), summed in chunk order.  Each
    chunk's (B, c, V) logits are recomputed in the backward, not kept."""
    b, s, _ = x.shape
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        chunk = s
    # on a mesh the head is gathered over "data" (its width), as XLA does:
    # a product over a sharded width would all-reduce (B, c, V) partials
    unembed = shard.constrain(unembed, None, "model")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, s, chunk):
        tot = tot + L.recompute(_chunk_ll, x[:, c:c + chunk],
                                targets[:, c:c + chunk], unembed)
    return -tot / (b * s)


def lm_loss(params, cfg: LMConfig, tokens, targets, patch_embeds=None):
    """Mean next-token cross-entropy of ``targets`` (B, S); a vlm's patch
    positions are left out."""
    x = _hidden(params, cfg, tokens, patch_embeds)
    if cfg.family == "vlm":
        x = x[:, cfg.n_patches:, :]
    return chunked_nll(x, targets, params["unembed"])


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------

def init_decode_caches(cfg: LMConfig, batch: int, max_seq: int,
                       device) -> dict:
    """Static-shape decode state: KV caches for the attention layers,
    (h, conv) state for the SSM layers, each stacked over the layers."""
    dt = cfg.dtype
    hd, kv = cfg.hd, cfg.n_kv

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family in ("dense", "moe", "vlm"):
        shape = (cfg.n_layers, batch, max_seq, kv, hd)
        if cfg.kv_quant:
            return {"k": z(*shape, dtype=torch.int8),
                    "v": z(*shape, dtype=torch.int8),
                    "k_scale": z(*shape[:3], dtype=torch.float32),
                    "v_scale": z(*shape[:3], dtype=torch.float32)}
        return {"k": z(*shape), "v": z(*shape)}
    sd = cfg.ssm_dims()
    state = (batch, sd.n_heads, sd.headdim, sd.d_state)
    conv = (batch, sd.conv_width - 1, sd.d_conv_ch)
    if cfg.family == "ssm":
        return {"h": z(cfg.n_layers, *state, dtype=torch.float32),
                "conv": z(cfg.n_layers, *conv)}
    if cfg.family == "hybrid":
        nseg, per = cfg.n_segments, cfg.ssm_per_segment
        return {"h": z(nseg, per, *state, dtype=torch.float32),
                "conv": z(nseg, per, *conv),
                # the shared block: one cache per segment's application
                "k": z(nseg, batch, max_seq, kv, hd),
                "v": z(nseg, batch, max_seq, kv, hd)}
    raise ValueError(cfg.family)


def _quantize(x: torch.Tensor):
    """(..., kv, hd) -> int8 codes and the per-position fp32 scale."""
    xf = x.float()
    scale = xf.abs().amax(dim=(-2, -1)) / 127.0 + 1e-9
    codes = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127)
    return codes.to(torch.int8), scale


def _dequantize(codes: torch.Tensor, scale: torch.Tensor, dtype):
    return codes.to(dtype) * scale[..., None, None].to(dtype)


def _attn_decode_layer(lp, h, cfg: LMConfig, caches: dict, i: int, pos):
    """One attention layer's decode step, its caches updated at ``pos``."""
    z = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    if cfg.kv_quant:
        ck = _dequantize(caches["k"][i], caches["k_scale"][i], cfg.dtype)
        cv = _dequantize(caches["v"][i], caches["v_scale"][i], cfg.dtype)
        att, (nk, nv) = L.attn_decode(lp["attn"], z, cfg.attn_dims(), ck,
                                      cv, pos)
        # quantise ONLY the new position back into the int8 cache
        b_idx = torch.arange(h.shape[0], device=h.device)
        for name, new in (("k", nk[b_idx, pos]), ("v", nv[b_idx, pos])):
            codes, scale = _quantize(new)
            caches[name][i, b_idx, pos] = codes
            caches[f"{name}_scale"][i, b_idx, pos] = scale
    else:
        att, _ = L.attn_decode(lp["attn"], z, cfg.attn_dims(),
                               caches["k"][i], caches["v"][i], pos)
    return _mlp_half(lp, h + shard.sp(att), cfg)


def _ssm_decode_layer(lp, h, cfg: LMConfig, hs: torch.Tensor,
                      conv: torch.Tensor):
    z = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    y, (nh, nconv) = ssm_mod.ssm_decode(lp["ssm"], z, cfg.ssm_dims(), hs,
                                        conv)
    hs.copy_(nh)
    conv.copy_(nconv)
    return h + shard.sp(y)


def decode_step(params, cfg: LMConfig, token, caches: dict, pos):
    """token (B,) -> (logits (B, vocab), caches).  ``pos`` (B,) is the
    index the new token takes (the caches hold what precedes it); the
    caches are updated in place and returned."""
    x = shard.lookup(params["embed"], token)[:, None, :]     # (B, 1, d)
    if cfg.family in ("dense", "moe", "vlm"):
        for i, lp in enumerate(params["layers"]):
            x = _attn_decode_layer(lp, x, cfg, caches, i, pos)
    elif cfg.family == "ssm":
        for i, lp in enumerate(params["layers"]):
            x = _ssm_decode_layer(lp, x, cfg, caches["h"][i],
                                  caches["conv"][i])
    elif cfg.family == "hybrid":
        for i, seg in enumerate(params["layers"]):
            for j, lp in enumerate(seg):
                x = _ssm_decode_layer(lp, x, cfg, caches["h"][i, j],
                                      caches["conv"][i, j])
            x = _attn_decode_layer(params["shared_attn"], x, cfg, caches, i,
                                   pos)
    else:
        raise ValueError(cfg.family)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["unembed"])[:, 0, :], caches
