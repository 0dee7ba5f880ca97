"""Shared layer primitives: norms, RoPE, GQA attention, MLPs.

The port of the JAX package's ``repro.models.layers``.  Conventions:

* every block is an ``nn.Module`` whose parameters carry the reference's
  names (``Params``: ``p["wq"]`` reads them as the reference's dict
  does), and whose ``forward`` is the reference's function;
* activations run in the config's dtype, norms and the softmax in fp32
  and are cast back, as in the reference;
* attention has three modes: full causal (forward/prefill), cached decode
  (one token against a static-size cache) and bidirectional (encoders).

Attention is computed in one piece up to ``FLASH_THRESHOLD`` and in query
chunks above it (``flash_attention``): the same function as
``attention_scores`` (each query row's softmax is its own), with the
(B, H, S, S) logits bounded to (B, H, q_chunk, S).  No kernel of the
reference lies here: its ``flash_attention`` is plain jnp too.

Parameters are drawn from an explicit ``torch.Generator`` with the
reference's shapes, scales and dtypes (torch cannot repeat
``jax.random``); on the ``meta`` device nothing is drawn or allocated.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import sharding as shard


class Params(nn.Module):
    """A block's parameters and sub-blocks under the reference's names."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter, made without a gradient so that serving records no
    autograd graph; ``model.make_train_step`` turns gradients on for the
    module it trains."""
    return nn.Parameter(t, requires_grad=False)


def recompute(fn, *args):
    """``fn(*args)``; while autograd records, its activations are not kept
    but recomputed in the backward (``torch.utils.checkpoint``: the
    reference's ``jax.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def normal(gen: torch.Generator | None, shape, dtype, device,
           scale: float) -> nn.Parameter:
    """``normal(key, shape, dtype) * scale`` as the reference draws it: a
    standard normal in ``dtype``, scaled in ``dtype``.  Without a
    generator (weights that will be loaded) or on the meta device nothing
    is drawn: the tensor is left empty."""
    device = torch.device(device)
    if gen is None or device.type == "meta":
        return param(torch.empty(shape, dtype=dtype, device=device))
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device).to(dtype) * scale
    return param(t.to(device))


def full(shape, value: float, dtype, device) -> nn.Parameter:
    return param(torch.full(shape, value, dtype=dtype, device=device))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (((xf - mu) * torch.rsqrt(var + eps)) * scale + bias).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on the split-halves layout.  x: (..., S, H, hd),
    positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., None] * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(..., S, n_kv, hd) -> (..., S, n_kv * n_rep, hd) (GQA head
    sharing: each kv head serves n_rep consecutive query heads)."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=-2)


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, q_offset: int = 0,
                     kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain softmax attention (fp32 softmax, masked to -1e30).
    q (B, S_q, H, hd), k and v (B, S_k, H, hd); ``kv_valid`` (B, S_k).
    Returns (B, S_q, H, hd)."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    s_q, s_k = q.shape[1], k.shape[1]
    if causal:
        qpos = torch.arange(s_q, device=q.device)[:, None] + q_offset
        kpos = torch.arange(s_k, device=q.device)[None, :]
        logits = logits.masked_fill(~(kpos <= qpos)[None, None], -1e30)
    if kv_valid is not None:
        logits = logits.masked_fill(~kv_valid[:, None, None, :], -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


FLASH_THRESHOLD = 2048  # attend in query chunks at/above this length


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, q_offset: int = 0,
                    q_chunk: int = 512) -> torch.Tensor:
    """``attention_scores`` over query chunks: the same function, with the
    live logits bounded to (B, H, q_chunk, S_k) for long sequences.  While
    autograd records, each chunk's logits are recomputed in the backward
    (the reference's flash blocks are rematerialised too)."""
    outs = [recompute(attention_scores, q[:, i:i + q_chunk], k, v, causal,
                      q_offset + i)
            for i in range(0, q.shape[1], q_chunk)]
    return torch.cat(outs, dim=1)


@dataclasses.dataclass(frozen=True)
class AttnDims:
    """Attention dimensions (heads, kv heads, head width, rope base)."""
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0


class Attention(Params):
    """GQA attention weights (``wq``, ``wk``, ``wv``, ``wo`` and, with
    ``qkv_bias``, ``bq``, ``bk``, ``bv``): the reference's ``init_attn``."""

    def __init__(self, dims: AttnDims, dtype, device, gen=None):
        super().__init__()
        self.dims = dims
        d, h, kv, hd = dims.d_model, dims.n_heads, dims.n_kv, dims.head_dim
        scale = float(d) ** -0.5
        self.wq = normal(gen, (d, h * hd), dtype, device, scale)
        self.wk = normal(gen, (d, kv * hd), dtype, device, scale)
        self.wv = normal(gen, (d, kv * hd), dtype, device, scale)
        self.wo = normal(gen, (h * hd, d), dtype, device, scale)
        if dims.qkv_bias:
            self.bq = full((h * hd,), 0.0, dtype, device)
            self.bk = full((kv * hd,), 0.0, dtype, device)
            self.bv = full((kv * hd,), 0.0, dtype, device)

    def forward(self, x, positions, causal: bool = True,
                use_rope: bool = True):
        return attn_forward(self, x, self.dims, positions, causal=causal,
                            use_rope=use_rope)


def _qkv(p, x: torch.Tensor, dims: AttnDims):
    x = shard.rows(x)
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if dims.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (shard.split_heads(q, dims.n_heads, dims.head_dim),
            shard.split_heads(k, dims.n_kv, dims.head_dim),
            shard.split_heads(v, dims.n_kv, dims.head_dim))


def attn_forward(p, x: torch.Tensor, dims: AttnDims,
                 positions: torch.Tensor, causal: bool = True,
                 use_rope: bool = True) -> torch.Tensor:
    s = x.shape[1]
    h, kv = dims.n_heads, dims.n_kv
    q, k, v = _qkv(p, x, dims)
    if use_rope:
        q = rope(q, positions, dims.rope_theta)
        k = rope(k, positions, dims.rope_theta)
    k, v = repeat_kv(k, h // kv), repeat_kv(v, h // kv)
    attend = flash_attention if s >= FLASH_THRESHOLD else attention_scores
    o = shard.by_queries(attend, q, k, v, causal)
    return shard.merge_heads(o) @ p["wo"]


def attn_prefill(p, x: torch.Tensor, dims: AttnDims,
                 positions: torch.Tensor):
    """Like ``attn_forward`` (causal, rope) but also returns the (k, v)
    cache, before the GQA repeat."""
    s = x.shape[1]
    h, kv = dims.n_heads, dims.n_kv
    q, k, v = _qkv(p, x, dims)
    q = rope(q, positions, dims.rope_theta)
    k = rope(k, positions, dims.rope_theta)
    attend = flash_attention if s >= FLASH_THRESHOLD else attention_scores
    o = shard.by_queries(attend, q, repeat_kv(k, h // kv),
                         repeat_kv(v, h // kv), True)
    return shard.merge_heads(o) @ p["wo"], (k, v)


def attn_decode(p, x: torch.Tensor, dims: AttnDims, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: torch.Tensor):
    """One-token decode against a static-size cache.  x (B, 1, d), caches
    (B, S_max, kv, hd), pos (B,): the new k and v are written at ``pos``
    (an indexed update, in place) and the token attends to positions
    <= pos.  Returns (out, (cache_k, cache_v))."""
    h, kv = dims.n_heads, dims.n_kv
    q, k, v = _qkv(p, x, dims)
    q = rope(q, pos[:, None], dims.rope_theta)
    k = rope(k, pos[:, None], dims.rope_theta)
    shard.put_rows(cache_k, pos, k[:, 0].to(cache_k.dtype))
    shard.put_rows(cache_v, pos, v[:, 0].to(cache_v.dtype))
    kv_valid = torch.arange(cache_k.shape[1],
                            device=x.device)[None, :] <= pos[:, None]
    o = attention_scores(q, repeat_kv(shard.unshard_heads(cache_k), h // kv),
                         repeat_kv(shard.unshard_heads(cache_v), h // kv),
                         causal=False, kv_valid=kv_valid)
    return shard.merge_heads(o) @ p["wo"], (cache_k, cache_v)


# ------------------------------- MLPs -------------------------------------

class SwiGLU(Params):
    """``w_gate``, ``w_up``, ``w_down``: the reference's ``init_swiglu``."""

    def __init__(self, d_model: int, d_ff: int, dtype, device, gen=None):
        super().__init__()
        s1, s2 = float(d_model) ** -0.5, float(d_ff) ** -0.5
        self.w_gate = normal(gen, (d_model, d_ff), dtype, device, s1)
        self.w_up = normal(gen, (d_model, d_ff), dtype, device, s1)
        self.w_down = normal(gen, (d_ff, d_model), dtype, device, s2)

    def forward(self, x):
        return swiglu(self, x)


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    x = shard.rows(x)
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


class GeluMLP(Params):
    """``w_up``, ``b_up``, ``w_down``, ``b_down``: the reference's
    ``init_gelu_mlp``."""

    def __init__(self, d_model: int, d_ff: int, dtype, device, gen=None):
        super().__init__()
        s1, s2 = float(d_model) ** -0.5, float(d_ff) ** -0.5
        self.w_up = normal(gen, (d_model, d_ff), dtype, device, s1)
        self.b_up = full((d_ff,), 0.0, dtype, device)
        self.w_down = normal(gen, (d_ff, d_model), dtype, device, s2)
        self.b_down = full((d_model,), 0.0, dtype, device)

    def forward(self, x):
        return gelu_mlp(self, x)


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    x = shard.rows(x)
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh") \
        @ p["w_down"] + p["b_down"]
