"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The port of the JAX package's ``repro.models.encdec``.  The modality
frontend is a STUB: the caller passes precomputed frame embeddings (B,
n_frames, d) instead of the mel+conv stack.  Encoder: bidirectional
attention + GELU MLP, sinusoidal positions, LayerNorm.  Decoder: causal
self-attention + cross-attention + GELU MLP, learned positions.  The
layers are ``nn.ModuleList``s run in a loop.  Decode caches hold the
decoder's self-attention keys and values, stacked over its layers and
updated in place at ``pos``; the cross-attention reads the encoder output
the caller passes (``enc_out``).  ``loss`` is the training objective.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import sharding as shard
from repro_torch.models.layers import Params, full, normal
from repro_torch.models.transformer import LMConfig, chunked_nll

POS_DEC = 40960     # rows of the learned decoder position table


def _sinusoid(n: int, d: int, dtype, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).to(dtype)


def _norms(mod: Params, d: int, dtype, device, names) -> None:
    for n in names:
        setattr(mod, f"ln{n}", full((d,), 1.0, dtype, device))
        setattr(mod, f"lb{n}", full((d,), 0.0, dtype, device))


class EncLayer(Params):
    """``ln1``/``lb1``, ``attn``, ``ln2``/``lb2``, ``mlp`` (GELU)."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        self.cfg = cfg
        _norms(self, cfg.d_model, cfg.dtype, device, (1, 2))
        self.attn = L.Attention(cfg.attn_dims(), cfg.dtype, device, gen)
        self.mlp = L.GeluMLP(cfg.d_model, cfg.d_ff, cfg.dtype, device, gen)

    def forward(self, h, positions):
        return _enc_layer(self, h, self.cfg, positions)


class DecLayer(Params):
    """``ln1..3``/``lb1..3``, ``self_attn``, ``cross_attn``, ``mlp``."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        self.cfg = cfg
        _norms(self, cfg.d_model, cfg.dtype, device, (1, 2, 3))
        self.self_attn = L.Attention(cfg.attn_dims(), cfg.dtype, device, gen)
        self.cross_attn = L.Attention(cfg.attn_dims(), cfg.dtype, device,
                                      gen)
        self.mlp = L.GeluMLP(cfg.d_model, cfg.d_ff, cfg.dtype, device, gen)

    def forward(self, h, enc_out, positions):
        return _dec_layer(self, h, self.cfg, enc_out, positions)


class EncDec(Params):
    """The reference's ``init_encdec`` pytree as modules."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        self.cfg = cfg
        dt, d = cfg.dtype, cfg.d_model
        self.embed = normal(gen, (cfg.vocab, d), dt, device, 0.02)
        self.pos_dec = normal(gen, (POS_DEC, d), dt, device, 0.01)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, device, gen)
                                        for _ in range(cfg.n_layers))
        self.dec_layers = nn.ModuleList(
            DecLayer(cfg, device, gen)
            for _ in range(cfg.dec_layers or cfg.n_layers))
        self.enc_norm = full((d,), 1.0, dt, device)
        self.enc_norm_b = full((d,), 0.0, dt, device)
        self.final_norm = full((d,), 1.0, dt, device)
        self.final_norm_b = full((d,), 0.0, dt, device)
        self.unembed = normal(gen, (d, cfg.vocab), dt, device,
                              float(d) ** -0.5)

    def forward(self, frames, tokens):
        return decode_train(self, self.cfg, encode(self, self.cfg, frames),
                            tokens)


def init_encdec(gen: torch.Generator | None, cfg: LMConfig,
                device) -> EncDec:
    return EncDec(cfg, device, gen)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _enc_layer(lp, h, cfg: LMConfig, positions):
    z = L.layer_norm(h, lp["ln1"], lp["lb1"])
    h = h + shard.sp(L.attn_forward(lp["attn"], z, cfg.attn_dims(),
                                    positions, causal=False, use_rope=False))
    z = L.layer_norm(h, lp["ln2"], lp["lb2"])
    return h + shard.sp(L.gelu_mlp(lp["mlp"], z))


def encode(params, cfg: LMConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, n_frames, d): precomputed embeddings (frontend stub)."""
    b, s, d = frames.shape
    x = frames + _sinusoid(s, d, frames.dtype, frames.device)[None]
    positions = _positions(b, s, frames.device)
    for lp in params["enc_layers"]:
        x = shard.sp(_enc_layer(lp, x, cfg, positions))
    return shard.rows(L.layer_norm(x, params["enc_norm"],
                                   params["enc_norm_b"]))


def _cross_attn(p, x, enc_out, cfg: LMConfig):
    x = shard.rows(x)
    dims = cfg.attn_dims()
    h, kv, hd = dims.n_heads, dims.n_kv, dims.head_dim
    q = shard.split_heads(x @ p["wq"], h, hd)
    k = shard.split_heads(enc_out @ p["wk"], kv, hd)
    v = shard.split_heads(enc_out @ p["wv"], kv, hd)
    o = L.attention_scores(q, L.repeat_kv(k, h // kv),
                           L.repeat_kv(v, h // kv), causal=False)
    return shard.merge_heads(o) @ p["wo"]


def _dec_layer(lp, h, cfg: LMConfig, enc_out, positions):
    z = L.layer_norm(h, lp["ln1"], lp["lb1"])
    h = h + shard.sp(L.attn_forward(lp["self_attn"], z, cfg.attn_dims(),
                                    positions, causal=True, use_rope=False))
    z = L.layer_norm(h, lp["ln2"], lp["lb2"])
    h = h + shard.sp(_cross_attn(lp["cross_attn"], z, enc_out, cfg))
    z = L.layer_norm(h, lp["ln3"], lp["lb3"])
    return h + shard.sp(L.gelu_mlp(lp["mlp"], z))


def _dec_hidden(params, cfg: LMConfig, enc_out, tokens):
    b, s = tokens.shape
    x = shard.lookup(params["embed"], tokens) \
        + shard.constrain(params["pos_dec"], None, None)[:s][None]
    positions = _positions(b, s, tokens.device)
    for lp in params["dec_layers"]:
        x = shard.sp(_dec_layer(lp, x, cfg, enc_out, positions))
    return shard.rows(L.layer_norm(x, params["final_norm"],
                                   params["final_norm_b"]))


def decode_train(params, cfg: LMConfig, enc_out, tokens):
    """Teacher-forced decoder: tokens (B, S_dec) -> logits."""
    return _dec_hidden(params, cfg, enc_out, tokens) @ params["unembed"]


def prefill_last_logits(params, cfg: LMConfig, frames, tokens):
    enc = encode(params, cfg, frames)
    x = _dec_hidden(params, cfg, enc, tokens)
    return x[:, -1, :] @ params["unembed"]


def loss(params, cfg: LMConfig, frames, tokens, targets):
    """Mean next-token cross-entropy of the teacher-forced decoder, over
    sequence chunks as ``transformer.lm_loss`` computes it."""
    enc = encode(params, cfg, frames)
    x = _dec_hidden(params, cfg, enc, tokens)
    return chunked_nll(x, targets, params["unembed"])


def init_decode_caches(cfg: LMConfig, batch: int, max_seq: int,
                       device) -> dict:
    dims = cfg.attn_dims()
    shape = (cfg.dec_layers or cfg.n_layers, batch, max_seq, dims.n_kv,
             dims.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _self_attn_decode(p, x, cfg: LMConfig, ck, cv, pos):
    """The decoder's self-attention for one token (no rope): the new k, v
    written at ``pos`` in place."""
    dims = cfg.attn_dims()
    h, kv, hd = dims.n_heads, dims.n_kv, dims.head_dim
    q = shard.split_heads(x @ p["wq"], h, hd)
    k = shard.split_heads(x @ p["wk"], kv, hd)
    v = shard.split_heads(x @ p["wv"], kv, hd)
    shard.put_rows(ck, pos, k[:, 0])
    shard.put_rows(cv, pos, v[:, 0])
    kv_valid = torch.arange(ck.shape[1], device=x.device)[None, :] \
        <= pos[:, None]
    o = L.attention_scores(q, L.repeat_kv(shard.unshard_heads(ck), h // kv),
                           L.repeat_kv(shard.unshard_heads(cv), h // kv),
                           causal=False, kv_valid=kv_valid)
    return shard.merge_heads(o) @ p["wo"]


def decode_step(params, cfg: LMConfig, token, caches: dict, pos, enc_out):
    """One decoder step with cross-attention over the (precomputed)
    encoder output.  Returns (logits (B, vocab), caches)."""
    x = shard.lookup(params["embed"], token)[:, None, :] \
        + shard.lookup(params["pos_dec"], pos)[:, None]
    for i, lp in enumerate(params["dec_layers"]):
        z = L.layer_norm(x, lp["ln1"], lp["lb1"])
        x = x + shard.sp(_self_attn_decode(lp["self_attn"], z, cfg,
                                           caches["k"][i], caches["v"][i],
                                           pos))
        z = L.layer_norm(x, lp["ln2"], lp["lb2"])
        x = x + shard.sp(_cross_attn(lp["cross_attn"], z, enc_out, cfg))
        z = L.layer_norm(x, lp["ln3"], lp["lb3"])
        x = x + shard.sp(L.gelu_mlp(lp["mlp"], z))
    x = L.layer_norm(x, params["final_norm"], params["final_norm_b"])
    return (x @ params["unembed"])[:, 0, :], caches
