"""Mamba2 (SSD, state-space duality) block: the chunked scan for forward
and prefill, and the O(1)-per-token recurrent decode.

The port of the JAX package's ``repro.models.ssm``.  d_inner = expand *
d_model, H = d_inner / headdim heads, shared (ngroups=1) B/C of size N =
d_state, a scalar A per head, softplus dt with a bias, a width-4 causal
depthwise conv on (x, B, C) and a gated RMSNorm output.

The scan uses the SSD block decomposition with chunk length L: the
intra-chunk term is an (L x L) masked "attention" per head, the
inter-chunk term carries the (B, H, P, N) state from chunk to chunk (a
Python loop over the chunks: the reference's ``lax.scan``; while autograd
records, each chunk is recomputed in the backward, as the reference's
``jax.checkpoint`` on the scan body does).  Decode is the
recurrence ``h <- h * exp(dt*A) + dt * (x ⊗ B);  y = C·h + D*x``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import sharding as shard
from repro_torch.models.layers import Params, full, normal


@dataclasses.dataclass(frozen=True)
class SSMDims:
    """State-space (Mamba-style) block dimensions."""
    d_model: int
    d_state: int = 128
    expand: int = 2
    headdim: int = 64
    conv_width: int = 4

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def d_conv_ch(self) -> int:
        return self.d_inner + 2 * self.d_state

    @property
    def d_in_proj(self) -> int:
        return 2 * self.d_inner + 2 * self.d_state + self.n_heads


class SSM(Params):
    """The reference's ``init_ssm``: ``in_proj``, ``conv_w``, ``conv_b``,
    ``a_log``, ``d_skip``, ``dt_bias`` (fp32), ``norm_scale``,
    ``out_proj``."""

    def __init__(self, dims: SSMDims, dtype, device, gen=None):
        super().__init__()
        self.dims = dims
        f32 = torch.float32
        self.in_proj = normal(gen, (dims.d_model, dims.d_in_proj), dtype,
                              device, float(dims.d_model) ** -0.5)
        self.conv_w = normal(gen, (dims.conv_width, dims.d_conv_ch), dtype,
                             device, 0.2)
        self.conv_b = full((dims.d_conv_ch,), 0.0, dtype, device)
        self.a_log = full((dims.n_heads,), 0.0, f32, device)  # A = -1
        self.d_skip = full((dims.n_heads,), 1.0, f32, device)
        self.dt_bias = full((dims.n_heads,), 0.0, f32, device)
        self.norm_scale = full((dims.d_inner,), 1.0, dtype, device)
        self.out_proj = normal(gen, (dims.d_inner, dims.d_model), dtype,
                               device, float(dims.d_inner) ** -0.5)

    def forward(self, x, chunk: int = 128):
        return ssm_forward(self, x, self.dims, chunk=chunk)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cache: torch.Tensor | None = None):
    """Depthwise causal conv over S.  xbc (B, S, C), w (W, C).  Returns
    (out (B, S, C), new_cache (B, W-1, C))."""
    width, s = w.shape[0], xbc.shape[1]
    pad = xbc.new_zeros(xbc.shape[0], width - 1, xbc.shape[2]) \
        if cache is None else cache
    xp = torch.cat([pad, xbc], dim=1)             # (B, S+W-1, C)
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s, :] * w[i]
    return F.silu(out + b), xp[:, -(width - 1):, :]


def _split_proj(p, x: torch.Tensor, dims: SSMDims):
    x = shard.rows(x)
    zxbcdt = x @ p["in_proj"]
    di, n = dims.d_inner, dims.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = F.softplus(zxbcdt[..., di + di + 2 * n:].float()
                    + shard.whole(p["dt_bias"]))
    return z, xbc, dt


def ssd_chunked(xh: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                dt: torch.Tensor, a: torch.Tensor,
                h0: torch.Tensor | None = None, chunk: int = 128):
    """SSD dual-form scan.  xh (B, S, H, P), bm and cm (B, S, N), dt
    (B, S, H) fp32, a (H,) fp32 negative.  Returns (y (B, S, H, P) fp32,
    h_final (B, H, P, N))."""
    b, s, h, p = xh.shape
    n = bm.shape[-1]
    # on a mesh each rank scans whole sequences (the state is carried
    # from chunk to chunk) of whole heads (``shard.split_heads``)
    xh, dt, bm, cm = map(shard.rows, (xh, dt, bm, cm))
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    xc = xh.reshape(b, nc, chunk, h, p).float()
    bc = bm.reshape(b, nc, chunk, n).float()
    cc = cm.reshape(b, nc, chunk, n).float()
    dtc = dt.reshape(b, nc, chunk, h)
    da = dtc * a                                   # (B, nc, L, H), <= 0
    hstate = xh.new_zeros(b, h, p, n, dtype=torch.float32) \
        if h0 is None else h0
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=xh.device))
    ys = []
    for c in range(nc):
        # the reference's per-chunk remat: the (B, L, L, H) intra-chunk
        # tensors are recomputed in the backward, not kept per chunk
        hstate, y = L.recompute(_ssd_chunk, hstate, xc[:, c], bc[:, c],
                                cc[:, c], da[:, c], dtc[:, c], causal)
        ys.append(y)
    return shard.rows(torch.stack(ys, dim=1).reshape(b, s, h, p)), hstate


def _ssd_chunk(hstate, xcs, bcs, ccs, dacs, dtcs, causal):
    """One chunk of the SSD scan: (the state after it, its output)."""
    # row by row on a mesh: DTensor has no rule for the flip of the
    # cumsum's backward in every torch version
    lcs = shard.local_rows(lambda t: torch.cumsum(t, dim=1), dacs)  # (B,L,H)
    # intra-chunk (masked attention form)
    cb = torch.einsum("bin,bjn->bij", ccs, bcs)                # (B, L, L)
    dmat = lcs[:, :, None, :] - lcs[:, None, :, :]             # (B, L, L, H)
    mat = torch.where(causal[None, :, :, None],
                      torch.exp(dmat) * dtcs[:, None, :, :],
                      torch.zeros((), device=xcs.device))
    mat = mat * cb[..., None]
    y_intra = torch.einsum("bijh,bjhp->bihp", mat, xcs)
    # inter-chunk (carry the state in)
    y_inter = torch.einsum("bin,bhpn->bihp", ccs, hstate)
    y_inter = y_inter * torch.exp(lcs)[:, :, :, None]
    # state update
    total = lcs[:, -1, :]                          # (B, H)
    decay_to_end = torch.exp(total[:, None, :] - lcs)          # (B, L, H)
    contrib = torch.einsum("bjhp,bjn->bhpn",
                           xcs * (dtcs * decay_to_end)[..., None], bcs)
    hnew = hstate * torch.exp(total)[:, :, None, None] + contrib
    return hnew, y_intra + y_inter


def ssm_forward(p, x: torch.Tensor, dims: SSMDims, chunk: int = 128,
                h0=None, conv_cache=None, return_state: bool = False):
    """The whole Mamba2 block, forward/prefill mode.  x (B, S, d_model)."""
    b, s, _ = x.shape
    di, n, h, pd = dims.d_inner, dims.d_state, dims.n_heads, dims.headdim
    z, xbc, dt = _split_proj(p, x, dims)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_cache)
    xi = shard.split_heads(xbc[..., :di], h, pd)
    bm = xbc[..., di:di + n]
    cm = xbc[..., di + n:]
    a = -torch.exp(shard.whole(p["a_log"]))
    y, h_final = ssd_chunked(xi, bm, cm, dt, a, h0=h0, chunk=min(chunk, s))
    y = y + shard.whole(p["d_skip"])[None, None, :, None] * xi.float()
    y = y.reshape(b, s, di).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm_scale"])
    out = y @ p["out_proj"]
    if return_state:
        return out, (h_final, new_conv)
    return out


def ssm_decode(p, x: torch.Tensor, dims: SSMDims, h: torch.Tensor,
               conv_cache: torch.Tensor):
    """One-token decode.  x (B, 1, d_model), h (B, H, P, N), conv_cache
    (B, W-1, C).  Returns (out, (h, conv_cache))."""
    b = x.shape[0]
    di, n, hh, pd = dims.d_inner, dims.d_state, dims.n_heads, dims.headdim
    z, xbc, dt = _split_proj(p, x, dims)          # (B, 1, ...)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_cache)
    xi = shard.split_heads(xbc[:, 0, :di], hh, pd)
    bm = xbc[:, 0, di:di + n]
    cm = xbc[:, 0, di + n:]
    dt0 = shard.constrain(dt[:, 0], shard.BATCH, "model")     # (B, H)
    a = -torch.exp(shard.whole(p["a_log"]))
    decay = torch.exp(dt0 * a)                     # (B, H)
    contrib = torch.einsum("bhp,bn->bhpn", xi.float() * dt0[..., None],
                           bm.float())
    # on a mesh, heads over "model" only where they divide (as the cache)
    h = shard.constrain(h * decay[:, :, None, None] + contrib, shard.BATCH,
                        "model", None, None)
    y = torch.einsum("bhpn,bn->bhp", h, cm.float())
    y = y + shard.whole(p["d_skip"])[None, :, None] * xi.float()
    y = y.reshape(b, 1, di).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm_scale"])
    return y @ p["out_proj"], (h, new_conv)
