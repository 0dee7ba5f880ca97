"""The port's model primitives (``repro_torch.models.layers``, ``moe``,
``ssm``) against the JAX package's on the same inputs and weights.

Inputs are made from a seeded numpy ``Generator``; weights are the
reference's init (``jax.random.key``), carried across as numpy.  Every
float output is held within rtol=atol=1e-4 in fp32; the MoE's routing
(top-k choices with the reference's tie order, the per-row capacity, the
slot of every (token, choice) and the token of every slot) is equal as
integers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jL  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def load(mod, tree):
    """Copy a reference param dict into a port block of the same names."""
    for name, val in tree.items():
        child = getattr(mod, name)
        if isinstance(val, dict):
            load(child, val)
        else:
            child.data.copy_(t(val))
    return mod


def x_of(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_norms_and_rope(rng):
    x = x_of(rng, 2, 5, 3, 16)
    scale, bias = x_of(rng, 16), x_of(rng, 16)
    close(L.rms_norm(t(x), t(scale)), jL.rms_norm(x, scale))
    close(L.layer_norm(t(x), t(scale), t(bias)),
          jL.layer_norm(x, scale, bias))
    pos = rng.integers(0, 500, (2, 5))
    close(L.rope(t(x), t(pos), 500000.0), jL.rope(x, pos, 500000.0))
    close(L.repeat_kv(t(x), 3), jL.repeat_kv(x, 3))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_scores(rng, causal):
    q, k, v = (x_of(rng, 2, 7, 4, 8) for _ in range(3))
    valid = rng.random((2, 7)) < 0.7
    valid[:, 0] = True
    close(L.attention_scores(t(q), t(k), t(v), causal=causal),
          jL.attention_scores(q, k, v, causal=causal))
    close(L.attention_scores(t(q), t(k), t(v), causal=False,
                             kv_valid=t(valid)),
          jL.attention_scores(q, k, v, causal=False, kv_valid=valid))


def test_flash_attention_is_attention_scores(rng):
    """The port attends in query chunks above ``FLASH_THRESHOLD``: the
    reference's online-softmax ``flash_attention`` on the same inputs."""
    q, k, v = (x_of(rng, 1, 2048, 2, 8) for _ in range(3))
    got = L.flash_attention(t(q), t(k), t(v), causal=True)
    close(got, jL.flash_attention(q, k, v, causal=True))
    close(got, L.attention_scores(t(q), t(k), t(v), causal=True))


@pytest.mark.parametrize("bias,n_kv", [(False, 2), (True, 4)])
def test_attention_block_forward_prefill_decode(rng, bias, n_kv):
    dims = jL.AttnDims(32, 4, n_kv, 8, qkv_bias=bias)
    jp = jL.init_attn(jax.random.key(1), dims)
    if bias:    # the init's biases are zero; make them count
        jp = {k: (v + 0.1 * jnp.asarray(x_of(rng, *v.shape))
                  if k.startswith("b") else v) for k, v in jp.items()}
    p = load(L.Attention(L.AttnDims(32, 4, n_kv, 8, qkv_bias=bias),
                         torch.float32, "cpu"), jp)
    x = x_of(rng, 2, 6, 32)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    for causal, use_rope in ((True, True), (False, False)):
        close(p(t(x), t(pos), causal=causal, use_rope=use_rope),
              jL.attn_forward(jp, x, dims, pos, causal=causal,
                              use_rope=use_rope))
    got, (gk, gv) = L.attn_prefill(p, t(x), p.dims, t(pos))
    want, (wk, wv) = jL.attn_prefill(jp, x, dims, pos)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        close(g, w)
    ck, cv = x_of(rng, 2, 9, n_kv, 8), x_of(rng, 2, 9, n_kv, 8)
    step = np.array([3, 7])
    got, (gk, gv) = L.attn_decode(p, t(x[:, :1]), p.dims, t(ck), t(cv),
                                  t(step))
    want, (wk, wv) = jL.attn_decode(jp, x[:, :1], dims, jnp.asarray(ck),
                                   jnp.asarray(cv), jnp.asarray(step))
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        close(g, w)


def test_mlps(rng):
    x = x_of(rng, 2, 5, 16)
    jp = jL.init_swiglu(jax.random.key(2), 16, 40)
    close(load(L.SwiGLU(16, 40, torch.float32, "cpu"), jp)(t(x)),
          jL.swiglu(jp, x))
    jp = jL.init_gelu_mlp(jax.random.key(3), 16, 40)
    jp = dict(jp, b_up=jp["b_up"] + 0.3, b_down=jp["b_down"] - 0.2)
    close(load(L.GeluMLP(16, 40, torch.float32, "cpu"), jp)(t(x)),
          jL.gelu_mlp(jp, x))


# ---------------------------------- MoE -------------------------------------

def ref_routing(p, x, top_k, capacity_factor):
    """The reference's routing and slot maps (``repro/models/moe.py``'s
    ``moe_forward`` up to the dispatch), in jnp, step for step: its
    function computes them inside and returns only the combined output."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    logits = jnp.einsum("bsd,de->bse", x, p["router"]).astype(jnp.float32)
    gate_vals, sel = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, -1, keepdims=True), 1e-9)
    capacity = min(int(max(s * top_k / e * capacity_factor, 4)), s)
    flat_sel = sel.reshape(b, s * top_k)
    t_ = s * top_k

    def rank_row(sel_r):
        order = jnp.argsort(sel_r, stable=True)
        sorted_sel = sel_r[order]
        first = jnp.searchsorted(sorted_sel, sorted_sel, side="left")
        rank_sorted = jnp.arange(t_, dtype=jnp.int32) - first.astype(
            jnp.int32)
        return jnp.zeros((t_,), jnp.int32).at[order].set(rank_sorted)

    pos = jax.vmap(rank_row)(flat_sel)
    slot = jnp.where(pos < capacity, flat_sel * capacity + pos, e * capacity)

    def tok_row(slot_r):
        rows = jnp.repeat(jnp.arange(s, dtype=jnp.int32), top_k)
        tok = jnp.full((e * capacity + 1,), s, jnp.int32)
        return tok.at[slot_r].set(rows, mode="drop")[: e * capacity]

    return sel, gate_vals, slot, jax.vmap(tok_row)(slot), capacity


@pytest.mark.parametrize("e,k,s,cf,zero_router", [
    (4, 2, 32, 1.25, False), (8, 3, 24, 1.0, False), (4, 2, 16, 0.5, False),
    (6, 2, 12, 1.25, True)])
def test_moe_routing_and_forward(rng, e, k, s, cf, zero_router):
    """A zero router ties every expert: the reference's ``top_k`` takes the
    lower index first, and so must the port (a stable sort)."""
    jp = jmoe.init_moe(jax.random.key(4), 16, 24, e)
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = load(moe.MoE(16, 24, e, torch.float32, "cpu"), jp)
    x = x_of(rng, 3, s, 16)
    sel, gate, slot, tok, cap = ref_routing(jp, x, k, cf)
    r = moe.route(p, t(x), k, cf)
    assert r.capacity == cap
    np.testing.assert_array_equal(r.sel.numpy(), np.asarray(sel))
    np.testing.assert_array_equal(r.slot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(r.tok_for_slot.numpy(), np.asarray(tok))
    close(r.gate, gate)
    # capacity binds: some pair is dropped at cf <= 1
    assert (cf > 1.0) or (r.slot == e * cap).any()
    close(p(t(x), k, cf), jmoe.moe_forward(jp, x, k, cf))


# ---------------------------------- SSM -------------------------------------

def test_ssm_pieces(rng):
    jd = jssm.SSMDims(32, d_state=8, expand=2, headdim=16)
    d = ssm.SSMDims(32, d_state=8, expand=2, headdim=16)
    jp = jssm.init_ssm(jax.random.key(5), jd)
    jp = dict(jp, a_log=jp["a_log"] + 0.3, dt_bias=jp["dt_bias"] - 0.5,
              conv_b=jp["conv_b"] + 0.1)
    p = load(ssm.SSM(d, torch.float32, "cpu"), jp)
    x = x_of(rng, 2, 16, 32)
    z, xbc, dt = ssm._split_proj(p, t(x), d)
    for g, w in zip((z, xbc, dt), jssm._split_proj(jp, x, jd)):
        close(g, w)
    cache = x_of(rng, 2, 3, d.d_conv_ch)
    for c in (None, cache):
        got = ssm._causal_conv(xbc, p.conv_w, p.conv_b,
                               None if c is None else t(c))
        want = jssm._causal_conv(np.asarray(xbc), jp["conv_w"],
                                 jp["conv_b"], c)
        for g, w in zip(got, want):
            close(g, w)
    xh, bm, cm = (x_of(rng, 2, 16, 4, 16), x_of(rng, 2, 16, 8),
                  x_of(rng, 2, 16, 8))
    dtv = np.abs(x_of(rng, 2, 16, 4))
    a = -np.abs(x_of(rng, 4))
    h0 = x_of(rng, 2, 4, 16, 8)
    for chunk in (4, 16):
        got = ssm.ssd_chunked(t(xh), t(bm), t(cm), t(dtv), t(a), h0=t(h0),
                              chunk=chunk)
        want = jssm.ssd_chunked(xh, bm, cm, dtv, a, h0=h0, chunk=chunk)
        for g, w in zip(got, want):
            close(g, w)


def test_ssm_forward_and_decode(rng):
    jd = jssm.SSMDims(32, d_state=8, expand=2, headdim=16)
    jp = jssm.init_ssm(jax.random.key(6), jd)
    p = load(ssm.SSM(ssm.SSMDims(32, d_state=8, expand=2, headdim=16),
                     torch.float32, "cpu"), jp)
    x = x_of(rng, 2, 16, 32)
    close(p(t(x), chunk=8), jssm.ssm_forward(jp, x, jd, chunk=8))
    got, (gh, gc) = ssm.ssm_forward(p, t(x), p.dims, chunk=8,
                                    return_state=True)
    want, (wh, wc) = jssm.ssm_forward(jp, x, jd, chunk=8, return_state=True)
    for g, w in ((got, want), (gh, wh), (gc, wc)):
        close(g, w)
    # three chained decode steps from the prefill's state
    h, conv = gh, gc
    jh, jc = wh, wc
    for i in range(3):
        xi = x_of(rng, 2, 1, 32)
        y, (h, conv) = ssm.ssm_decode(p, t(xi), p.dims, h, conv)
        jy, (jh, jc) = jssm.ssm_decode(jp, xi, jd, jh, jc)
        for g, w in ((y, jy), (h, jh), (conv, jc)):
            close(g, w)
