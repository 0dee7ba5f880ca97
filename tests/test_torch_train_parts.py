"""Pieces of the port's training path, on the CPU: the chunked
cross-entropy over several chunks (``LOSS_CHUNK`` lowered in both
packages) against the JAX package's, and its fallback to one chunk;
``remat`` giving the same loss and gradients, bit for bit, as without it;
parameters made without a gradient (serving records no graph) and the
train step turning them on; ``convert.lm_params_to_numpy`` inverting
``lm_params_from_numpy`` bit for bit in fp32 and bf16.  Tolerances are
``test_torch_train.py``'s: loss rtol 1e-5, gradients rtol=atol=1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from test_torch_models_arch import (batch_for, jax_batch, pair,  # noqa: E402
                                    torch_batch)
from test_torch_train import (GRAD_TOL, LOSS_RTOL, ARCHS,  # noqa: E402
                              port_loss_and_grads)

torch.set_num_threads(2)


@pytest.mark.parametrize("arch,seq", [("smollm-135m", 32),
                                      ("mamba2-130m", 32),
                                      ("internvl2-2b", 32),
                                      ("whisper-tiny", 32),
                                      ("smollm-135m", 24)])
def test_chunked_loss_matches_reference(arch, seq, monkeypatch):
    """Sixteen-token loss chunks in both packages: two chunks at 32, and
    the whole sequence at 24 (16 does not divide it)."""
    monkeypatch.setattr(jtf, "LOSS_CHUNK", 16)
    monkeypatch.setattr(tf, "LOSS_CHUNK", 16)
    jm, jp, tm, tp = pair(arch)
    batch = batch_for(tm.cfg, np.random.default_rng(1), s=seq)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(jp, jax_batch(batch))
    loss, grads = port_loss_and_grads(tm, tp, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(grads["unembed"],
                               np.asarray(jgrads["unembed"]), **GRAD_TOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m",
                                  "mamba2-130m", "zamba2-1.2b",
                                  "internvl2-2b"])
def test_remat_changes_no_bit(arch):
    """``remat`` recomputes each layer in the backward: the loss and every
    gradient are the same bits as without it."""
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(configs.get(arch, smoke=True), remat=remat)
        m = model_mod.build(cfg)
        p = m.init(torch.Generator().manual_seed(0), device="cpu")
        batch = batch_for(cfg, np.random.default_rng(2))
        out.append(port_loss_and_grads(m, p, batch))
    assert out[0][0] == out[1][0]
    for a, b in zip(jax.tree.leaves(out[0][1]), jax.tree.leaves(out[1][1])):
        np.testing.assert_array_equal(a, b)


def test_serving_records_no_graph_and_the_step_turns_gradients_on():
    cfg = configs.get("smollm-135m", smoke=True)
    m = model_mod.build(cfg)
    p = m.init(0, device="cpu")
    assert not any(t.requires_grad for t in p.parameters())
    batch = torch_batch(batch_for(cfg, np.random.default_rng(0)))
    assert m.forward(p, batch).grad_fn is None
    step = model_mod.make_train_step(m, adamw.AdamWConfig())
    step(p, adamw.init(p), batch)
    assert all(t.requires_grad for t in p.parameters())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_to_numpy_round_trips(arch, dtype):
    """The reference's pytree in, the same pytree out, bit for bit (bf16
    weights come out as fp32 holding the same values); and back in."""
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True),
                               dtype=getattr(jnp, dtype))
    cfg = dataclasses.replace(configs.get(arch, smoke=True),
                              dtype=getattr(torch, dtype))
    tree = jax.tree.map(np.asarray, jmodel.build(jcfg).init(
        jax.random.key(1)))
    params = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    back = convert.lm_params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a.astype(np.float32), b)
    again = convert.lm_params_from_numpy(back, cfg, device="cpu")
    for (name, a), b in zip(params.named_parameters(), again.parameters()):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name


def test_flash_chunks_recomputed_under_grad():
    """Query-chunked attention with its chunks recomputed in the backward
    gives the one-piece attention's output and gradients within 1e-6."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 32, 4, 8, generator=g, requires_grad=True)
               for _ in range(3))
    outs, grads = [], []
    for fn in (lambda: L.flash_attention(q, k, v, causal=True, q_chunk=8),
               lambda: L.attention_scores(q, k, v, causal=True)):
        o = fn()
        outs.append(o.detach())
        grads.append(torch.autograd.grad(o.square().sum(), (q, k, v)))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-6)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
