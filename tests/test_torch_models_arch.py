"""The port's ten architectures (``repro_torch.models``, ``configs``)
against the JAX package's on the same weights and inputs, on the CPU.

Each case builds ``configs.get(arch, smoke=True)`` in both packages,
initialises the reference from ``jax.random.key(0)``, carries its pytree
across with ``convert.lm_params_from_numpy`` and feeds both the inputs of
``tests/test_arch_smoke.py``'s ``_batch_for`` made from a seeded numpy
``Generator``.  Forward logits, prefill last logits, and three chained
decode steps' logits and caches are held within rtol=atol=1e-4 in fp32.
The ``kv_quant`` case (``dataclasses.replace`` on both sides) holds its
int8 codes equal wherever the value before rounding is more than 1e-6
from a .5 boundary.  Last, the port's own serving prefill
(``prefill_caches``) followed by decode steps equals the reference's
forward at those positions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import encdec, transformer  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = configs.ARCHS
DECODE_B, MAX_SEQ = 2, 8


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **TOL)


def batch_for(cfg, rng, b=2, s=32):
    """``tests/test_arch_smoke.py``'s ``_batch_for``, as numpy."""
    batch = {}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s))
        batch["targets"] = rng.integers(0, cfg.vocab, (b, s))
        return batch
    batch["tokens"] = rng.integers(0, cfg.vocab, (b, s))
    batch["targets"] = rng.integers(0, cfg.vocab, (b, s))
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def pair(arch, **replace):
    """(reference model, its params, port model, the port's params on the
    same weights)."""
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), **replace)
    cfg = dataclasses.replace(configs.get(arch, smoke=True), **replace)
    jm = jmodel.build(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    return jm, jp, model_mod.build(cfg), tp


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = pair(arch)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(models, arch):
    jm, jp, tm, tp = models(arch)
    batch = batch_for(jm.cfg, np.random.default_rng(0))
    got = tm.forward(tp, torch_batch(batch))
    want = jax.jit(jm.forward)(jp, jax_batch(batch))
    assert got.shape == want.shape and got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_last_logits(models, arch):
    jm, jp, tm, tp = models(arch)
    batch = batch_for(jm.cfg, np.random.default_rng(1))
    close(tm.prefill(tp, torch_batch(batch)),
          jax.jit(jm.prefill)(jp, jax_batch(batch)))


def chained_decode(jm, jp, tm, tp, seed, steps=3):
    """``steps`` decode steps of both packages from fresh caches; yields
    each step's (port logits, port caches, reference logits, reference
    caches)."""
    cfg = jm.cfg
    rng = np.random.default_rng(seed)
    caches = tm.init_caches(DECODE_B, MAX_SEQ, device="cpu")
    jcaches = jm.init_caches(DECODE_B, MAX_SEQ)
    extra = {}
    if cfg.family == "encdec":
        frames = rng.standard_normal(
            (DECODE_B, cfg.n_frames, cfg.d_model)).astype(np.float32)
        enc = jencdec.encode(jp, cfg, jnp.asarray(frames))
        extra["enc_out"] = np.asarray(enc)
        close(encdec.encode(tp, tm.cfg, torch.from_numpy(frames)), enc,
              "encoder output")
    step = jax.jit(jm.decode_step)
    for i in range(steps):
        batch = dict(extra, token=rng.integers(0, cfg.vocab, (DECODE_B,)),
                     pos=np.full((DECODE_B,), i, np.int32) + np.arange(
                         DECODE_B, dtype=np.int32))
        logits, caches = tm.decode_step(tp, torch_batch(batch), caches)
        jlogits, jcaches = step(jp, jax_batch(batch), jcaches)
        yield logits, caches, jlogits, jcaches


@pytest.mark.parametrize("arch", ARCHS)
def test_three_decode_steps(models, arch):
    jm, jp, tm, tp = models(arch)
    for i, (got, caches, want, jcaches) in enumerate(
            chained_decode(jm, jp, tm, tp, seed=2)):
        close(got, want, f"step {i} logits")
        assert set(caches) == set(jcaches)
        for name in caches:
            assert caches[name].shape == jcaches[name].shape
            close(caches[name], jcaches[name], f"step {i} cache {name}")


def test_kv_quant_decode(monkeypatch):
    """The int8 KV cache: only the new position is quantised each step;
    the codes are equal wherever the value before rounding is more than
    1e-6 from a .5 boundary (the two packages' floats differ in the last
    bits), the scales and logits within 1e-4."""
    jm, jp, tm, tp = pair("smollm-135m", kv_quant=True)
    unrounded = []
    quantize = transformer._quantize

    def recording(x):
        codes, scale = quantize(x)
        unrounded.append((x.float() / scale[..., None, None]).numpy())
        return codes, scale
    monkeypatch.setattr(transformer, "_quantize", recording)
    n_near = 0
    for i, (got, caches, want, jcaches) in enumerate(
            chained_decode(jm, jp, tm, tp, seed=3)):
        close(got, want, f"step {i} logits")
        for name in ("k_scale", "v_scale"):
            close(caches[name], jcaches[name], f"step {i} {name}")
        # this step's per-layer new (B, kv, hd) values, k then v
        pre = unrounded[-2 * tm.cfg.n_layers:]
        pos = i + np.arange(DECODE_B)
        for layer in range(tm.cfg.n_layers):
            for j, name in enumerate(("k", "v")):
                x = pre[2 * layer + j]
                code = caches[name][layer, np.arange(DECODE_B), pos].numpy()
                jcode = np.asarray(jcaches[name])[layer, np.arange(DECODE_B),
                                                  pos]
                assert code.dtype == np.int8 and jcode.dtype == np.int8
                near = np.abs(np.abs(x - np.trunc(x)) - 0.5) <= 1e-6
                n_near += int(near.sum())
                np.testing.assert_array_equal(code[~near], jcode[~near])
                assert np.abs(code.astype(int) - jcode.astype(int)).max() <= 1
    assert len(unrounded) == 3 * 2 * tm.cfg.n_layers
    assert n_near < 5


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "whisper_tiny"])
def test_serving_prefill_then_decode_equals_forward(models, arch):
    """The port's serving prefill writes the prompt's decode state: its
    last logits are the reference's prefill of the prompt, and decode
    steps from there give the reference's forward logits at each next
    position (vlm: after the patches).  MoE layers drop (token, choice)
    pairs by a capacity taken over the whole row, so a longer forward is
    not a continuation of the prompt's: there only the prefill is held."""
    jm, jp, tm, tp = models(arch)
    cfg = jm.cfg
    rng = np.random.default_rng(4)
    s, extra_steps = 32, 3
    # the reference's SSM scan takes whole chunks (32 at smoke size)
    batch = batch_for(cfg, rng, s=2 * s)
    off = cfg.n_patches if cfg.family == "vlm" else 0
    prompt = dict(batch, tokens=batch["tokens"][:, :s])
    caches = tm.init_caches(2, off + s + extra_steps, device="cpu")
    last, caches = tm.prefill_caches(tp, torch_batch(prompt), caches)
    close(last, jax.jit(jm.prefill)(jp, jax_batch(prompt)),
          "prefill last logits")
    if cfg.family == "moe":
        return
    full_logits = np.asarray(jax.jit(jm.forward)(jp, jax_batch(batch)))
    serve = model_mod.make_serve_step(tm)
    for i in range(extra_steps):
        token = batch["tokens"][:, s + i]
        pos = np.full((2,), off + s + i)
        logits, caches = serve(tp, torch_batch({"token": token, "pos": pos}),
                               caches)
        close(logits, full_logits[:, off + s + i], f"decode step {i}")
