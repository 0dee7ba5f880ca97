"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
package's ``repro.optim.adamw``, on the CPU.

* ``schedule`` at every step 0..total of four schedules (warm-up 0, 2,
  10 and 100 steps), fp32, within 8 ulps: the cosine is XLA's on one side
  and torch's on the other (1 ulp apart on a few inputs), and the
  schedule's fp32 arithmetic carries that (5 ulps at most, my CPU run).
* ``global_norm`` over the same tensors within rtol 1e-6 (fp32 sums in
  another order).
* Three ``update`` steps on seeded parameters and gradients (fp32, and
  bf16 parameters with bf16 gradients) from the same state: the fp32
  parameters and the fp32 moments within rtol=1e-6, atol=1e-7 (XLA may
  contract a product and a sum into one FMA; torch's CPU kernels do not);
  bf16 parameters within one bf16 ulp (2^-8 of the value: an fp32 result
  one ulp apart can round to the neighbouring bf16); ``grad_norm`` and
  ``lr`` within rtol 1e-6; the step counter an int32 0-d tensor; the
  moments fp32 whatever the parameter's dtype; weight decay on every
  parameter, norms included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

torch.set_num_threads(2)
SHAPES = {"embed": (50, 8), "layers": {"ln1": (3, 8), "w": (3, 8, 16)},
          "norm": (8,)}


@pytest.mark.parametrize("warmup,total", [(0, 50), (2, 10), (10, 100),
                                          (100, 10_000)])
def test_schedule_matches_reference(warmup, total):
    steps = np.arange(total + 1, dtype=np.int32)
    want = np.asarray(jadamw.schedule(
        jadamw.AdamWConfig(warmup_steps=warmup, total_steps=total),
        jnp.asarray(steps)))
    got = adamw.schedule(
        adamw.AdamWConfig(warmup_steps=warmup, total_steps=total),
        torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=8)


def _leaves(rng, dtype):
    """Seeded leaves by the port's flat names and the reference's tree."""
    flat = {}

    def draw(tree, prefix):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = draw(v, f"{prefix}{k}.")
            else:
                out[k] = rng.standard_normal(v).astype(np.float32)
                flat[prefix + k] = out[k]
        return out

    tree = draw(SHAPES, "")
    jtree = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    tdtype = getattr(torch, jnp.dtype(dtype).name)
    return {k: torch.from_numpy(v).to(tdtype) for k, v in flat.items()}, jtree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def test_global_norm_matches_reference():
    grads, jgrads = _leaves(np.random.default_rng(0), jnp.float32)
    np.testing.assert_allclose(float(adamw.global_norm(grads)),
                               float(jadamw.global_norm(jgrads)), rtol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_update_matches_reference(dtype):
    rng = np.random.default_rng(1)
    params, jparams = _leaves(rng, dtype)
    grads, jgrads = _leaves(rng, dtype)
    jcfg = jadamw.AdamWConfig(warmup_steps=2, total_steps=10)
    cfg = adamw.AdamWConfig(warmup_steps=2, total_steps=10)
    jstate, state = jadamw.init(jparams), adamw.init(params)
    assert state.step.dtype == torch.int32 and state.step.shape == ()
    for _ in range(3):
        jparams, jstate, jmet = jadamw.update(jgrads, jstate, jparams, jcfg)
        params, state, met = adamw.update(grads, state, params, cfg)
        for key in ("grad_norm", "lr"):
            assert met[key].shape == () and met[key].dtype == torch.float32
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=1e-6, err_msg=key)
    assert int(state.step) == int(jstate.step) == 3
    assert state.step.dtype == torch.int32
    for name, want in _flat(jparams).items():
        got = params[name].float().numpy()
        if dtype == jnp.float32:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=name)
        else:
            assert params[name].dtype == torch.bfloat16
            np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0,
                                       err_msg=name)
    for moment, jmoment in ((state.m, jstate.m), (state.v, jstate.v)):
        for name, want in _flat(jmoment).items():
            assert moment[name].dtype == torch.float32
            np.testing.assert_allclose(moment[name].numpy(), want,
                                       rtol=1e-6, atol=1e-7, err_msg=name)


def test_weight_decay_reaches_every_parameter():
    """With zero gradients only the decay moves a parameter: every one,
    the norm scale too, shrinks by lr x weight_decay."""
    params = {"norm": torch.ones(4), "w": torch.full((2, 3), 2.0)}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    cfg = adamw.AdamWConfig(warmup_steps=0, total_steps=10)
    params, _, met = adamw.update(grads, adamw.init(params), params, cfg)
    lr = float(met["lr"])
    torch.testing.assert_close(params["norm"],
                               torch.full((4,), 1 - lr * cfg.weight_decay))
    torch.testing.assert_close(params["w"],
                               torch.full((2, 3), 2 * (1 - lr * 0.1)))


@pytest.mark.cuda
def test_cuda_update_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the update on the card")
    rng = np.random.default_rng(2)
    params, _ = _leaves(rng, jnp.float32)
    grads, _ = _leaves(rng, jnp.float32)
    cfg = adamw.AdamWConfig(warmup_steps=2, total_steps=10)
    gpu_p = {k: v.cuda() for k, v in params.items()}
    gpu_g = {k: v.cuda() for k, v in grads.items()}
    _, gst, gmet = adamw.update(gpu_g, adamw.init(gpu_p), gpu_p, cfg)
    _, cst, cmet = adamw.update(grads, adamw.init(params), params, cfg)
    for k in params:
        torch.testing.assert_close(gpu_p[k].cpu(), params[k], rtol=1e-6,
                                   atol=1e-7)
        torch.testing.assert_close(gst.v[k].cpu(), cst.v[k], rtol=1e-6,
                                   atol=1e-7)
    assert gmet["lr"].device.type == "cuda"
