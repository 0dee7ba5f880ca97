"""The port's train step (``model.make_train_step``, one batch) against
the JAX package's, on the CPU, for the ten ``smoke()`` architectures on
the reference's weights.

One step on ``tests/test_arch_smoke.py``'s batch: the loss within rtol
1e-5, ``grad_norm`` within rtol 1e-5 (both sum fp32 squares in another
order: the port per layer, the reference per stacked leaf), ``lr``
within rtol 1e-6 (one fp32 ulp of the cosine), the step counter equal,
and every updated parameter and both moments, mapped back to the
reference's stacked tree, within rtol=atol=1e-5.

The step's optimizer takes ``eps=1e-4`` here (``STEP_CFG``).  At the
default 1e-8 the first step moves a parameter by lr·g/(|g|+eps), about
±lr for any |g| above ~1e-7, so a gradient of order eps that both
packages compute within the 1e-4 gradient bar but not to its last bits
moves its parameter differently by a fair share of lr (5.1e-5 at lr
5e-4 on one of dbrx's 6,144 ``wv`` elements, whose gradient is 2e-8).
With eps=1e-4 a gradient difference δ moves the step by at most lr·δ/eps.
The update at the default eps is held on identical gradients in
``test_torch_optim.py``, and ``test_torch_train_loop.py`` runs the
default over five steps.  ``test_torch_train_accum.py`` holds the
accumulating step (``n_microbatches=2``) the same way.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from test_torch_models_arch import (batch_for, jax_batch, pair,  # noqa: E402
                                    torch_batch)

torch.set_num_threads(2)
ARCHS = configs.ARCHS
OPT = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)
STEP_CFG = dict(OPT, eps=1e-4)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def jax_step(arch: str, n_microbatches: int, eps: float):
    jm, _, _, _ = pair(arch)
    cfg = jadamw.AdamWConfig(**dict(OPT, eps=eps))
    return jax.jit(jmodel.make_train_step(jm, cfg, n_microbatches))


def tree_of(params, values=None):
    return jax.tree.map(lambda t: t.detach().numpy(),
                        convert.lm_tree(params, values))


def check_step(arch, n_microbatches):
    """One step in both packages from the same weights and batch."""
    _, jp, tm, tp = pair(arch)
    batch = batch_for(tm.cfg, np.random.default_rng(0), b=4)
    jp2, jst, jmet = jax_step(arch, n_microbatches, STEP_CFG["eps"])(
        jp, jadamw.init(jp), jax_batch(batch))
    step = model_mod.make_train_step(tm, adamw.AdamWConfig(**STEP_CFG),
                                     n_microbatches)
    tp2, st, met = step(tp, adamw.init(tp), torch_batch(batch))
    for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
        assert met[key].shape == ()
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=rtol, err_msg=key)
    assert int(st.step) == int(jst.step) == 1 and st.step.dtype == torch.int32
    for name, got, want in (("params", tree_of(tp2), jp2),
                            ("m", tree_of(tp2, st.m), jst.m),
                            ("v", tree_of(tp2, st.v), jst.v)):
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree.leaves(got)):
            np.testing.assert_allclose(
                g, np.asarray(w), err_msg=f"{name}{jax.tree_util.keystr(path)}",
                **PARAM_TOL)
    return tp2, met


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    check_step(arch, 1)
