"""The port's training objective and its gradients against the JAX
package's, on the CPU.

Each of the ten ``smoke()`` architectures is built in both packages on the
reference's weights (``jax.random.key(0)``, carried across by
``convert.lm_params_from_numpy``) and fed ``tests/test_arch_smoke.py``'s
batch (``test_torch_models_arch.batch_for``).  ``loss_fn`` agrees within
rtol 1e-5 (fp32; the two sum the same log-probabilities in another
order), and every gradient, mapped back to the reference's stacked tree by
``convert.lm_tree``, within rtol=atol=1e-4 per leaf, the bar the forward
already meets.  Every parameter gets a gradient, and it is finite: a
``.data``, a ``detach`` or an in-place write on the training path would
leave one ``None`` or zero where the reference's is not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import configs, convert  # noqa: E402

from test_torch_models_arch import (batch_for, jax_batch, pair,  # noqa: E402
                                    torch_batch)

torch.set_num_threads(2)
ARCHS = configs.ARCHS
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def port_loss_and_grads(model, params, batch):
    """(loss, the gradients in the reference's stacked tree, as numpy)."""
    params.requires_grad_(True)
    loss = model.loss_fn(params, torch_batch(batch))
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    for name, g in zip(names, grads):
        assert g is not None, name
        assert bool(torch.isfinite(g).all()), name
    tree = convert.lm_tree(params, dict(zip(names, grads)))
    return float(loss.detach()), jax.tree.map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jm, jp, tm, tp = pair(arch)
    batch = batch_for(tm.cfg, np.random.default_rng(0))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, jax_batch(batch))
    loss, grads = port_loss_and_grads(tm, tp, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    jgrads = jax.tree.map(np.asarray, jgrads)
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(jgrads)[0],
            jax.tree.leaves(grads)):
        np.testing.assert_allclose(got, want, err_msg=jax.tree_util.keystr(
            path), **GRAD_TOL)
        # a gradient the reference has must not be lost on the way
        assert np.any(got != 0) == np.any(want != 0), \
            jax.tree_util.keystr(path)
