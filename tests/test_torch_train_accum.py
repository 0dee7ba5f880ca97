"""The port's accumulating train step (``make_train_step(...,
n_microbatches=2)``) against the JAX package's, on the CPU, for the ten
``smoke()`` architectures on the reference's weights, with the bars and
the optimizer settings of ``test_torch_train_step.py`` (whose docstring
gives the reasons): loss and ``grad_norm`` rtol 1e-5, ``lr`` rtol 1e-6,
parameters and moments rtol=atol=1e-5.  Also: on the same batch the
accumulating step equals the one-batch step within rtol=atol=1e-5 (the
mean over microbatches of each row's loss is the whole batch's mean; the
sums differ in order only); a batch the microbatches do not divide
raises; and, on a card (``cuda``), one step there equals the same step
on the CPU, and two microbatches equal one, within rtol=atol=1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from test_torch_models_arch import batch_for, torch_batch  # noqa: E402
from test_torch_train_step import STEP_CFG, check_step  # noqa: E402

torch.set_num_threads(2)
ARCHS = configs.ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_accumulating_step_matches_reference(arch):
    check_step(arch, 2)


def run_step(arch, device, n_microbatches):
    """One step of the seeded smoke model on ``device``: (loss,
    grad_norm, lr, the updated parameters on the CPU)."""
    cfg = configs.get(arch, smoke=True)
    m = model_mod.build(cfg)
    p = m.init(torch.Generator().manual_seed(0), device=device)
    batch = {k: v.to(device) for k, v in torch_batch(
        batch_for(cfg, np.random.default_rng(0), b=4)).items()}
    step = model_mod.make_train_step(m, adamw.AdamWConfig(**STEP_CFG),
                                     n_microbatches)
    p, _, met = step(p, adamw.init(p), batch)
    return ([float(met[k]) for k in ("loss", "grad_norm", "lr")],
            [t.detach().cpu() for t in p.parameters()])


def assert_same_step(a, b, tol):
    np.testing.assert_allclose(a[0], b[0], rtol=tol, atol=tol)
    for x, y in zip(a[1], b[1]):
        torch.testing.assert_close(x, y, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m",
                                  "zamba2-1.2b", "whisper-tiny"])
def test_two_microbatches_equal_one_batch(arch):
    assert_same_step(run_step(arch, "cpu", 2), run_step(arch, "cpu", 1),
                     1e-5)


def test_uneven_microbatches_raise():
    cfg = configs.get("smollm-135m", smoke=True)
    m = model_mod.build(cfg)
    p = m.init(0, device="cpu")
    step = model_mod.make_train_step(m, adamw.AdamWConfig(), 2)
    batch = torch_batch(batch_for(cfg, np.random.default_rng(0), b=3))
    with pytest.raises(ValueError, match="microbatches"):
        step(p, adamw.init(p), batch)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the train step on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_step_equals_cpu(card, arch):
    cpu = run_step(arch, "cpu", 1)
    assert_same_step(run_step(arch, "cuda", 1), cpu, 1e-4)
    assert_same_step(run_step(arch, "cuda", 2), cpu, 1e-4)
