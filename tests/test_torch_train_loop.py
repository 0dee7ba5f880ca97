"""Five steps of the port's training loop against the JAX package's, on
the CPU: ``make_train_step`` at the default AdamW settings of
``tests/test_arch_smoke.py`` (lr 1e-3, two warm-up steps, eps 1e-8) on
``TokenPipeline`` batches, from the reference's weights, for the
decoder-only smoke architectures (the VLM and the encoder-decoder take
inputs the pipeline does not make).  Each step's loss within rtol=atol
1e-4: five steps of Adam carry the first step's eps-sized differences
(``test_torch_train_step.py``) into the weights, far below that.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from test_torch_models_arch import jax_batch, pair, torch_batch  # noqa: E402
from test_torch_train_step import OPT, jax_step  # noqa: E402

torch.set_num_threads(2)
LOOP_ARCHS = [a for a in configs.ARCHS
              if configs.get(a, smoke=True).family not in ("vlm", "encdec")]


@pytest.mark.parametrize("arch", LOOP_ARCHS)
def test_five_steps_on_the_pipeline_match_reference(arch):
    _, jp, tm, tp = pair(arch)
    jstep = jax_step(arch, 1, 1e-8)
    step = model_mod.make_train_step(tm, adamw.AdamWConfig(**OPT))
    pipe = TokenPipeline(tm.cfg.vocab, 2, 32, seed=3)
    jst, st = jadamw.init(jp), adamw.init(tp)
    jl, tl = [], []
    for i in range(5):
        batch = pipe.batch_at(i)
        jp, jst, jmet = jstep(jp, jst, jax_batch(batch))
        tp, st, met = step(tp, st, torch_batch(batch))
        jl.append(float(jmet["loss"]))
        tl.append(float(met["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
