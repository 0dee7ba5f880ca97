"""The port's training driver (``repro_torch.launch.train``) on the CPU:
the JAX package's ``tests/test_substrate.py`` training cases, then
checkpoints that either framework's trainer resumes.

* Restart determinism: 30 steps straight against 30 steps with a failure
  injected at step 25 and a restart from the step-21 checkpoint (smoke
  ``smollm-135m``): the same final loss within rtol 1e-5, the reference
  test's bar.
* The loss falls on smoke ``qwen2-0.5b`` (mean of the last five steps
  under the mean of the first five).
* Cross-framework resume: the reference's ``train`` writes step 10 and
  the port's resumes it to step 15, its losses at steps 10-14 equal to
  the reference's uninterrupted 15-step run within rtol=atol=1e-4; then
  the reverse, against the port's uninterrupted run.  (A 10-step and a
  15-step schedule agree up to step 10: warm-up is 10 steps.)
* The watchdog: a step ten times the trailing median raises
  ``WatchdogTimeout``, and ``run_with_restarts`` resumes from the last
  checkpoint.
* The CLI (``--device cpu --steps 30 --fail-at 25``) and
  ``examples/torch_train_lm.py --device cpu``: a finite loss.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as jtrain  # noqa: E402
from repro_torch.launch import train  # noqa: E402

torch.set_num_threads(2)
SMALL = dict(smoke=True, batch=4, seq=32)


def test_restart_is_deterministic(tmp_path):
    out1 = train.train(arch="smollm-135m", steps=30,
                       ckpt_dir=str(tmp_path / "a"), ckpt_every=10,
                       device="cpu", **SMALL)
    out2 = train.run_with_restarts(
        arch="smollm-135m", steps=30, ckpt_dir=str(tmp_path / "b"),
        ckpt_every=10, fail_at=25, device="cpu", **SMALL)
    assert out2["start"] == 21  # actually resumed, from the step-20 save
    np.testing.assert_allclose(out1["final_loss"], out2["final_loss"],
                               rtol=1e-5)
    assert len(out2["losses"]) == len(out2["step_times"]) == 9


def test_loss_decreases(tmp_path):
    out = train.train(arch="qwen2-0.5b", steps=25, ckpt_dir=str(tmp_path),
                      ckpt_every=100, device="cpu", **SMALL)
    assert np.all(np.isfinite(out["losses"]))
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])


def test_port_resumes_the_reference_and_back(tmp_path):
    kw = dict(arch="smollm-135m", ckpt_every=100, **SMALL)
    ref = jtrain.train(steps=15, ckpt_dir=str(tmp_path / "ref"), **kw)
    jtrain.train(steps=10, ckpt_dir=str(tmp_path / "ref10"), **kw)
    out = train.train(steps=15, ckpt_dir=str(tmp_path / "ref10"),
                      device="cpu", **kw)
    assert out["start"] == 10
    np.testing.assert_allclose(out["losses"], ref["losses"][10:],
                               rtol=1e-4, atol=1e-4)

    port = train.train(steps=15, ckpt_dir=str(tmp_path / "port"),
                       device="cpu", **kw)
    train.train(steps=10, ckpt_dir=str(tmp_path / "port10"), device="cpu",
                **kw)
    back = jtrain.train(steps=15, ckpt_dir=str(tmp_path / "port10"), **kw)
    assert back["start"] == 10
    np.testing.assert_allclose(back["losses"], port["losses"][10:],
                               rtol=1e-4, atol=1e-4)


class SlowStepClock:
    """``time`` for the trainer: 10 ms a read, and 100 s more at the end
    of step 13 (two reads a step)."""

    def __init__(self):
        self.t, self.reads = 0.0, 0

    def monotonic(self):
        self.reads += 1
        self.t += 0.01 + (100.0 if self.reads == 28 else 0.0)
        return self.t


def test_watchdog_trips_and_the_runner_resumes(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setattr(train, "time", SlowStepClock())
    out = train.run_with_restarts(arch="smollm-135m", steps=16,
                                  ckpt_dir=str(tmp_path), ckpt_every=5,
                                  device="cpu", **SMALL)
    assert "step 13 took 100.01s > budget 0.10s" in capsys.readouterr().out
    assert out["start"] == 11          # the step-10 save
    assert np.isfinite(out["final_loss"])


def test_cli_resumes_and_prints_a_finite_loss(tmp_path, capsys):
    assert train.main(["--device", "cpu", "--steps", "30", "--fail-at",
                       "25", "--ckpt-dir", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "[train] resumed from step 21" in lines
    last = json.loads(lines[-1])
    assert last["start"] == 21 and last["device"] == "cpu"
    assert np.isfinite(last["final_loss"])


def test_example_trains_on_the_cpu():
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_train_lm.py"
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.run(["--device", "cpu"])
    assert out["device"] == "cpu"
    assert np.isfinite(out["final_loss"])
    assert out["final_loss"] < out["first_loss"]
