"""Fault-tolerant training driver: the port of the JAX package's
``repro.launch.train``.

A single-host training loop with checkpoint/restart, deterministic data
resume, a per-step watchdog (straggler mitigation) and failure injection
for the restart tests:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 100 --ckpt-dir <dir>                 # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 30 --fail-at 25 --ckpt-dir <dir>     # the plain CPU run

* every step runs under a watchdog budget (``watchdog_factor`` x the
  trailing median step time, on the host clock after the loss is read
  back); a breach raises and the runner restarts from the last
  checkpoint;
* checkpoints are written asynchronously every ``ckpt_every`` steps;
* restart = restore(latest) + the data stream resumed at the stored step.

The checkpoint tree is the reference's: ``(params, AdamWState(step, m,
v))`` with the parameters and both moments in the reference's stacked
pytree (``convert.lm_tree``) and the reference's files and checksums, so
either trainer resumes the other's fp32 checkpoint.  Parameters start from
the config's init drawn from a seeded ``torch.Generator`` (torch cannot
repeat ``jax.random``).  The loop runs on the card unless it is given
``device="cpu"``; without a card it raises and never falls back.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import torch

from repro_torch import configs, convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels.platform import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.optim import adamw


class WatchdogTimeout(RuntimeError):
    """Raised when a training step exceeds the watchdog budget."""


def checkpoint_tree(params, opt_state: adamw.AdamWState):
    """``(params, AdamWState(step, m, v))`` in the reference's layout."""
    return (convert.lm_tree(params),
            adamw.AdamWState(opt_state.step,
                             convert.lm_tree(params, opt_state.m),
                             convert.lm_tree(params, opt_state.v)))


def restore_checkpoint(mgr: CheckpointManager, params,
                       opt_state: adamw.AdamWState):
    """Load the latest checkpoint into ``params`` (in place) and return
    ``(params, opt_state, step)``."""
    (ptree, st), step = mgr.restore(checkpoint_tree(params, opt_state))
    convert.load_lm_params(params, ptree)
    opt_state = adamw.AdamWState(st.step, convert.lm_untree(params, st.m),
                                 convert.lm_untree(params, st.v))
    return params, opt_state, step


def train(arch: str, steps: int, ckpt_dir: str, smoke: bool = True,
          batch: int = 8, seq: int = 64, ckpt_every: int = 20,
          fail_at: int | None = None, watchdog_factor: float = 10.0,
          seed: int = 0, log_every: int = 10, device=None) -> dict:
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint, if any).  Returns ``final_loss``, ``losses`` (the
    steps this call ran), ``start`` (the step it resumed at) and
    ``step_times`` (host seconds per step, each ending in the loss's
    read-back, so the card is synchronised)."""
    dev = resolve_device(device)
    cfg = configs.get(arch, smoke=smoke)
    model = model_mod.build(cfg)
    opt_cfg = adamw.AdamWConfig(lr_peak=3e-4, warmup_steps=10,
                                total_steps=steps)
    train_step = model_mod.make_train_step(model, opt_cfg)

    mgr = CheckpointManager(ckpt_dir)
    pipe = TokenPipeline(cfg.vocab, batch, seq, seed=seed)

    params = model.init(torch.Generator().manual_seed(seed), device=dev)
    opt_state = adamw.init(params)
    start = 0
    if mgr.latest_step() is not None:
        params, opt_state, start = restore_checkpoint(mgr, params, opt_state)
        print(f"[train] resumed from step {start}", flush=True)

    losses: list[float] = []
    step_times: list[float] = []
    step = start
    it = pipe.iterate(start_step=start)
    try:
        for step, np_batch in it:
            if step >= steps:
                break
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.monotonic()
            b = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
            params, opt_state, metrics = train_step(params, opt_state, b)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            # a step over watchdog_factor x the trailing median is a
            # straggler: abort, and the runner restarts from the checkpoint
            if len(step_times) >= 5:
                budget = watchdog_factor * statistics.median(step_times[-20:])
                if dt > budget:
                    raise WatchdogTimeout(
                        f"step {step} took {dt:.2f}s > budget {budget:.2f}s")
            step_times.append(dt)
            losses.append(loss)
            if step % log_every == 0:
                print(f"[train] step={step} loss={loss:.4f} "
                      f"dt={dt * 1e3:.0f}ms", flush=True)
            if step > 0 and step % ckpt_every == 0:
                mgr.save(step + 1, checkpoint_tree(params, opt_state),
                         wait=False)
    finally:
        it.close()
        mgr.wait()
    mgr.save(min(steps, step + 1), checkpoint_tree(params, opt_state),
             wait=True)
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "start": start, "step_times": step_times}


def run_with_restarts(max_restarts: int = 3, **kw) -> dict:
    """Supervisor: restart from the latest checkpoint on failure (the
    single-host stand-in for a pod coordinator's evict-and-restart).  A
    missing card raises at once; it is not a failure to retry."""
    resolve_device(kw.get("device"))
    for attempt in range(max_restarts + 1):
        try:
            return train(**kw)
        except (WatchdogTimeout, RuntimeError) as e:  # noqa: PERF203
            print(f"[train] attempt {attempt} failed: {e}; restarting",
                  flush=True)
            kw["fail_at"] = None  # the injected failure fires once
    raise RuntimeError("exceeded max restarts")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = run_with_restarts(
        arch=args.arch, steps=args.steps, ckpt_dir=args.ckpt_dir,
        smoke=args.smoke, batch=args.batch, seq=args.seq,
        fail_at=args.fail_at, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"final_loss": out["final_loss"], "start": out["start"],
                      "device": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
