"""AdamW + global-norm clipping + cosine schedule, written out on tensors
(no ``torch.optim``).

The port of the JAX package's ``repro.optim.adamw``.  Parameters are an
``nn.Module`` (its ``named_parameters()``) or a mapping of names to
tensors; gradients and the moments are mappings with the same names.
The moments ``m`` and ``v`` are fp32 whatever the parameter's dtype; each
parameter is updated in fp32 and cast back, in place.  Weight decay
applies to every parameter, norms included, as in the reference.  The
schedule and the bias corrections are computed in fp32 on the device, and
nothing in ``update`` reads a value back to the host.  Square roots are
IEEE (``numerics.sqrt_rn``), as the reference's are.

``global_norm`` sums each tensor's squares and then the sums, in the
mapping's order.  The reference sums per stacked leaf in sorted-key
order, while the port holds one tensor per layer, so the two add the same
squares in another order and agree to fp32 rounding, not bitwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch
from torch import nn

from repro_torch.core.numerics import sqrt_rn


class AdamWState(NamedTuple):
    """AdamW optimizer state: the step (0-d int32) and the first and second
    moments (fp32, by parameter name)."""
    step: torch.Tensor
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """AdamW + cosine-schedule hyper-parameters."""
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _named(params) -> dict:
    """name -> tensor of a module's parameters, or of a mapping as is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step``: linear warm-up, then cosine decay to
    ``lr_min_ratio * lr_peak``, in fp32."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr_peak * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> AdamWState:
    """Zero moments (fp32) for each parameter; step 0 on their device."""
    ps = _named(params)
    device = next(iter(ps.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in ps.items()},
        v={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in ps.items()})


def global_norm(tree: Mapping) -> torch.Tensor:
    """The fp32 L2 norm over every tensor of ``tree``."""
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return sqrt_rn(total)


@torch.no_grad()
def update(grads: Mapping, state: AdamWState, params, cfg: AdamWConfig):
    """One AdamW step.  Writes the new parameters into ``params`` in place
    and returns ``(params, new_state, {"grad_norm", "lr"})`` with 0-d
    device tensors."""
    ps = _named(params)
    gnorm = global_norm({k: grads[k] for k in ps})
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    new_m, new_v = {}, {}
    for k, p in ps.items():
        g = grads[k].float() * scale
        m2 = cfg.b1 * state.m[k] + (1 - cfg.b1) * g
        v2 = cfg.b2 * state.v[k] + (1 - cfg.b2) * g * g
        mhat = m2 / b1c
        vhat = v2 / b2c
        step_ = mhat / (sqrt_rn(vhat) + cfg.eps)
        pf = p.float()
        p.copy_((pf - lr * (step_ + cfg.weight_decay * pf)).to(p.dtype))
        new_m[k], new_v[k] = m2, v2
    return params, AdamWState(step, new_m, new_v), {"grad_norm": gnorm,
                                                     "lr": lr}
