"""Unified model API: ``build(config)`` -> init / loss / forward /
prefill / decode, and ``make_train_step``.

The port of the JAX package's ``repro.models.model``.  Parameters are an
``nn.Module`` (``transformer.LM`` or ``encdec.EncDec``) and caches a dict
of tensors; both go on the card unless the caller passes ``device="cpu"``
(or ``"meta"``: shapes only, nothing allocated).

  model = build(configs.get("smollm-135m"))
  params = model.init(torch.Generator().manual_seed(0))
  caches = model.init_caches(4, 256)
  last, caches = model.prefill_caches(params, {"tokens": tokens}, caches)
  logits, caches = model.decode_step(params, {"token": t, "pos": pos},
                                     caches)

``prefill`` is the reference's: last-position logits of the whole-sequence
backbone, without caches.  ``prefill_caches`` (decoder-only families) also
writes the prompt's decode state, so that decoding continues at
``pos = S``; the encoder-decoder has none (``None``).

Training (``make_train_step``): gradients come from autograd, and the
step turns them on for the module it is given (parameters are made
without, so that serving records no graph); AdamW updates the module in
place.

  step = make_train_step(model, adamw.AdamWConfig(), n_microbatches=2)
  opt_state = adamw.init(params)
  params, opt_state, metrics = step(params, opt_state,
                                    {"tokens": t, "targets": y})
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.kernels.platform import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import sharding as shard
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import LMConfig
from repro_torch.optim import adamw


class Model(NamedTuple):
    """Bundled model callables: init, loss, forward, prefill, decode."""
    cfg: LMConfig
    init: Any
    loss_fn: Any            # (params, batch) -> mean next-token NLL
    forward: Any
    prefill: Any            # full-seq backbone, last-token logits
    decode_step: Any
    init_caches: Any
    prefill_caches: Any     # prefill that fills the caches (decoder-only)


def _device(device) -> torch.device:
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _generator(gen) -> torch.Generator | None:
    """An int seeds a fresh CPU generator; a generator is used as is."""
    if gen is None or isinstance(gen, torch.Generator):
        return gen
    return torch.Generator().manual_seed(int(gen))


def build(cfg: LMConfig) -> Model:
    if cfg.family == "encdec":
        def init(gen=None, device=None):
            return encdec_mod.init_encdec(_generator(gen), cfg,
                                          _device(device))

        def loss_fn(params, batch):
            return encdec_mod.loss(params, cfg, batch["frames"],
                                   batch["tokens"], batch["targets"])

        def forward(params, batch):
            enc = encdec_mod.encode(params, cfg, batch["frames"])
            return encdec_mod.decode_train(params, cfg, enc, batch["tokens"])

        def decode_step(params, batch, caches):
            return encdec_mod.decode_step(params, cfg, batch["token"], caches,
                                          batch["pos"], batch["enc_out"])

        def prefill(params, batch):
            return encdec_mod.prefill_last_logits(params, cfg,
                                                  batch["frames"],
                                                  batch["tokens"])

        def init_caches(batch, max_seq, device=None):
            return encdec_mod.init_decode_caches(cfg, batch, max_seq,
                                                 _device(device))

        return Model(cfg, init, loss_fn, forward, prefill, decode_step,
                     init_caches, None)

    def init(gen=None, device=None):
        return tf.init_lm(_generator(gen), cfg, _device(device))

    def loss_fn(params, batch):
        return tf.lm_loss(params, cfg, batch["tokens"], batch["targets"],
                          batch.get("patch_embeds"))

    def forward(params, batch):
        return tf.forward(params, cfg, batch["tokens"],
                          batch.get("patch_embeds"))

    def decode_step(params, batch, caches):
        return tf.decode_step(params, cfg, batch["token"], caches,
                              batch["pos"])

    def prefill(params, batch):
        return tf.prefill_last_logits(params, cfg, batch["tokens"],
                                      batch.get("patch_embeds"))

    def init_caches(batch, max_seq, device=None):
        return tf.init_decode_caches(cfg, batch, max_seq, _device(device))

    def prefill_caches(params, batch, caches):
        return tf.prefill(params, cfg, batch["tokens"], caches,
                          batch.get("patch_embeds"))

    return Model(cfg, init, loss_fn, forward, prefill, decode_step,
                 init_caches, prefill_caches)


def _loss_and_grads(model: Model, params: nn.Module, batch: dict):
    """(loss, name -> gradient) of ``model.loss_fn`` by autograd."""
    names, leaves = zip(*params.named_parameters())
    with torch.enable_grad():
        loss = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads))


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    n_microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics), with
    ``metrics`` = {"loss", "grad_norm", "lr"} as 0-d tensors.

    ``n_microbatches > 1`` accumulates gradients: the batch's leading axis
    is split into that many equal microbatches, taken in order, whose
    gradients and losses are summed (from zeros in each parameter's dtype,
    as the reference's scan carries them) and divided by the count; the
    optimizer sees the mean, as with one batch.  On a mesh the split keeps
    each microbatch on the batch axes (the reference's constraint)."""
    mb = n_microbatches

    def split(x):
        # a DTensor batch is made whole first: its shards do not divide
        # into mb microbatches in place (the reference's all-to-all)
        y = shard.constrain(x, *([None] * x.ndim))
        y = y.reshape(mb, y.shape[0] // mb, *y.shape[1:])
        return shard.constrain(y, None, shard.BATCH,
                               *([None] * (y.ndim - 2)))

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        if mb == 1:
            loss, grads = _loss_and_grads(model, params, batch)
        else:
            for k, v in batch.items():
                if v.shape[0] % mb:
                    raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, "
                                     f"not a multiple of {mb} microbatches")
            g_sum = {k: torch.zeros_like(p)
                     for k, p in params.named_parameters()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=next(params.parameters()).device)
            parts = {k: split(v) for k, v in batch.items()}
            for i in range(mb):
                part = {k: v[i] for k, v in parts.items()}
                loss, grads = _loss_and_grads(model, params, part)
                g_sum = {k: g_sum[k] + grads[k] for k in g_sum}
                loss_sum = loss_sum + loss
            grads = {k: g / mb for k, g in g_sum.items()}
            loss = loss_sum / mb
        params, opt_state, metrics = adamw.update(grads, opt_state, params,
                                                  opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_serve_step(model: Model):
    """(params, batch, caches) -> (logits, new_caches): one decode token."""

    def serve_step(params, batch, caches):
        return model.decode_step(params, batch, caches)

    return serve_step


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
