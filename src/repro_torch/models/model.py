"""Unified model API: ``build(config)`` -> init / forward / prefill /
decode.

The port of the JAX package's ``repro.models.model`` on its serving path
(training's ``loss_fn`` and ``make_train_step`` are not here yet).
Parameters are an ``nn.Module`` (``transformer.LM`` or ``encdec.EncDec``)
and caches a dict of tensors; both go on the card unless the caller
passes ``device="cpu"`` (or ``"meta"``: shapes only, nothing allocated).

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
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.kernels.platform import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import LMConfig


class Model(NamedTuple):
    """Bundled model callables: init, forward, prefill, decode."""
    cfg: LMConfig
    init: Any
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

        return Model(cfg, init, forward, prefill, decode_step, init_caches,
                     None)

    def init(gen=None, device=None):
        return tf.init_lm(_generator(gen), cfg, _device(device))

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

    return Model(cfg, init, forward, prefill, decode_step, init_caches,
                 prefill_caches)


def make_serve_step(model: Model):
    """(params, batch, caches) -> (logits, new_caches): one decode token."""

    def serve_step(params, batch, caches):
        return model.decode_step(params, batch, caches)

    return serve_step


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
