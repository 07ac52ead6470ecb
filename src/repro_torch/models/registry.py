"""Uniform model API for the serving slice (the LM part of the JAX
registry):

    api = get_model(cfg, device)
    params = api.init(generator)              # a TransformerLM module
    cache = api.init_cache(batch, max_len)
    logits, cache = api.decode(params, batch, cache, index)

``abstract_cache`` builds the cache on the ``meta`` device, which takes the
place of ``jax.eval_shape``: shapes and dtypes, no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import transformer


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    init_cache: Callable
    abstract_cache: Callable
    decode: Callable


def _lm_api(cfg: ModelConfig, device: torch.device) -> ModelAPI:
    def init(generator: torch.Generator) -> transformer.TransformerLM:
        return transformer.init_model(cfg, generator, device)

    def init_cache(batch: int, max_len: int, device=device):
        return transformer.init_cache(cfg, batch, max_len, device)

    def abstract_cache(batch: int, max_len: int):
        return transformer.init_cache(cfg, batch, max_len, "meta")

    def decode(params, batch, cache, index):
        return transformer.decode_step(params, cfg, batch["tokens"], cache,
                                       index)

    return ModelAPI(cfg=cfg, device=device, init=init, init_cache=init_cache,
                    abstract_cache=abstract_cache, decode=decode)


def get_model(cfg: ModelConfig, device=None) -> ModelAPI:
    if cfg.enc_dec:
        raise NotImplementedError(
            "encoder-decoder models (whisper) are not ported yet")
    return _lm_api(cfg, resolve_device(device))
