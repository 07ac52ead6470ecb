"""Uniform model API (the LM part of the JAX registry):

    api = get_model(cfg, device)
    params = api.init(generator)              # a TransformerLM module
    loss = api.loss(params, batch)
    logits, aux = api.forward(params, batch)
    cache = api.init_cache(batch, max_len)
    logits, cache = api.decode(params, batch, cache, index)
    batch = api.input_specs(shape_spec, abstract=False, seed=0)

``abstract_cache`` and ``input_specs(..., abstract=True)`` build tensors on
the ``meta`` device, which takes the place of ``jax.eval_shape``: shapes
and dtypes, no storage.  A concrete batch is drawn from numpy with the
seed (the JAX package draws from ``jax.random``, so the two differ; parity
tests hand both packages one numpy batch).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..device import resolve_device
from . import transformer


def _concrete(specs: Dict[str, torch.Tensor], device: torch.device,
              seed: int = 0) -> Dict[str, torch.Tensor]:
    """Values for meta-tensor specs: ints in [0, 32) and normal floats, as
    the reference's ``_concrete`` draws them, from numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in specs.items():
        if s.dtype.is_floating_point:
            x = torch.from_numpy(rng.standard_normal(
                tuple(s.shape), dtype=np.float32)).to(s.dtype)
        else:
            x = torch.from_numpy(rng.integers(0, 32, tuple(s.shape),
                                              dtype=np.int32))
        out[name] = x.to(device)
    return out


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    init_cache: Callable
    abstract_cache: Callable
    decode: Callable
    loss: Callable
    forward: Callable
    input_specs: Callable


def _lm_api(cfg: ModelConfig, device: torch.device) -> ModelAPI:
    dtype = getattr(torch, cfg.dtype)

    def input_specs(shape: ShapeSpec, abstract: bool = True,
                    per_device_batch: Optional[int] = None, seed: int = 0):
        b = per_device_batch or shape.global_batch
        s = shape.seq_len

        def spec(dims, dt):
            return torch.empty(dims, dtype=dt, device="meta")

        if cfg.frontend == "vision_stub":
            n_txt = s - cfg.n_patches
            specs = {"tokens": spec((b, n_txt), torch.int32),
                     "labels": spec((b, n_txt), torch.int32),
                     "extra_embeds": spec((b, cfg.n_patches, cfg.d_model),
                                          dtype)}
        else:
            specs = {"tokens": spec((b, s), torch.int32),
                     "labels": spec((b, s), torch.int32)}
        if shape.kind == "prefill":
            specs.pop("labels")
        return specs if abstract else _concrete(specs, device, seed)

    def loss(params, batch, remat_policy=None):
        return transformer.loss_fn(params, batch, cfg,
                                   remat_policy=remat_policy)

    def fwd(params, batch):
        return transformer.forward(params, batch["tokens"], cfg,
                                   extra_embeds=batch.get("extra_embeds"))

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
                    abstract_cache=abstract_cache, decode=decode, loss=loss,
                    forward=fwd, input_specs=input_specs)


def get_model(cfg: ModelConfig, device=None) -> ModelAPI:
    if cfg.enc_dec:
        raise NotImplementedError(
            "encoder-decoder models (whisper) are not ported yet")
    return _lm_api(cfg, resolve_device(device))
