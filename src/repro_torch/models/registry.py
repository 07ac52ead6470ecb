"""Uniform model API over every architecture family (the JAX registry):

    api = get_model(cfg, device)
    params = api.init(generator)      # a TransformerLM or WhisperModel
    axes = api.param_axes()           # logical axes, params' structure
    loss = api.loss(params, batch)
    logits, aux = api.forward(params, batch)
    cache = api.init_cache(batch, max_len)
    axes = api.cache_axes()           # the cache's logical axes
    logits, cache = api.decode(params, batch, cache, index)
    batch = api.input_specs(shape_spec, abstract=False, seed=0)
    batch = api.decode_input_specs(shape_spec, abstract=False, seed=0)

``get_model`` dispatches on ``cfg.enc_dec``: whisper's API
(``models/whisper.py``) or the decoder LM's.  ``shell()`` builds the
parameter module on the ``meta`` device (shapes and dtypes, no storage),
for callers that fill or trace it.  ``abstract_cache`` and
``input_specs(..., abstract=True)`` build tensors on the ``meta`` device, which takes the place of ``jax.eval_shape``: shapes
and dtypes, no storage.  The reference's ``init_cache`` returns ``(cache,
axes)``; here ``init_cache``/``abstract_cache`` return the cache alone
(the serving engine reads ``abstract_cache(1, 1)``) and ``cache_axes()``
the axes tree beside it.  A concrete batch is drawn from numpy with the
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
from . import transformer, whisper


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


def _spec(dims, dtype) -> torch.Tensor:
    return torch.empty(dims, dtype=dtype, device="meta")


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    shell: Callable
    init_cache: Callable
    abstract_cache: Callable
    cache_axes: Callable
    decode: Callable
    loss: Callable
    forward: Callable
    input_specs: Callable
    decode_input_specs: Callable

    def param_axes(self) -> Dict:
        """The logical axes of every parameter, as a nested dict with the
        parameter tree's paths (the reference's axes tree from
        ``api.init``), read off a ``meta`` shell."""
        return self.shell().param_axes()


def _lm_api(cfg: ModelConfig, device: torch.device) -> ModelAPI:
    dtype = getattr(torch, cfg.dtype)

    def input_specs(shape: ShapeSpec, abstract: bool = True,
                    per_device_batch: Optional[int] = None, seed: int = 0):
        b = per_device_batch or shape.global_batch
        s = shape.seq_len
        if cfg.frontend == "vision_stub":
            n_txt = s - cfg.n_patches
            specs = {"tokens": _spec((b, n_txt), torch.int32),
                     "labels": _spec((b, n_txt), torch.int32),
                     "extra_embeds": _spec((b, cfg.n_patches, cfg.d_model),
                                           dtype)}
        else:
            specs = {"tokens": _spec((b, s), torch.int32),
                     "labels": _spec((b, s), torch.int32)}
        if shape.kind == "prefill":
            specs.pop("labels")
        return specs if abstract else _concrete(specs, device, seed)

    def decode_input_specs(shape: ShapeSpec, abstract: bool = True,
                           per_device_batch: Optional[int] = None,
                           seed: int = 0):
        b = per_device_batch or shape.global_batch
        specs = {"tokens": _spec((b, 1), torch.int32)}
        if cfg.frontend == "vision_stub":
            specs["extra_embeds"] = _spec((b, 0, cfg.d_model), dtype)
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

    return ModelAPI(cfg=cfg, device=device, init=init,
                    shell=lambda: transformer.TransformerLM(cfg,
                                                            device="meta"),
                    init_cache=init_cache, abstract_cache=abstract_cache,
                    cache_axes=lambda: transformer.cache_axes(cfg),
                    decode=decode, loss=loss, forward=fwd,
                    input_specs=input_specs,
                    decode_input_specs=decode_input_specs)


def _whisper_api(cfg: ModelConfig, device: torch.device) -> ModelAPI:
    dtype = getattr(torch, cfg.dtype)

    def input_specs(shape: ShapeSpec, abstract: bool = True,
                    per_device_batch: Optional[int] = None, seed: int = 0):
        b = per_device_batch or shape.global_batch
        s_enc = shape.seq_len
        s_dec = max(shape.seq_len // cfg.enc_seq_ratio, 8)
        specs = {"audio_feats": _spec((b, s_enc, cfg.d_model), dtype),
                 "tokens": _spec((b, s_dec), torch.int32),
                 "labels": _spec((b, s_dec), torch.int32)}
        if shape.kind == "prefill":
            specs.pop("labels")
        return specs if abstract else _concrete(specs, device, seed)

    def decode_input_specs(shape: ShapeSpec, abstract: bool = True,
                           per_device_batch: Optional[int] = None,
                           seed: int = 0):
        # the reference's lengths: enc_out is seq_len // enc_seq_ratio long
        b = per_device_batch or shape.global_batch
        s_enc = max(shape.seq_len // cfg.enc_seq_ratio, 8)
        specs = {"tokens": _spec((b, 1), torch.int32),
                 "enc_out": _spec((b, s_enc, cfg.d_model), dtype)}
        return specs if abstract else _concrete(specs, device, seed)

    def loss(params, batch, remat_policy=None):
        return whisper.loss_fn(params, batch, cfg, remat_policy=remat_policy)

    def init(generator: torch.Generator) -> whisper.WhisperModel:
        return whisper.init_whisper(cfg, generator, device)

    def init_cache(batch: int, max_len: int, device=device):
        return whisper.init_cache(cfg, batch, max_len, device)

    def abstract_cache(batch: int, max_len: int):
        return whisper.init_cache(cfg, batch, max_len, "meta")

    def decode(params, batch, cache, index):
        return whisper.decode_step(params, cfg, batch["tokens"], cache,
                                   index, batch["enc_out"])

    return ModelAPI(cfg=cfg, device=device, init=init,
                    shell=lambda: whisper.abstract_whisper(cfg),
                    init_cache=init_cache, abstract_cache=abstract_cache,
                    cache_axes=lambda: whisper.cache_axes(cfg),
                    decode=decode, loss=loss,
                    forward=lambda params, batch: whisper.forward(
                        params, batch, cfg),
                    input_specs=input_specs,
                    decode_input_specs=decode_input_specs)


def get_model(cfg: ModelConfig, device=None) -> ModelAPI:
    if cfg.enc_dec:
        return _whisper_api(cfg, resolve_device(device))
    return _lm_api(cfg, resolve_device(device))
