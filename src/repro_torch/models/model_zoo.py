"""Model API for the dense family (counterpart of
``repro/models/model_zoo.py``).

``build_model(cfg)`` returns a ``ModelApi`` bound to a device -- the card
unless the caller passes ``device="cpu"``; with no card and no explicit
CPU request it raises.  Its members:

  init(generator) -> params
  forward(params, batch) -> logits
  init_cache(batch, max_len) -> cache
  prefill(params, batch, cache) -> (last-token logits, cache)
  decode(params, token, pos, cache) -> (logits, cache)
  prefill_chunk(params, tokens, start, cache) -> (last-token logits, cache)
      one (B, S) chunk of prompt at [start, start + S) against the whole cache
  insert(cache, prefix, slot) -> cache
      a B=1 prefix cache copied into batch row ``slot`` (every leaf's row
      is overwritten, so nothing of the slot's previous occupant survives)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.quant import api as quant_api
from repro_torch.quant.plan import QuantCtx, QuantPlan, compile_policy


@dataclasses.dataclass
class ModelApi:
    cfg: ArchConfig
    ctx: QuantCtx
    device: torch.device
    init: Callable  # (generator) -> params
    forward: Callable  # (params, batch) -> logits
    init_cache: Callable  # (batch, max_len) -> cache
    decode: Callable  # (params, token, pos, cache) -> (logits, cache)
    prefill: Optional[Callable] = None  # (params, batch, cache) -> (logits, cache)
    prefill_chunk: Optional[Callable] = None  # (params, tokens, start, cache) -> (logits, cache)
    insert: Optional[Callable] = None  # (cache, prefix, slot) -> cache

    def with_ctx(self, ctx: QuantCtx) -> "ModelApi":
        return build_model(self.cfg, ctx, device=self.device)

    def with_plan(self, plan: QuantPlan) -> "ModelApi":
        return self.with_ctx(QuantCtx.for_plan(plan))


def insert_prefix(cache, prefix, slot: int):
    """Copy a B=1 ``prefix`` cache into batch row ``slot`` of ``cache``, in
    place (every leaf is stacked (layers, B, ...), so the batch axis is 1)."""
    for name, leaf in cache.items():
        leaf[:, int(slot)] = prefix[name][:, 0]
    return cache


def build_model(cfg: ArchConfig, ctx: Optional[QuantCtx] = None, *, device=None) -> ModelApi:
    dev = resolve_device(device)
    ctx = ctx or QuantCtx.from_config(cfg.quant)
    if cfg.family != "dense" or cfg.n_experts or cfg.sliding_window or cfg.mrope:
        raise NotImplementedError(f"{cfg.name}: only the dense global-attention decoder is ported")
    return ModelApi(
        cfg, ctx, dev,
        init=lambda gen: transformer.init_lm(gen, cfg, dev),
        forward=lambda p, b: transformer.forward(p, b["tokens"], cfg, ctx),
        init_cache=lambda b, m: transformer.init_cache(cfg, b, m, device=dev),
        decode=lambda p, t, pos, c: transformer.decode_step(p, t, pos, cfg, ctx, c),
        prefill=lambda p, b, c: transformer.prefill(p, b["tokens"], cfg, ctx, c),
        prefill_chunk=lambda p, t, start, c: transformer.prefill_chunk(p, t, start, cfg, ctx, c),
        insert=insert_prefix,
    )


def quantize_and_plan(api: ModelApi, params) -> Tuple[Any, QuantPlan, ModelApi]:
    """PTQ of float params: (qparams, plan, plan-bound api)."""
    qparams, plan = quant_api.quantize_model(
        params, api.ctx.policy, mode="ptq", backend=api.cfg.quant.backend
    )
    return qparams, plan, api.with_plan(plan)


def init_quantized(api: ModelApi, gen: torch.Generator) -> Tuple[Any, QuantPlan, ModelApi]:
    """Random parameters quantized one site at a time as they are made, so
    no more than one site's float weights ever exist (how a full-width
    model is built on the card).  Returns (qparams, plan, plan-bound api)."""
    policy = api.ctx.policy
    if policy is None:
        raise ValueError("init_quantized needs a PTQ config (cfg.quant.mode='ptq')")
    rules = QuantPlan(policy=policy)  # resolves every path by the policy's rules
    params = transformer.init_lm(
        gen, api.cfg, api.device,
        leaf=lambda path, key, val: quant_api.quantize_leaf(path, key, val, rules),
    )
    plan = compile_policy(policy, params, mode="ptq", backend=api.cfg.quant.backend)
    return params, plan, api.with_plan(plan)
