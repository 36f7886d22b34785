"""Model API for the dense family (counterpart of
``repro/models/model_zoo.py``).

``build_model(cfg)`` returns a ``ModelApi`` bound to a device -- the card
unless the caller passes ``device="cpu"``; with no card and no explicit
CPU request it raises.
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

    def with_ctx(self, ctx: QuantCtx) -> "ModelApi":
        return build_model(self.cfg, ctx, device=self.device)

    def with_plan(self, plan: QuantPlan) -> "ModelApi":
        return self.with_ctx(QuantCtx.for_plan(plan))


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
