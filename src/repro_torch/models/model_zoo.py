"""Model API of the ported families (counterpart of
``repro/models/model_zoo.py``): dense -- qwen3-8b, phi4-mini-3.8b,
qwen1.5-110b and gemma3-12b (``window_schedule``'s local and global
layers); MoE -- grok-1-314b and arctic-480b (``models/moe.py``, arctic
with its dense residual MLP); VLM -- qwen2-vl-72b (``models/vlm.py``:
M-RoPE, prepended patch embeddings); SSM -- falcon-mamba-7b
(``models/ssm_lm.py``); hybrid -- zamba2-7b (``models/hybrid.py``);
enc-dec -- whisper-base (``models/encdec.py``).

``build_model(cfg)`` returns a ``ModelApi`` bound to a device -- the card
unless the caller passes ``device="cpu"``; with no card and no explicit
CPU request it raises.  Its members:

  init(generator) -> params
  train_loss(params, batch) -> scalar   (the mean token cross entropy;
      under a ``mode="qat"`` ctx every quantized site runs its STEs)
  forward(params, batch) -> logits
  init_cache(batch, max_len) -> cache
  prefill(params, batch, cache) -> (last-token logits, cache)
  decode(params, token, pos, cache) -> (logits, cache)
  prefill_chunk(params, tokens, start, cache) -> (last-token logits, cache)
      one (B, S) chunk of prompt at [start, start + S) against the whole
      cache; None for the SSM, hybrid and enc-dec families, whose decode
      state has no chunk graph (the staged engine prefills them a token
      at a time through ``decode``)
  insert(cache, prefix, slot) -> cache
      a B=1 prefix cache copied into batch row ``slot`` (every leaf's row
      is overwritten, so nothing of the slot's previous occupant survives:
      an SSM state, unlike a KV row, is not masked by position); the
      enc-dec family's ``enc_out`` has its batch on axis 0

PTQ: ``quantize_and_plan`` (optionally calibrated on ``make_smoke_batch``
batches) or ``init_quantized`` (one site at a time, never the whole float
tree).  Artifacts: ``save_servable`` writes (qparams, plan, ArchConfig) in
the reference's format; ``load_servable`` cold-starts from one written by
either package, with no float weights and no calibration.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, config_from_dict, config_to_dict
from repro_torch.convert import LAYER_LISTS
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, spmd, ssm_lm, transformer, vlm
from repro_torch.quant import api as quant_api
from repro_torch.quant.backends import BACKENDS
from repro_torch.quant.plan import QuantCtx, QuantPlan, compile_policy
from repro_torch.training import checkpoint as ckpt


@dataclasses.dataclass
class ModelApi:
    cfg: ArchConfig
    ctx: QuantCtx
    device: torch.device
    init: Callable  # (generator) -> params
    train_loss: Callable  # (params, batch) -> scalar
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

    def compiled(self, params) -> "ModelApi":
        """This api's policy compiled against ``params`` (in its mode), or
        itself for a full-precision ctx."""
        if self.ctx.policy is None:
            return self
        return self.with_plan(compile_policy(self.ctx.policy, params, mode=self.ctx.mode, backend=self.ctx.backend))


def make_ctx(cfg: ArchConfig) -> QuantCtx:
    """The pre-compile ctx of ``cfg.quant`` (``QuantCtx.from_config``)."""
    return QuantCtx.from_config(cfg.quant)


def insert_prefix(cache, prefix, slot: int, batch_axis_overrides: Optional[Dict[str, int]] = None):
    """Copy a B=1 ``prefix`` cache into batch row ``slot`` of ``cache``, in
    place, through nested dicts.  Every leaf is stacked (layers, B, ...),
    so the batch axis is 1; ``batch_axis_overrides`` names top-level
    leaves whose batch axis differs (the enc-dec family's (B, T, d)
    ``enc_out``: 0)."""
    over = batch_axis_overrides or {}
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            insert_prefix(leaf, prefix[name], slot)
        elif over.get(name, 1) == 0:
            leaf[int(slot)] = prefix[name][0]
        else:
            leaf[:, int(slot)] = prefix[name][:, 0]
    return cache


# family -> the init of its parameter tree, (generator, cfg, device, leaf) -> params
_INIT = {"dense": transformer.init_lm, "moe": transformer.init_lm, "vlm": transformer.init_lm,
         "ssm": ssm_lm.init_ssm_lm, "hybrid": hybrid.init_hybrid, "encdec": encdec.init_encdec}


def build_model(cfg: ArchConfig, ctx: Optional[QuantCtx] = None, *, device=None) -> ModelApi:
    dev = resolve_device(device)
    ctx = ctx or make_ctx(cfg)
    fam = cfg.family
    if fam not in _INIT:
        raise ValueError(fam)
    init = lambda gen: _INIT[fam](gen, cfg, dev)  # noqa: E731
    if fam == "encdec":
        return ModelApi(
            cfg, ctx, dev, init=init,
            train_loss=lambda p, b: encdec.loss_fn(p, b, cfg, ctx),
            forward=lambda p, b: encdec.forward(p, b, cfg, ctx),
            init_cache=lambda b, m: encdec.init_cache(cfg, b, m, device=dev),
            decode=lambda p, t, pos, c: encdec.decode_step(p, t, pos, cfg, ctx, c),
            prefill=lambda p, b, c: encdec.prefill(p, b, cfg, ctx, c),
            insert=lambda c, pre, s: insert_prefix(c, pre, s, batch_axis_overrides={"enc_out": 0}),
        )
    if fam in ("ssm", "hybrid"):
        mod = ssm_lm if fam == "ssm" else hybrid
        return ModelApi(
            cfg, ctx, dev, init=init,
            train_loss=lambda p, b: mod.loss_fn(p, b, cfg, ctx),
            forward=lambda p, b: mod.forward(p, b["tokens"], cfg, ctx),
            init_cache=lambda b, m: mod.init_cache(cfg, b, m, device=dev),
            decode=lambda p, t, pos, c: mod.decode_step(p, t, pos, cfg, ctx, c),
            insert=insert_prefix,  # SSM states and per-superblock KV: all (layers, B, ...)
        )
    if fam == "vlm":
        train_loss = lambda p, b: vlm.loss_fn(p, b, cfg, ctx)  # noqa: E731
        forward = lambda p, b: vlm.forward(p, b, cfg, ctx)  # noqa: E731
        prefill = lambda p, b, c: vlm.prefill(p, b, cfg, ctx, c)  # noqa: E731
    else:
        train_loss = lambda p, b: transformer.loss_fn(p, b, cfg, ctx)  # noqa: E731
        forward = lambda p, b: transformer.forward(p, b["tokens"], cfg, ctx)  # noqa: E731
        prefill = lambda p, b, c: transformer.prefill(p, b["tokens"], cfg, ctx, c)  # noqa: E731
    return ModelApi(
        cfg, ctx, dev, init=init, train_loss=train_loss, forward=forward,
        init_cache=lambda b, m: transformer.init_cache(cfg, b, m, device=dev),
        decode=lambda p, t, pos, c: transformer.decode_step(p, t, pos, cfg, ctx, c),
        prefill=prefill,
        prefill_chunk=lambda p, t, start, c: transformer.prefill_chunk(p, t, start, cfg, ctx, c),
        insert=insert_prefix,
    )


def make_smoke_batch(gen: torch.Generator, cfg: ArchConfig, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    """A seeded (batch, seq) batch on ``gen``'s device: ``tokens``; a VLM's
    ``vision_embeds`` (batch, n_frontend_tokens, d_model) and their (3,
    batch, n_vis + seq) M-RoPE ``positions``; an enc-dec model's ``frames``
    (batch, n_audio_frames, d_model); then the training ``labels`` (batch,
    seq), drawn last.  (The reference draws its own with ``jax.random``.)"""
    dev = gen.device
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=dev, dtype=torch.int32)}
    if cfg.family == "vlm":
        nv = cfg.n_frontend_tokens
        out["vision_embeds"] = (torch.randn((batch, nv, cfg.d_model), generator=gen, device=dev) * 0.1
                                ).to(getattr(torch, cfg.dtype))
        out["positions"] = vlm.build_mrope_positions(batch, nv, seq, device=dev)
    if cfg.family == "encdec":
        out["frames"] = (torch.randn((batch, cfg.n_audio_frames, cfg.d_model), generator=gen, device=dev) * 0.1
                         ).to(getattr(torch, cfg.dtype))
    out["labels"] = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=dev, dtype=torch.int32)
    return out


def quantize_and_plan(api: ModelApi, params, calib_batches=None) -> Tuple[Any, QuantPlan, ModelApi]:
    """PTQ of float params: (qparams, plan, plan-bound api).  With
    ``calib_batches`` (forward batches), a full-precision observing pass
    profiles every site and the plan carries static DFP exponents; without,
    every site uses dynamic per-row exponents."""
    qc = api.cfg.quant
    qparams, plan = quant_api.quantize_model(
        params, api.ctx.policy, mode="ptq", backend=qc.backend, calib_batches=calib_batches,
        forward=lambda p, b, ctx: api.with_ctx(ctx).forward(p, b), act_bits=qc.act_bits,
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
    params = _INIT[api.cfg.family](
        gen, api.cfg, api.device,
        leaf=lambda path, key, val: quant_api.quantize_leaf(path, key, val, rules),
    )
    plan = compile_policy(policy, params, mode="ptq", backend=api.cfg.quant.backend)
    return params, plan, api.with_plan(plan)


def abstract_quantized(cfg: ArchConfig) -> Any:
    """The PTQ tree of ``cfg`` (ternary and int8 sites) over ``meta``
    tensors: every leaf's shape and dtype, nothing allocated -- what the
    sharding rules reckon a rank's resident bytes from at full depth."""
    rules = QuantPlan(policy=make_ctx(cfg).policy)
    return _INIT[cfg.family](torch.Generator(), cfg, torch.device("meta"),
                             leaf=lambda path, key, val: quant_api.quantize_leaf(path, key, val, rules))


def save_servable(artifact_dir: str, api: ModelApi, qparams, plan: QuantPlan, mesh=None) -> str:
    """Persist (qparams, plan) with the serialized ArchConfig as a
    self-contained artifact; returns the step directory.  With ``mesh`` (a
    whole tree, any mesh the rules take) the payloads the serving rules
    split are written as shard files."""
    return quant_api.save_artifact(artifact_dir, qparams, plan, extra={"arch_config": config_to_dict(api.cfg)},
                                   mesh=mesh)


def load_servable(artifact_dir: str, mesh=None, *, device=None,
                  backend: Optional[str] = None) -> Tuple[ModelApi, Any, "quant_api.Artifact"]:
    """Cold-start from a packed artifact: (api, qparams, artifact) on
    ``device`` (the card unless ``"cpu"``; on a mesh, the mesh's device).
    With ``mesh`` (a ``parallel.collectives.Mesh``) the qparams are this
    rank's shards (``models.spmd.RankLocal``), read from its own shard
    files where the artifact's layout matches the mesh.  The model is rebuilt from the
    artifact's own ArchConfig and bound to its plan (calibrated exponents
    included); stacked layers split into the port's per-layer lists.  The
    plan's backend must be one of the port's, or ``backend`` replaces it
    (an artifact of the reference's launcher names ``xla``)."""
    dev = resolve_device(device if device is not None or mesh is None else mesh.device)
    art = quant_api.load_artifact(artifact_dir, mesh=mesh, device=dev)
    cfg_dict = art.extra.get("arch_config")
    if cfg_dict is None:
        raise ValueError(f"artifact at {artifact_dir!r} carries no 'arch_config' metadata; save it with "
                         "repro_torch.models.save_servable")
    cfg = config_from_dict(cfg_dict)
    params = {k: ckpt.unstack(v) if k in LAYER_LISTS else v for k, v in art.params.items()}
    if mesh is not None:
        spmd.check_family(cfg, mesh)
        params = spmd.RankLocal(params, spmd.layer_specs(art.shardings))
    api = build_model(cfg, device=dev)
    plan = art.plan
    if plan is not None:
        if backend is not None:
            plan = dataclasses.replace(plan, backend=backend)
        if plan.backend not in BACKENDS + ("auto",):
            raise ValueError(f"artifact at {artifact_dir!r}: its plan's backend {plan.backend!r} is not one of the "
                             f"port's {BACKENDS + ('auto',)}; pass backend= to serve it through one of them")
        api = api.with_plan(plan)
    return api, params, art
