"""Mixture-of-Experts layer, single device (counterpart of
``repro/models/moe.py``): top-k routing with static-capacity, sort-based
dispatch.

Per chunk of ``tc`` tokens (``_dispatch_chunk``): the router (a dense site,
pinned to int8 by the paper's policy) gives logits, a float32 softmax the
probabilities, top-k the experts (ties to the lower expert index, as
``lax.top_k``) and their renormalised gates.  The ``tc * k`` token replicas
are sorted stably by expert id; a replica's rank within its expert's group
comes from ``searchsorted``, and replicas ranked at or past the capacity C
are dropped.  The kept ones are scattered into a zeroed (E * C, d) buffer;
the expert FFN runs over it as (E, C, d); the combine gathers each
replica's row (zeros for a dropped one), scales it by its gate and adds it
into its token.  ``moe_layer`` chunks the sequence by ``moe_chunk_tokens``
(a plain loop) and adds arctic's dense residual MLP.

The expert FFN (gate, up, down) runs as: fp, einsums; PTQ, the expert
``qmatmul`` (``quant/backends.py``): one ``quantize_rows`` and ONE packed
launch per site over every expert; calibration, each site's (E, C, d)
buffer observed like a dense site's input (its zero padding never raises
max|x|); QAT (``mode="qat"``), each expert's weights through the weight
STE and the buffer through the activation STE, then the einsum, as the
reference's ``_quantize_expert_weights`` / ``_expert_matmul`` do.
``aux_load_balance_loss`` is the Switch-style auxiliary loss a trainer may
add.  What waits: expert parallelism over a mesh (the reference's
``expert_ffn_ep``, ``_use_ep``, ``_ep_cap_axes``) with multi-GPU serving
(ROADMAP A10).  The reference's ``FLAT_CHUNKING`` toggle (a perf
experiment, off by default) is not ported.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.core import ste
from repro_torch.core.quantizer import QTensor
from repro_torch.models import layers
from repro_torch.quant import api as quant_api  # the module: importable while repro_torch.quant initializes
from repro_torch.quant.backends import apply_act, qmatmul
from repro_torch.quant.plan import QuantCtx


def _expert_stack(gen, e: int, k: int, n: int, dtype, device) -> torch.Tensor:
    """(E, K, N) random weights of std K**-0.5, made an expert at a time so
    no more than one expert exists in float32 beside the stack."""
    w = torch.empty((e, k, n), dtype=dtype, device=device)
    for i in range(e):
        w[i] = (layers._randn(gen, (k, n), device) * k**-0.5).to(dtype)
    return w


def init_moe(gen, cfg, dtype, device, path: str = "blocks/moe", leaf=layers.keep) -> Dict[str, Any]:
    """The router (d -> E, no bias), the experts' stacked gate / up (E, d,
    ff) and down (E, ff, d), and arctic's residual MLP; each leaf passes
    through ``leaf`` as soon as it exists."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": layers.init_dense(gen, d, e, False, dtype, device, f"{path}/router", leaf), "experts": {}}
    for name, (k, n) in (("gate", (d, ff)), ("up", (d, ff)), ("down", (ff, d))):
        site = f"{path}/experts/{name}"
        p["experts"][name] = {"w": leaf(site, "w", _expert_stack(gen, e, k, n, dtype, device))}
    if cfg.moe_dense_residual:
        p["residual_mlp"] = layers.init_mlp(gen, d, ff, dtype, device, f"{path}/residual_mlp", leaf)
    return p


def _expert_matmul(w, x: torch.Tensor, path: str, ctx: QuantCtx) -> torch.Tensor:
    """x (E, C, d_in) @ w (E, d_in, d_out): float weights (fake-quantized
    under QAT), or an expert site's QTensor (the expert qmatmul, f32 out)."""
    if ctx.observer is not None:  # calibration pass: one record a site a call, as dense() sites
        quant_api.observe_site(ctx.observer, path, x)
    if isinstance(w, QTensor):
        prec = ctx.resolve(path)
        return qmatmul(x, w, backend=ctx.backend, act_bits=prec.act_bits if prec else 8,
                       act_exponent=ctx.act_exponent(path))
    prec = ctx.resolve(path) if ctx.mode == "qat" else None
    if prec is not None and prec.quantized:
        wq = torch.stack([ste.weights_ste(we.to(torch.float32), prec.w_bits, prec.group_size, prec.filter_size,
                                          prec.refit_scale, fmt=prec.fmt) for we in w]).to(x.dtype)
        xq = ste.act_ste(x.to(torch.float32), prec.act_bits).to(x.dtype)
        return torch.einsum("ecd,edf->ecf", xq, wq)
    return torch.einsum("ecd,edf->ecf", x, w)


def _expert_ffn(experts, xb: torch.Tensor, path: str, ctx: QuantCtx) -> torch.Tensor:
    """gate / up / down over the dispatched (E, C, d) buffer."""
    def em(name, v):
        return _expert_matmul(experts[name]["w"], v, f"{path}/experts/{name}", ctx)

    h = apply_act(em("gate", xb), "silu")
    h = h * em("up", xb)
    return em("down", h)


def capacity(n_tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(math.ceil(n_tokens * top_k * factor / n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


def top_k(probs: torch.Tensor, k: int):
    """(values, ids) of each row's k largest, ties to the lower index as
    ``lax.top_k`` gives them (``torch.topk`` promises no order): a stable
    descending sort."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def route(logits: torch.Tensor, k: int, c: int):
    """Router logits (tc, E) -> (dest, sorted_src, gate) of the tc * k
    token replicas in expert order: ``dest`` the replica's buffer row
    (E * C for a dropped one), ``sorted_src`` its token, ``gate`` its
    renormalised top-k probability."""
    tc, e = logits.shape
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_vals, top_ids = top_k(probs, k)
    top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
    flat_ids = top_ids.reshape(-1)
    arange = torch.arange(tc * k, device=logits.device)
    order = torch.sort(flat_ids, stable=True).indices  # jnp.argsort is stable
    sorted_ids = flat_ids[order]
    rank = arange - torch.searchsorted(sorted_ids, sorted_ids, side="left")
    dest = torch.where(rank < c, sorted_ids * c + rank, torch.full_like(rank, e * c))
    return dest, (arange // k)[order], top_vals.reshape(-1)[order]


def _dispatch_chunk(p, xt: torch.Tensor, path: str, cfg, ctx: QuantCtx) -> torch.Tensor:
    """Route one chunk of tokens (tc, d) through the experts."""
    tc, d = xt.shape
    e = cfg.n_experts
    c = capacity(tc, cfg.top_k, e, cfg.capacity_factor)
    dest, src, gate = route(layers.dense(p["router"], xt, f"{path}/router", ctx), cfg.top_k, c)
    # row E * C takes the dropped replicas (the reference's mode="drop") and is cut off
    buf = torch.zeros((e * c + 1, d), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt[src]
    yb = _expert_ffn(p["experts"], buf[:e * c].view(e, c, d), path, ctx).to(xt.dtype)
    # a zero row under E * C: a dropped replica gathers 0 (mode="fill")
    rows = torch.cat([yb.reshape(e * c, d), torch.zeros((1, d), dtype=xt.dtype, device=xt.device)])
    vals = rows[dest] * gate[:, None].to(xt.dtype)
    # index_add_ may add in any order (atomics on the card); with top_k = 2 a
    # token's sum is 0 + a + b, the same in either order, as the reference's
    return torch.zeros((tc, d), dtype=xt.dtype, device=xt.device).index_add_(0, src, vals)


def moe_layer(p, x: torch.Tensor, path: str, cfg, ctx: QuantCtx) -> torch.Tensor:
    """x (B, S, d): the sequence in chunks of about ``moe_chunk_tokens``
    tokens (the reference's sequence-aligned chunking; capacity is per
    chunk), then arctic's dense residual MLP beside the experts."""
    b, s, d = x.shape
    n_chunks = max(1, b * s // max(cfg.moe_chunk_tokens, 1))
    while s % n_chunks:
        n_chunks -= 1
    sc = s // n_chunks
    # several chunks: each recomputed in the backward pass, as the reference's checkpointed scan body
    outs = [layers.maybe_remat(n_chunks > 1, _dispatch_chunk, p, x[:, i * sc:(i + 1) * sc].reshape(b * sc, d), path,
                               cfg, ctx).reshape(b, sc, d)
            for i in range(n_chunks)]
    out = (outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)).to(x.dtype)
    if "residual_mlp" in p:
        out = out + layers.mlp(p["residual_mlp"], x, f"{path}/residual_mlp", ctx)
    return out


def aux_load_balance_loss(logits: torch.Tensor, top_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: n_experts * sum over experts of the mean
    router probability times the share of top-k picks."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    me = probs.mean(0)
    ce = torch.bincount(top_ids.reshape(-1), minlength=n_experts).to(torch.float32) / top_ids.numel()
    return n_experts * torch.sum(me * ce)
