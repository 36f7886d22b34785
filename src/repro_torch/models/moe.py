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
add.  The reference's ``FLAT_CHUNKING`` toggle (a perf experiment, off by
default) is not ported.

On a mesh (``models/spmd.py``) the layer first all-gathers a batch split
over the data axes, so the router, the capacity C and the drops are the
whole batch's, as the reference's global sort over every replica makes
them.  Expert parallelism: the reference takes its shard_map EP route only
under its ``pallas_ep`` backend; the port has ``ref`` and ``cuda`` and
takes EP on either, whenever a mesh with ``model`` > 1 splits the experts
(``_use_ep``: the reference's ``ep_divisible`` over ``_ep_cap_axes``).
Every rank of the model group holds the whole capacity buffer (its
activations are replicated), so no dispatch collective is needed: each
rank runs its experts' slice of the buffer through one ``quantize_rows``
and one packed launch a site, casts to the model dtype and all-gathers the
(E, C, d) result over 'model' (``quant.backends.expert_ffn_ep``).  Expert
stacks the rules split on K or N instead (E not divisible by 'model') run
each site on its gathered weight or its own columns, as ``layers.dense``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.core import ste
from repro_torch.core.quantizer import QTensor
from repro_torch.models import layers, spmd
from repro_torch.parallel import sharding
from repro_torch.quant import api as quant_api  # the module: importable while repro_torch.quant initializes
from repro_torch.quant.backends import apply_act, ep_divisible, expert_ffn_ep, qmatmul
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
        state = spmd.active()
        dim = None if state is None else state.layout(path)
        if dim == -2:  # the stack split on K: run it whole
            w = spmd.gather_weight(w, state.mesh, -2)
        y = qmatmul(x, w, backend=ctx.backend, act_bits=prec.act_bits if prec else 8,
                    act_exponent=ctx.act_exponent(path))
        return spmd.gather_model(y, state) if dim == -1 else y
    prec = ctx.resolve(path) if ctx.mode == "qat" else None
    if prec is not None and prec.quantized:
        wq = torch.stack([ste.weights_ste(we.to(torch.float32), prec.w_bits, prec.group_size, prec.filter_size,
                                          prec.refit_scale, fmt=prec.fmt) for we in w]).to(x.dtype)
        xq = ste.act_ste(x.to(torch.float32), prec.act_bits).to(x.dtype)
        return torch.einsum("ecd,edf->ecf", xq, wq)
    return torch.einsum("ecd,edf->ecf", x, w)


def _ep_cap_axes(mesh, c: int):
    """The data axes the reference shards the capacity axis over besides
    the expert axis (only where C stays divisible)."""
    sizes = sharding.mesh_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    total = sizes.get("model", 1)
    for a in axes:
        total *= sizes[a]
    return axes if (axes and c % total == 0) else ()


def _use_ep(experts, e: int, c: int, ctx: QuantCtx) -> bool:
    """Run this chunk's expert FFN expert-parallel?  PTQ (QTensor weights)
    under an ambient mesh whose expert axis divides the (E, C) buffer."""
    state = spmd.active()
    return (isinstance(experts["gate"]["w"], QTensor) and state is not None
            and ep_divisible(e, c, state.mesh, "model", _ep_cap_axes(state.mesh, c)))


def _expert_ffn(experts, xb: torch.Tensor, path: str, ctx: QuantCtx) -> torch.Tensor:
    """gate / up / down over the dispatched (E, C, d) buffer; expert-
    parallel on a mesh that splits the experts (the result then comes back
    whole, in the buffer's dtype)."""
    state = spmd.active()
    if state is not None and state.layout(f"{path}/experts/gate") == -3:
        if not _use_ep(experts, xb.shape[0], xb.shape[1], ctx):
            raise NotImplementedError(f"experts split over model={state.model}, a capacity of {xb.shape[1]} it does "
                                      f"not divide (the reference's ep_divisible)")

        def site_kw(name):
            site = f"{path}/experts/{name}"
            prec = ctx.resolve(site)
            return {"act_bits": prec.act_bits if prec else 8, "act_exponent": ctx.act_exponent(site)}

        return expert_ffn_ep({n: experts[n]["w"] for n in ("gate", "up", "down")}, xb, mesh=state.mesh,
                             backend=ctx.backend, site_kwargs={n: site_kw(n) for n in ("gate", "up", "down")})

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
    state = spmd.active()
    if state is not None and state.batch_sharded:  # route over the whole batch
        out = spmd.local_rows(_experts(p, spmd.gather_batch(x, state), path, cfg, ctx), state,
                              x.shape[0] * state.mesh.axis_size(state.batch_axes))
    else:
        out = _experts(p, x, path, cfg, ctx)
    if "residual_mlp" in p:
        out = out + layers.mlp(p["residual_mlp"], x, f"{path}/residual_mlp", ctx)
    return out


def _experts(p, x: torch.Tensor, path: str, cfg, ctx: QuantCtx) -> torch.Tensor:
    b, s, d = x.shape
    n_chunks = max(1, b * s // max(cfg.moe_chunk_tokens, 1))
    while s % n_chunks:
        n_chunks -= 1
    sc = s // n_chunks
    # several chunks: each recomputed in the backward pass, as the reference's checkpointed scan body
    outs = [layers.maybe_remat(n_chunks > 1, _dispatch_chunk, p, x[:, i * sc:(i + 1) * sc].reshape(b * sc, d), path,
                               cfg, ctx).reshape(b, sc, d)
            for i in range(n_chunks)]
    return (outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)).to(x.dtype)


def aux_load_balance_loss(logits: torch.Tensor, top_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: n_experts * sum over experts of the mean
    router probability times the share of top-k picks."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    me = probs.mean(0)
    ce = torch.bincount(top_ids.reshape(-1), minlength=n_experts).to(torch.float32) / top_ids.numel()
    return n_experts * torch.sum(me * ce)
