"""Building-block layers over plain dicts of tensors (counterpart of
``repro/models/layers.py``).

Every projection goes through ``dense``: full precision (``x @ W``), QAT
(``mode="qat"``: the weights through their straight-through estimator --
INQ's learned grid, TTQ's trained scales or the plain weight STE -- and x
through the clipped 8-bit activation STE, Sec. 4 of the paper), or PTQ
with a QTensor weight through ``qdense`` -- one whole-site call carrying
the bias and activation into the kernel epilogue, with the plan's
calibrated static activation exponent where the site has one.  A ctx
carrying an ``observer`` records each site's input range first (the
calibration pass).  ``lm_head_loss`` is the training loss: the lm_head and
cross entropy in chunks of tokens, each recomputed in the backward pass.
``remat`` is that recompute (the reference's ``jax.checkpoint``): every
family wraps each block in it under ``cfg.remat``, and the inner loops the
reference always checkpoints (attention's key chunks, the MoE token chunks,
the SSM scan chunks) use it whatever the config says.

Init functions take an explicit ``torch.Generator`` and ``device``, plus a
``leaf(path, key, tensor)`` hook every created parameter passes through, so
a caller can quantize each site as it is made.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.core import ste
from repro_torch.core.quantizer import QTensor
from repro_torch.models import spmd
from repro_torch.quant import api as quant_api  # the module: importable while repro_torch.quant initializes
from repro_torch.quant.backends import apply_act, qdense
from repro_torch.quant.plan import QuantCtx

Params = Dict[str, Any]
Leaf = Callable[[str, str, torch.Tensor], Any]


def keep(path: str, key: str, val):
    return val


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def init_dense(gen, d_in: int, d_out: int, bias: bool, dtype, device, path: str = "",
               leaf: Leaf = keep) -> Params:
    w = (_randn(gen, (d_in, d_out), device) * d_in**-0.5).to(dtype)
    p = {"w": leaf(path, "w", w)}
    if bias:
        p["b"] = leaf(path, "b", torch.zeros((d_out,), dtype=dtype, device=device))
    return p


def dense(p: Params, x: torch.Tensor, path: str, ctx: QuantCtx,
          act: Optional[str] = None, local_out: bool = False) -> torch.Tensor:
    """Projection x @ W (+ b) (+ activation ``act``).  On a mesh
    (``models/spmd.py``) a site split on K runs whole on its gathered
    weight, and one split on N runs on the rank's columns, gathered back
    unless ``local_out`` (attention's heads local to the rank)."""
    state = spmd.active()
    dim = None if state is None else state.layout(path)
    if dim == -2:
        return _dense({**p, "w": spmd.gather_weight(p["w"], state.mesh, -2)}, x, path, ctx, act)
    if dim == -1:
        w = p["w"]
        local = {**p, "b": spmd.local_bias(p["b"], w.n if isinstance(w, QTensor) else w.shape[-1], state)} \
            if "b" in p else p
        y = _dense(local, x, path, ctx, act)
        return y if local_out else spmd.gather_model(y, state)
    return _dense(p, x, path, ctx, act)


def _dense(p: Params, x: torch.Tensor, path: str, ctx: QuantCtx, act: Optional[str]) -> torch.Tensor:
    w = p["w"]
    if ctx.observer is not None:  # calibration pass: record this site's range
        quant_api.observe_site(ctx.observer, path, x)
    if isinstance(w, QTensor):  # PTQ: the full integer pipeline, one call
        prec = ctx.resolve(path)
        y = qdense(
            x, w, bias=p.get("b"), act=act, backend=ctx.backend,
            act_bits=prec.act_bits if prec else 8,
            act_exponent=ctx.act_exponent(path),
            fused=prec.fused if prec else True,
        )
        return y.to(x.dtype)
    prec = ctx.resolve(path) if ctx.mode == "qat" else None
    if prec is not None and prec.quantized:
        wf = w.to(torch.float32)
        if "inq_mask" in p:  # learned-grid INQ: the whole tensor onto the trained grid
            wq = ste.inq_ste(wf, p["inq_mask"], p["inq_scales"], prec.w_bits, prec.group_size, prec.filter_size,
                             prec.refit_scale, fmt=prec.fmt)
        elif prec.fmt == "ttq" and "ttq_scales" in p:
            wq = ste.ttq_ste(wf, p["ttq_scales"], prec.group_size)
        else:
            wq = ste.weights_ste(wf, prec.w_bits, prec.group_size, prec.filter_size, prec.refit_scale, fmt=prec.fmt)
        xq = ste.act_ste(x.to(torch.float32), prec.act_bits).to(x.dtype)
        y = xq @ wq.to(x.dtype)
    elif x.dtype != w.dtype:  # jnp's promotion (a bf16 enc_out into a float32 model's cross-attention)
        dt = torch.promote_types(x.dtype, w.dtype)
        y = x.to(dt) @ w.to(dt)
    else:
        y = x @ w
    if "b" in p:
        y = y + p["b"]
    return apply_act(y, act)


def init_rmsnorm(d: int, dtype, device, path: str = "", leaf: Leaf = keep) -> Params:
    return {"scale": leaf(path, "scale", torch.ones((d,), dtype=dtype, device=device))}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)).to(x.dtype)


def init_layernorm(d: int, dtype, device, path: str = "", leaf: Leaf = keep) -> Params:
    return {"scale": leaf(path, "scale", torch.ones((d,), dtype=dtype, device=device)),
            "bias": leaf(path, "bias", torch.zeros((d,), dtype=dtype, device=device))}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """float32 inside, population variance, the result in x's dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"] + p["bias"]).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    sin, cos = torch.sin(angles)[..., None, :], torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float, sections=(1, 1, 2)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: positions (3, ..., S) = (t, h, w) ids; the
    hd/2 frequency lanes are split across the three components in the ratio
    ``sections`` (1:1:2 t:h:w by default), each lane rotating by its
    component's position."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    n = hd // 2
    total = sum(sections)
    bounds = [n * sum(sections[:i + 1]) // total for i in range(3)]
    lane = torch.arange(n, device=x.device)
    comp = torch.where(lane < bounds[0], 0, torch.where(lane < bounds[1], 1, 2))
    pos = positions.to(torch.float32)[..., None] * torch.ones_like(freqs)  # (3, ..., S, hd/2)
    pos = torch.gather(pos, 0, comp.expand(1, *positions.shape[1:], n))[0]  # each lane's component
    angles = pos * freqs
    sin, cos = torch.sin(angles)[..., None, :], torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen, d_model: int, d_ff: int, dtype, device, path: str = "",
             leaf: Leaf = keep) -> Params:
    return {
        "up": init_dense(gen, d_model, d_ff, False, dtype, device, f"{path}/up", leaf),
        "gate": init_dense(gen, d_model, d_ff, False, dtype, device, f"{path}/gate", leaf),
        "down": init_dense(gen, d_ff, d_model, False, dtype, device, f"{path}/down", leaf),
    }


def mlp(p: Params, x: torch.Tensor, path: str, ctx: QuantCtx) -> torch.Tensor:
    # silu rides into the gate projection's kernel epilogue
    h = dense(p["gate"], x, f"{path}/gate", ctx, act="silu")
    h = h * dense(p["up"], x, f"{path}/up", ctx)
    return dense(p["down"], h, f"{path}/down", ctx)


def init_embedding(gen, vocab: int, d: int, dtype, device, path: str = "embed",
                   leaf: Leaf = keep) -> Params:
    table = (_randn(gen, (vocab, d), device) * d**-0.5).to(dtype)
    return {"table": leaf(path, "table", table)}


def embed(p: Params, tokens: torch.Tensor, path: str = "embed") -> torch.Tensor:
    state = spmd.active()
    if state is not None and state.layout(f"{path}/table") is not None:  # the vocab split over 'model'
        return spmd.embed(p["table"], tokens, state)
    return p["table"][tokens]


def _vocab_mask(padded: int, vocab: int, device) -> Optional[torch.Tensor]:
    """0 over the vocabulary, -1e30 over its padding (out of the partition
    function), or None without padding."""
    if padded <= vocab:
        return None
    return torch.cat([torch.zeros((vocab,), dtype=torch.float32, device=device),
                      torch.full((padded - vocab,), -1e30, dtype=torch.float32, device=device)])


def remat(fn: Callable, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) where gradients are being
    recorded, and a plain call otherwise (serving runs under
    ``inference_mode``).  The recompute gives the same values: the loss and
    gradients do not change, the peak memory falls.  ``fn`` is deterministic
    (no RNG), so no RNG state is kept."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def maybe_remat(on: bool, fn: Callable, *args):
    """``remat(fn, *args)`` where ``on`` (a config's ``remat``), else ``fn(*args)``."""
    return remat(fn, *args) if on else fn(*args)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean cross entropy over (B, S, V) logits, the vocabulary's padding
    masked out."""
    logits = logits.to(torch.float32)
    mask = _vocab_mask(logits.shape[-1], vocab, logits.device)
    if mask is not None:
        logits = logits + mask
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(lse - gold)


def lm_head_loss(head: Params, x: torch.Tensor, labels: torch.Tensor, vocab: int, path: str, ctx: QuantCtx,
                 chunk_tokens: int = 8192) -> torch.Tensor:
    """The lm_head and cross entropy fused, in chunks of tokens: x (B, S, d)
    final hidden states, labels (B, S).  Each chunk's logits are reduced to
    (logsumexp, gold) and recomputed in the backward pass
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``), so
    no more than one chunk's (tokens, V) float32 logits exist.  The chunk
    count is the reference's (the largest divisor of B * S at most
    B * S // chunk_tokens) and the float32 sum runs chunk by chunk, in its
    order."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    lt = labels.reshape(t).to(torch.int64)
    n_chunks = max(1, t // max(chunk_tokens, 1))
    while t % n_chunks:
        n_chunks -= 1
    tc = t // n_chunks
    mask = _vocab_mask(head["w"].shape[-1], vocab, x.device)

    def body(xc, lc):
        logits = dense(head, xc, path, ctx).to(torch.float32)
        if mask is not None:
            logits = logits + mask
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[:, None])[:, 0]
        return torch.sum(lse - gold)

    if n_chunks == 1:
        loss = torch.zeros((), dtype=torch.float32, device=x.device) + body(xt, lt)
    else:
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n_chunks):
            loss = loss + remat(body, xt[i * tc:(i + 1) * tc], lt[i * tc:(i + 1) * tc])
    return loss / t
