"""qdense / qmatmul backends (counterpart of ``repro/quant/backends.py``).

  * ``ref``  : the plain oracle -- activation quantization, exact integer
               cluster dots (``kernels/ref.qmatmul_ref``), then exponents,
               bias and activation as separate steps.
  * ``cuda`` : the counterpart of ``pallas``.  Fused (a site's plan says
               ``fused=True``): the whole site is one call of its format's
               ``fused_kernel``.  Unfused: ``quantize_rows``, the format's
               packed ``kernel``, then ``out * 2**(scale_e + x_e)``, bias,
               activation.  Each kernel wrapper launches its CUDA kernel
               for a CUDA tensor and runs its plain version for a CPU one.
               The kernels take any M: no ``m_bucket`` padding.  A
               format without kernels (ttq) raises here, as the
               reference's ``pallas`` does.
  * ``auto`` : ``cuda`` for a CUDA tensor, ``ref`` for a CPU tensor.

``ep_divisible`` and ``expert_ffn_ep`` are the MoE expert FFN under expert
parallelism on one rank of a mesh (``models/moe.py``): the rank's experts
over its slice of the whole capacity buffer, on either backend, the
result all-gathered over the expert axis.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import dfp
from repro_torch.core.quantizer import QTensor
from repro_torch.kernels.fused_qmm import activation_fn
from repro_torch.kernels.quantize import quantize_rows
from repro_torch.kernels.ref import qmatmul_ref, quantize_rows_ref

BACKENDS = ("ref", "cuda")


def resolve_backend(name: str, x: torch.Tensor) -> str:
    if name == "auto":
        return "cuda" if x.is_cuda else "ref"
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; registered: {BACKENDS + ('auto',)}")
    return name


def quantize_activations(x: torch.Tensor, bits: int = 8, *, exponent=None, backend: str = "auto"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DFP-quantize activations (M, K) -> (int8 mantissas, int32 exponent(s)):
    against a static exponent, or per-row dynamic exponents through the
    ``quantize_rows`` kernel (``cuda``) or the oracle (``ref``)."""
    if exponent is not None:
        e = torch.tensor(int(exponent), dtype=torch.int32, device=x.device)
        return dfp.quantize(x, e, bits), e
    if resolve_backend(backend, x) == "cuda":
        return quantize_rows(x, bits)
    return quantize_rows_ref(x, bits)


def _cuda_backend(xq: torch.Tensor, xe, qt: QTensor, block_k: int) -> torch.Tensor:
    """The packed launch, then 2**(scale_e + x_e): per expert for an expert
    site's (E, C, K) xq and (E, C, 1) or 0-d xe."""
    from repro_torch.quant.formats import format_of

    out = format_of(qt).kernel(xq, qt.packed, qt.scale_m, group=qt.group_size, block_k=block_k)
    scale_e = qt.scale_e.reshape(-1, 1, 1) if qt.experts else qt.scale_e
    return out * dfp.exp2i(scale_e + xe)


def _backend(backend: str, x: torch.Tensor, qt: QTensor) -> str:
    """``resolve_backend``, refusing ``cuda`` for a format without kernels
    (ttq) before anything launches, as the reference's ``pallas`` does."""
    from repro_torch.quant.formats import format_of

    name = resolve_backend(backend, x)
    if name == "cuda" and format_of(qt).kernel is None:
        raise ValueError(f"format {qt.fmt!r} has no CUDA kernel; serve it through backend='ref'")
    return name


def _unfused(xm: torch.Tensor, qt: QTensor, name: str, act_bits: int, act_exponent, block_k: int):
    """Quantize, then the backend's matmul with exponents applied."""
    xq, xe = quantize_activations(xm, act_bits, exponent=act_exponent, backend=name)
    return _cuda_backend(xq, xe, qt, block_k) if name == "cuda" else qmatmul_ref(xq, xe, qt)


def _expert_qmatmul(x: torch.Tensor, qt: QTensor, name: str, act_bits: int, act_exponent,
                    block_k: int) -> torch.Tensor:
    """x (E, C, K) x an expert site's QTensor -> (E, C, N) f32: each expert
    as the reference's vmapped ``qmatmul`` computes it.  ``cuda``: the
    static exponent or ONE ``quantize_rows`` over all E * C rows (its
    exponents are per row, so they equal the per-expert ones), ONE packed
    launch over every expert, then 2**(scale_e[e] + x_e) per expert.
    ``ref`` loops over the experts through the oracle."""
    e, c, k = x.shape
    if name == "ref":
        return torch.stack([_unfused(x[i], qt.expert(i), name, act_bits, act_exponent, block_k) for i in range(e)])
    xq, xe = quantize_activations(x.reshape(e * c, k), act_bits, exponent=act_exponent, backend=name)
    return _cuda_backend(xq.reshape(e, c, k), xe.reshape(e, c, 1) if xe.ndim else xe, qt, block_k)


def qmatmul(x: torch.Tensor, qt: QTensor, *, backend: str = "auto", act_bits: int = 8,
            act_exponent=None, block_k: int = 512) -> torch.Tensor:
    """x [..., K] (float) x QTensor (K, N) -> [..., N] f32: 8-bit DFP
    activations (per-row dynamic exponents, or the static ``act_exponent``),
    int32 cluster sums, one scale multiply per cluster.  An expert site's
    QTensor (``qt.experts`` = E) takes x (E, C, K) -> (E, C, N)."""
    name = _backend(backend, x, qt)
    if qt.experts:
        return _expert_qmatmul(x.contiguous(), qt, name, act_bits, act_exponent, block_k)
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1]).contiguous()
    out = _unfused(xm, qt, name, act_bits, act_exponent, block_k)
    return out.reshape(*lead, qt.n)


def apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    return activation_fn(act)(y)  # the same table as the kernel epilogue


def qdense(
    x: torch.Tensor, qt: QTensor, *, bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None, backend: str = "auto", act_bits: int = 8,
    act_exponent=None, fused: bool = True, block_k: int = 512,
) -> torch.Tensor:
    """One quantized dense site: x [..., K] -> f32 [..., N] with exponents,
    ``bias`` and ``act`` applied."""
    from repro_torch.quant.formats import format_of

    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1]).contiguous()
    name = _backend(backend, x, qt)
    if name == "cuda" and fused:
        out = format_of(qt).fused_kernel(
            xm, qt.packed, qt.scale_m, qt.scale_e, group=qt.group_size,
            bias=bias, act=act, act_bits=act_bits, act_exponent=act_exponent,
            block_k=block_k,
        )
    else:
        out = _unfused(xm, qt, name, act_bits, act_exponent, block_k)
        if bias is not None:
            out = out + bias.to(torch.float32)
        out = apply_act(out, act)
    return out.reshape(*lead, qt.n)


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------
def ep_divisible(e: int, c: int, mesh, ep_axis: str = "model", cap_axes: Tuple[str, ...] = ()) -> bool:
    """Can (E, C, d) expert buffers run expert-parallel on ``mesh``?  The
    reference's rule: E divisible by the expert axis, and C by every axis
    the reference shards it over."""
    from repro_torch.parallel.sharding import mesh_sizes

    sizes = mesh_sizes(mesh) if mesh is not None else {}
    if ep_axis not in sizes:
        return False
    ep = cap = sizes[ep_axis]
    for a in cap_axes:
        cap *= sizes[a]
    return ep > 1 and e % ep == 0 and c % cap == 0


def expert_ffn_ep(experts, x: torch.Tensor, *, mesh, ep_axis: str = "model", backend: str = "auto",
                  site_kwargs=None) -> torch.Tensor:
    """The MoE expert FFN under expert parallelism on one rank: ``experts``
    {"gate", "up", "down"} hold the rank's E / ep experts (their (E / ep,)
    exponents included), ``x`` the whole (E, C, d) capacity buffer, as every
    rank of the expert group holds it.  The rank runs its experts' slice
    through the expert ``qmatmul`` (one ``quantize_rows`` and one packed
    launch a site on ``cuda``; silu between gate and up, h in float32 into
    down, as the single-device composition), casts to ``x``'s dtype and
    all-gathers the (E, C, d) result over ``ep_axis``.  ``site_kwargs``:
    per-site ``act_bits`` / ``act_exponent`` from the plan."""
    from repro_torch.parallel.collectives import all_gather

    el = experts["gate"].experts
    i = mesh.index(ep_axis)
    xl = x[i * el:(i + 1) * el]
    sites = site_kwargs or {}

    def site(name, v):
        return qmatmul(v, experts[name], backend=backend, **sites.get(name, {}))

    h = apply_act(site("gate", xl), "silu")
    h = h * site("up", xl)
    return all_gather(site("down", h).to(x.dtype), mesh, ep_axis, 0)
