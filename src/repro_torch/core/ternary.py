"""Algorithms 1 & 2 of the paper: hierarchical cluster ternarization
(counterpart of ``repro/core/ternary.py``), vectorized over clusters.

Both algorithms are exact closed forms after one sort: with A(I) the sum of
|W| over support I, E(alpha, I) = sum W^2 - 2 alpha A(I) + |I| alpha^2, so
the best support size is an argmin over prefix sums.  The reference runs
the same arithmetic in float32; the port keeps float32 and the reference's
operation order.  ``sqrt`` goes through float64 so it is correctly rounded
like XLA's (torch's float32 CPU sqrt is not), which keeps every candidate
threshold -- and so every argmin -- identical to the reference's.
"""
from __future__ import annotations

from typing import Tuple

import torch


_SCAN_BLOCK = 16


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis in the reference's order:
    left to right inside blocks of 16, then each block's carry (the scanned
    totals of the blocks before it) added to the block's own sums."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = torch.empty_like(x)
        acc = x[..., 0]
        out[..., 0] = acc
        for i in range(1, n):
            acc = acc + x[..., i]
            out[..., i] = acc
        return out
    nb = -(-n // _SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    pref = cumsum(xp.reshape(*x.shape[:-1], nb, _SCAN_BLOCK))
    carry = cumsum(pref[..., -1])  # (..., nb) inclusive block totals
    out = pref.clone()
    out[..., 1:, :] = carry[..., :-1, None] + pref[..., 1:, :]
    return out.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n]


def _sorted_desc_stats(w_abs: torch.Tensor):
    a = torch.flip(torch.sort(w_abs, dim=-1).values, dims=(-1,))
    return a, cumsum(a), cumsum(a * a)


def filter_threshold(w: torch.Tensor) -> torch.Tensor:
    """Algorithm 2: optimal RMS threshold of each filter (last axis = F)."""
    a, A, S = _sorted_desc_stats(torch.abs(w))
    t = torch.arange(1, a.shape[-1] + 1, dtype=torch.float32, device=w.device)
    total_sq = S[..., -1:]
    alpha_t = _sqrt(torch.clamp(S / t, min=0.0))
    err_t = total_sq - 2.0 * alpha_t * A + t * alpha_t**2
    best = torch.argmin(err_t, dim=-1, keepdim=True)
    return torch.gather(alpha_t, -1, best)[..., 0]


def cluster_ternarize(
    clusters: torch.Tensor, refit_scale: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 1 on a batch of clusters shaped (C, N, F).

    Returns (codes int8 in {-1,0,1} shaped like ``clusters``, alpha f32 (C,)).
    """
    c, n, f = clusters.shape
    dev = clusters.device
    if f == 1:  # Algorithm 2 on a single element is exactly alpha = |w|
        alphas = torch.abs(clusters[..., 0])
    else:
        alphas = filter_threshold(clusters)  # (C, N)
    b = torch.flip(torch.sort(alphas, dim=-1).values, dims=(-1,))
    t = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    cand = _sqrt(torch.clamp(cumsum(b * b) / t, min=0.0))  # (C, N)

    asc = torch.sort(torch.abs(clusters).reshape(c, n * f), dim=-1).values
    pad = torch.zeros((c, 1), dtype=torch.float32, device=dev)
    p_abs = torch.cat([pad, cumsum(asc)], dim=-1)
    p_sq = torch.cat([pad, cumsum(asc * asc)], dim=-1)

    # support {|w| > cand}: elements <= cand are the first idx of asc
    idx = torch.searchsorted(asc, cand, right=True)
    cnt = (n * f - idx).to(torch.float32)
    a_sup = p_abs[:, -1:] - torch.gather(p_abs, 1, idx)
    err = p_sq[:, -1:] - 2.0 * cand * a_sup + cnt * cand**2
    best = torch.argmin(err, dim=-1, keepdim=True)
    alpha = torch.gather(cand, 1, best)[:, 0]

    mask = torch.abs(clusters) > alpha[:, None, None]
    if refit_scale:
        n_sup = torch.clamp(torch.gather(cnt, 1, best)[:, 0], min=1.0)
        alpha = torch.where(
            torch.gather(cnt, 1, best)[:, 0] > 0,
            torch.gather(a_sup, 1, best)[:, 0] / n_sup, alpha,
        )
    codes = torch.where(mask, torch.sign(clusters), torch.zeros_like(clusters))
    return codes.to(torch.int8), alpha.to(torch.float32)


def ternarize_blocks(
    blocks: torch.Tensor, n_filters: int, filter_size: int, refit_scale: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """blocks (n_clusters, N*F) -> (codes int8 same shape, alpha (n_clusters,))."""
    shaped = blocks.reshape(blocks.shape[0], n_filters, filter_size).to(torch.float32)
    codes, alpha = cluster_ternarize(shaped, refit_scale)
    return codes.reshape(blocks.shape), alpha


def ternarize_matrix(
    w: torch.Tensor, group_size: int, filter_size: int, refit_scale: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ternarize a (K, Nout) projection with per-(k-group, out) scales.

    Returns codes int8 (K, Nout) in {-1, 0, 1} and alpha f32 (K/group, Nout).
    """
    k, nout = w.shape
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    if group_size % filter_size:
        raise ValueError(f"group={group_size} not divisible by filter={filter_size}")
    n_groups = k // group_size
    blocks = w.reshape(n_groups, group_size, nout).permute(0, 2, 1)
    codes, alpha = ternarize_blocks(
        blocks.reshape(n_groups * nout, group_size),
        group_size // filter_size, filter_size, refit_scale,
    )
    codes = codes.reshape(n_groups, nout, group_size).permute(0, 2, 1)
    return codes.reshape(k, nout), alpha.reshape(n_groups, nout)
