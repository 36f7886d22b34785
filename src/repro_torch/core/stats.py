"""Operation accounting: reproduces the paper's Sec. 3.3 performance model
(own copy of ``repro/core/stats.py``, pure Python).

With cluster size N, each reduction segment of N*K^2 ternary accumulations
costs exactly one 8-bit scale multiplication.  The fraction of baseline
multiplications replaced by accumulations in one conv is therefore

    replaced(conv) = 1 - 1 / (N * K^2)

and for a network it is the MAC-weighted average.  We provide
  * the exact ResNet-101 inventory (to check the paper's ~85% @ N=4 and
    ~98% @ N=64 claims),
  * the paper's own "50% of convs are 3x3" approximation, and
  * the transformer-GEMM analogue (K^2 == 1, segment = group_size), used by
    the per-arch benchmarks.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    cin: int
    cout: int
    k: int
    hw: int  # output spatial extent (H == W)

    @property
    def macs(self) -> int:
        return self.hw * self.hw * self.cout * self.cin * self.k * self.k


@dataclasses.dataclass(frozen=True)
class GemmSpec:
    """One projection GEMM: reduction K, output N, ``calls`` per token."""

    name: str
    k: int
    n: int
    calls: float = 1.0
    weight_quantized: bool = True

    @property
    def macs_per_token(self) -> float:
        return self.k * self.n * self.calls


def conv_replaced_fraction(spec: ConvSpec, cluster: int) -> float:
    return 1.0 - 1.0 / (cluster * spec.k * spec.k)


def network_replaced_fraction(specs: Sequence[ConvSpec], cluster: int) -> float:
    total = sum(s.macs for s in specs)
    repl = sum(s.macs * conv_replaced_fraction(s, cluster) for s in specs)
    return repl / total


def paper_approximation(cluster: int) -> float:
    """Sec. 3.3: 'roughly 50% of the convolutions are 3x3 and the rest 1x1'."""
    return 0.5 * (1 - 1 / (cluster * 9)) + 0.5 * (1 - 1 / cluster)


def resnet101_specs(image: int = 224) -> List[ConvSpec]:
    """Exact conv inventory of ResNet-101 (bottleneck v1, ImageNet)."""
    specs = [ConvSpec(3, 64, 7, image // 2)]  # conv1 (pinned to 8-bit by policy)
    stage_cfg = [  # (blocks, width, out, spatial)
        (3, 64, 256, image // 4),
        (4, 128, 512, image // 8),
        (23, 256, 1024, image // 16),
        (3, 512, 2048, image // 32),
    ]
    cin = 64
    for blocks, width, cout, hw in stage_cfg:
        for b in range(blocks):
            specs.append(ConvSpec(cin if b == 0 else cout, width, 1, hw))
            specs.append(ConvSpec(width, width, 3, hw))
            specs.append(ConvSpec(width, cout, 1, hw))
            if b == 0:  # projection shortcut
                specs.append(ConvSpec(cin, cout, 1, hw))
        cin = cout
    return specs


def gemm_replaced_fraction(group_size: int) -> float:
    """Transformer projection: K^2==1, segment length == group_size."""
    return 1.0 - 1.0 / group_size


def network_gemm_stats(
    gemms: Sequence[GemmSpec], group_size: int
) -> Tuple[float, float, float]:
    """Returns (total MACs/token, replaced fraction over weight GEMMs,
    replaced fraction over ALL MACs incl. attention int8 GEMMs)."""
    total = sum(g.macs_per_token for g in gemms)
    wq = [g for g in gemms if g.weight_quantized]
    wq_total = sum(g.macs_per_token for g in wq)
    repl = wq_total * gemm_replaced_fraction(group_size)
    return total, (repl / wq_total if wq_total else 0.0), repl / total


def weight_bytes(
    gemms: Sequence[GemmSpec], w_bits: int, group_size: int, scale_bits: int = 8
) -> float:
    """HBM bytes to stream all quantized weights once (decode-phase cost):
    packed mantissas + per-(group, out) scale mantissas + exponents."""
    total = 0.0
    for g in gemms:
        if not g.weight_quantized:
            continue
        mant = g.k * g.n * w_bits / 8.0
        scales = (g.k / group_size) * g.n * scale_bits / 8.0
        total += (mant + scales) * max(g.calls, 1.0 if g.calls >= 1 else g.calls)
    return total
