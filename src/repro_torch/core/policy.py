"""Per-layer precision policy (own copy of ``repro/core/policy.py``).

A default precision plus ordered regex overrides resolved against a site's
parameter path.  The paper's override set is copied verbatim, including
``(^|/)blocks/0(/|$)``: site paths carry no layer index (the reference
stacks blocks on a leading axis, the port keeps per-layer modules but the
same paths), so that override never matches and every block is ternary in
both packages.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

FULL_PRECISION = 32


@dataclasses.dataclass(frozen=True)
class LayerPrecision:
    w_bits: int = 2
    act_bits: int = 8
    group_size: int = 64
    filter_size: int = 1
    refit_scale: bool = False
    static_act: bool = True
    fmt: Optional[str] = None
    fused: bool = True

    @property
    def quantized(self) -> bool:
        return self.w_bits < 16


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    default: LayerPrecision
    overrides: Tuple[Tuple[str, LayerPrecision], ...] = ()

    def resolve(self, path: str) -> LayerPrecision:
        for pattern, prec in self.overrides:
            if re.search(pattern, path):
                return prec
        return self.default

    @staticmethod
    def paper_overrides(group_size: int) -> Tuple[Tuple[str, LayerPrecision], ...]:
        eight = LayerPrecision(w_bits=8, act_bits=8, group_size=group_size)
        fp = LayerPrecision(w_bits=FULL_PRECISION, act_bits=8)
        return (
            (r"(^|/)embed", eight),          # C1 analogue: input projection
            (r"(^|/)blocks/0(/|$)", eight),  # never matches: paths have no index
            (r"(^|/)lm_head", eight),        # FC analogue
            (r"router|gate_proj_router", eight),
            (r"norm|scale|bias|conv1d|ssm/(A|D|dt)", fp),
            (r"frontend", eight),
        )

    @classmethod
    def ternary(cls, group_size: int = 64, filter_size: int = 1,
                refit_scale: bool = False) -> "PrecisionPolicy":
        return cls(
            default=LayerPrecision(2, 8, group_size, filter_size, refit_scale),
            overrides=cls.paper_overrides(group_size),
        )

    @classmethod
    def int4(cls, group_size: int = 64) -> "PrecisionPolicy":
        return cls(
            default=LayerPrecision(4, 8, group_size),
            overrides=cls.paper_overrides(group_size),
        )

    @classmethod
    def int8(cls, group_size: int = 64) -> "PrecisionPolicy":
        return cls(
            default=LayerPrecision(8, 8, group_size),
            overrides=cls.paper_overrides(group_size),
        )

    @classmethod
    def for_format(cls, fmt: str, group_size: int = 64, filter_size: int = 1,
                   refit_scale: bool = False) -> "PrecisionPolicy":
        """Default sites on the named registered format, at its own width;
        a format with a fixed block (mx: 32) pins ``group_size`` to it.  The
        paper's 8-bit override sites stay on the built-in int8 format."""
        from repro_torch.quant.formats import get_format  # lazy: formats imports the kernels

        f = get_format(fmt)
        return cls(
            default=LayerPrecision(f.bits, 8, f.block_size or group_size, filter_size, refit_scale, fmt=fmt),
            overrides=cls.paper_overrides(group_size),
        )
