"""Compiled precision plans (counterpart of ``repro/quant/plan.py``).

A ``QuantPlan`` is a ``PrecisionPolicy`` resolved once against a parameter
tree, JSON-serializable in the reference's format (``to_json`` /
``from_json``, so an artifact's plan reads the same in both packages) and
calibration-aware: ``act_exponents`` maps a site path to its profiled
static 8-bit DFP activation exponent; sites without one use dynamic per-row
exponents.  ``QuantCtx`` is the per-forward view models consult: mode,
backend, plan or policy, and an optional calibration observer.  Site paths
are the reference's: per-layer block lists add no path component, exactly
as the reference's stacked layer axis does (``blocks/attn/wq``, ...).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, MutableMapping, Optional, Tuple

import torch

from repro_torch.core.policy import LayerPrecision, PrecisionPolicy
from repro_torch.core.quantizer import QTensor


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    site_paths: Tuple[str, ...] = ()
    site_precisions: Tuple[LayerPrecision, ...] = ()
    policy: Optional[PrecisionPolicy] = None
    mode: str = "ptq"
    backend: str = "auto"
    act_exponents: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "_table", dict(zip(self.site_paths, self.site_precisions)))
        object.__setattr__(self, "_exps", dict(self.act_exponents))

    def resolve(self, path: str) -> Optional[LayerPrecision]:
        prec = self._table.get(path)
        if prec is None and self.policy is not None:
            prec = self.policy.resolve(path)
        return prec

    def act_exponent(self, path: str) -> Optional[int]:
        e = self._exps.get(path)
        if e is None:
            return None
        prec = self.resolve(path)
        if prec is not None and not prec.static_act:
            return None
        return e

    def sites(self) -> Tuple[Tuple[str, LayerPrecision], ...]:
        return tuple(zip(self.site_paths, self.site_precisions))

    @property
    def calibrated(self) -> bool:
        return bool(self.act_exponents)

    def with_act_exponents(self, exps) -> "QuantPlan":
        pairs = tuple(sorted((str(k), int(v)) for k, v in exps.items()))
        return dataclasses.replace(self, act_exponents=pairs)

    def to_json(self) -> str:
        """The reference's plan JSON (version 1), field for field."""
        pol = None
        if self.policy is not None:
            pol = {
                "default": dataclasses.asdict(self.policy.default),
                "overrides": [[pat, dataclasses.asdict(p)] for pat, p in self.policy.overrides],
            }
        return json.dumps({
            "version": 1,
            "mode": self.mode,
            "backend": self.backend,
            "sites": [[path, dataclasses.asdict(prec)] for path, prec in zip(self.site_paths, self.site_precisions)],
            "policy": pol,
            "act_exponents": [[p, e] for p, e in self.act_exponents],
        })

    @classmethod
    def from_json(cls, blob: str) -> "QuantPlan":
        d = json.loads(blob)
        pol = None
        if d.get("policy") is not None:
            pol = PrecisionPolicy(
                default=LayerPrecision(**d["policy"]["default"]),
                overrides=tuple((pat, LayerPrecision(**p)) for pat, p in d["policy"]["overrides"]),
            )
        return cls(
            site_paths=tuple(path for path, _ in d["sites"]),
            site_precisions=tuple(LayerPrecision(**p) for _, p in d["sites"]),
            policy=pol,
            mode=d["mode"],
            backend=d["backend"],
            act_exponents=tuple((p, int(e)) for p, e in d["act_exponents"]),
        )


def is_projection_site(key: str, val) -> bool:
    """A quantizable projection weight: a 2-D ``w`` (float or QTensor)."""
    return key == "w" and (isinstance(val, QTensor) or (
        isinstance(val, torch.Tensor) and val.ndim >= 2))


def site_subpath(path: str, key: str) -> str:
    return f"{path}/{key}" if path else key


def iter_weight_sites(params) -> Tuple[Tuple[str, Any], ...]:
    """(path, w) for every dict node holding a projection ``w``; list
    entries (per-layer blocks) share their list's path."""
    sites = []

    def walk(node, path):
        if isinstance(node, (list, tuple)):
            for item in node:
                walk(item, path)
        elif isinstance(node, dict):
            for key, val in node.items():
                if is_projection_site(key, val):
                    sites.append((path, val))
                else:
                    walk(val, site_subpath(path, key))

    walk(params, "")
    return tuple(sites)


def compile_policy(policy: PrecisionPolicy, params, *, mode: str = "ptq",
                   backend: str = "auto") -> QuantPlan:
    """Resolve every projection site once.  Paths repeat once per layer;
    the plan keeps the first occurrence of each, like the reference's one
    entry per stacked site."""
    table = {}
    for path, _ in iter_weight_sites(params):
        table.setdefault(path, policy.resolve(path))
    return QuantPlan(tuple(table), tuple(table.values()), policy, mode, backend)


@dataclasses.dataclass(frozen=True)
class QuantCtx:
    """mode 'fp' | 'ptq'; backend 'auto' | 'cuda' | 'ref'.  ``observer``: a
    mutable {site: {"max_abs", "msq", "count"}} host store; when set,
    ``dense()`` records each site's input range (the calibration pass)."""

    mode: str = "fp"
    policy: Optional[PrecisionPolicy] = None
    backend: str = "auto"
    plan: Optional[QuantPlan] = None
    observer: Optional[MutableMapping] = dataclasses.field(default=None, compare=False)

    @staticmethod
    def fp() -> "QuantCtx":
        return QuantCtx("fp", None)

    @classmethod
    def from_config(cls, q) -> "QuantCtx":
        """The pre-compile ctx of a ``configs.base.QuantConfig``: a named
        format, else the ``w_bits`` ladder (2 ternary, 4 int4, else int8)."""
        if q.mode == "fp":
            return cls.fp()
        if q.fmt:
            pol = PrecisionPolicy.for_format(q.fmt, q.group_size, q.filter_size, q.refit_scale)
        elif q.w_bits == 2:
            pol = PrecisionPolicy.ternary(q.group_size, q.filter_size, q.refit_scale)
        elif q.w_bits == 4:
            pol = PrecisionPolicy.int4(q.group_size)
        else:
            pol = PrecisionPolicy.int8(q.group_size)
        return cls(q.mode, pol, q.backend)

    @classmethod
    def for_plan(cls, plan: QuantPlan) -> "QuantCtx":
        return cls(plan.mode, plan.policy, plan.backend, plan=plan)

    def with_observer(self, observer: MutableMapping) -> "QuantCtx":
        return dataclasses.replace(self, observer=observer)

    def resolve(self, path: str) -> Optional[LayerPrecision]:
        if self.plan is not None:
            return self.plan.resolve(path)
        if self.policy is not None:
            return self.policy.resolve(path)
        return None

    def act_exponent(self, path: str) -> Optional[int]:
        return None if self.plan is None else self.plan.act_exponent(path)
