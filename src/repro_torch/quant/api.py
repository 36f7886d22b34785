"""Calibration-aware PTQ entry points and packed artifacts over compiled
plans (counterpart of ``repro/quant/api.py``).

``quantize_model(params, policy, calib_batches=..., forward=...)`` goes
from float params to a servable quantized model:

  1. compile the policy against the tree -> ``QuantPlan``;
  2. replace each projection ``w`` with a QTensor per the plan
     (``quantize_params``); the embedding table (a gather, not a GEMM) is
     snapped in place to the per-row 8-bit DFP grid;
  3. with calibration batches, run an observing full-precision forward:
     every ``dense()`` site records its input's max|x| and mean square
     (``observe_site``), and the finalized shared exponents ride in the
     plan -- the paper's profiled static DFP activations; sites without a
     record keep dynamic per-row exponents.

``quantize_leaf`` is the one-leaf step, so a caller can quantize a model
one site at a time without ever holding the whole float tree.

``save_artifact`` / ``load_artifact`` make the quantized model an on-disk
artifact in the reference's format (``training/checkpoint.py``): packed
QTensors, sha256 per payload, the plan with its calibrated exponents --
quantize once, cold-start many times with no float weights.  With
``mesh=`` the payloads write as shard files under the serving rules
(``parallel.sharding.qtensor_shardings``), and a read gives one rank its
own slice of every payload.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.core import dfp
from repro_torch.core.calibration import fake_quantize_act
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.quantizer import TERNARY_PER_WORD
from repro_torch.quant.formats import quantize_weights
from repro_torch.quant.plan import QuantCtx, QuantPlan, compile_policy, is_projection_site, site_subpath
from repro_torch.training import checkpoint as ckpt

def _record(store, site: str, max_abs: float, msq: float) -> None:
    """Accumulate one batch's stats into a {site: entry} mapping."""
    e = store.get(site)
    if e is None:
        store[site] = {"max_abs": max_abs, "msq": msq, "count": 1.0}
    else:
        e["max_abs"] = max(e["max_abs"], max_abs)
        e["msq"] += msq
        e["count"] += 1.0


class Observer(dict):
    """Host-side activation-range store: {site: {"max_abs", "msq", "count"}}
    of Python floats, filled by ``observe_site`` in call order (one record a
    layer a batch for the blocks' shared sites); ``exponents()`` finalizes
    ``max_abs`` into shared DFP exponents."""

    def record(self, site: str, max_abs: float, msq: float) -> None:
        _record(self, site, max_abs, msq)

    def exponents(self, bits: int = 8, bits_for: Optional[Callable[[str], int]] = None) -> Dict[str, int]:
        """``bits_for(site)`` overrides the mantissa width per site (it must
        be the act_bits the site quantizes with)."""
        return {
            site: int(dfp.choose_exponent(torch.tensor(e["max_abs"], dtype=torch.float32),
                                          bits_for(site) if bits_for is not None else bits))
            for site, e in self.items()
        }


def observe_site(store, site: str, x: torch.Tensor) -> None:
    """Record one activation batch at ``site``: max|x| and mean(x^2) as
    float32 reductions, read to the host."""
    xf = x.to(torch.float32)
    max_abs, msq = torch.stack([torch.max(torch.abs(xf)), torch.mean(torch.square(xf))]).tolist()
    _record(store, site, max_abs, msq)


def _quantizable(prec, kdim: int) -> bool:
    return (
        prec is not None
        and prec.quantized
        and kdim % prec.group_size == 0
        and kdim % TERNARY_PER_WORD == 0
    )


def quantize_leaf(path: str, key: str, val, plan: QuantPlan, scales=None):
    """The quantized form of one parameter leaf at ``path/key``; ``scales``
    is a site's trained grid (quantization state), deployed as it is."""
    if is_projection_site(key, val) and isinstance(val, torch.Tensor):
        prec = plan.resolve(path)
        if _quantizable(prec, val.shape[-2]):
            # quantize_weights casts to float32 itself, an expert at a time: no float32 copy of a whole stack
            return quantize_weights(
                val, prec.w_bits, prec.group_size, prec.filter_size, prec.refit_scale, fmt=prec.fmt, scales=scales,
            )
        return val
    if key == "table" and isinstance(val, torch.Tensor):
        return fake_quantize_act(val.to(torch.float32), 8, per_row=True).to(val.dtype)
    return val


def _trained_scales(node, prec):
    """A site's learned grid: ttq's Wp / Wn where the site is ttq, else the
    magnitude of INQ's grid (training may move a scale across zero; the
    STE folds it the same way), else None (a fit from ``w``)."""
    if prec is not None and prec.fmt == "ttq" and "ttq_scales" in node:
        return node["ttq_scales"]
    sc = node.get("inq_scales")
    return None if sc is None else torch.abs(sc)


def quantize_params(params, plan: QuantPlan):
    """Walk the tree; projection ``w`` leaves become QTensors (an (E, K, N)
    expert stack one QTensor with a leading E axis).  A site carrying
    quantization state (``quant/state.py``) is quantized on its learned
    grid, and the state leaves are consumed: the result holds only
    servable parameters."""
    from repro_torch.quant.state import STATE_KEYS  # lazy: state imports this module

    def walk(node, path):
        if isinstance(node, list):
            return [walk(item, path) for item in node]
        if isinstance(node, dict):
            out = {}
            for key, val in node.items():
                if key in STATE_KEYS:
                    continue
                if isinstance(val, (dict, list)):
                    out[key] = walk(val, site_subpath(path, key))
                else:
                    scales = _trained_scales(node, plan.resolve(path)) if is_projection_site(key, val) else None
                    out[key] = quantize_leaf(path, key, val, plan, scales)
            return out
        return node

    return walk(params, "")


def quantize_model(params, policy: PrecisionPolicy, *, mode: str = "ptq", backend: str = "auto",
                   calib_batches: Optional[Iterable[Any]] = None,
                   forward: Optional[Callable[[Any, Any, QuantCtx], Any]] = None,
                   act_bits: int = 8) -> Tuple[Any, QuantPlan]:
    """Float params -> (QTensor params, compiled plan).  With
    ``calib_batches`` and ``forward(params, batch, ctx)``, a full-precision
    observing pass profiles every projection site and the plan carries the
    static exponents."""
    if calib_batches is not None and forward is None:
        raise ValueError("calib_batches requires a forward(params, batch, ctx)")
    plan = compile_policy(policy, params, mode=mode, backend=backend)
    qparams = quantize_params(params, plan)
    if calib_batches is not None:
        obs = Observer()
        ctx = QuantCtx(mode="fp", policy=policy, observer=obs)
        for batch in calib_batches:
            forward(params, batch, ctx)

        def bits_for(site):
            prec = plan.resolve(site)
            return prec.act_bits if prec is not None else act_bits  # what dense() quantizes the site with

        plan = plan.with_act_exponents(obs.exponents(act_bits, bits_for))
    return qparams, plan


# ---------------------------------------------------------------------------
# Quantized artifacts: packed QTensor tree + plan as the unit of deployment.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Artifact:
    """One loaded artifact: the manifest's tree (layers stacked, QTensors
    packed), the plan, the producer's metadata, the step and its directory."""

    params: Any
    plan: Optional[QuantPlan]
    extra: Dict[str, Any]
    step: int
    path: str
    shardings: Any = None  # the spec tree of a read on a mesh (over the stacked tree)


def save_artifact(artifact_dir: str, params: Any, plan: Optional[QuantPlan], *,
                  extra: Optional[Dict[str, Any]] = None, step: int = 0, mesh: Any = None) -> str:
    """Persist a quantized model as a self-contained artifact (packed
    payloads, sha256 each, step-atomic publish, the plan in its
    ``quant_plan`` section).  ``extra`` is free producer metadata; pass the
    serialized ArchConfig under ``"arch_config"`` so serving can cold-start
    from the directory alone.  With ``mesh`` (any mesh the rules take, a
    plain axis -> size dict included) every payload the serving rules split
    is written as its shard files, the reference's layout byte for byte."""
    shardings = None
    if mesh is not None:
        from repro_torch.parallel.sharding import qtensor_shardings

        shardings = qtensor_shardings(ckpt.stacked_shapes(params), mesh, plan)
    meta = dict(extra or {})
    meta.setdefault("kind", "quant_artifact")
    return ckpt.save(artifact_dir, step, params, extra=meta, plan=plan, shardings=shardings, mesh=mesh)


def load_artifact(artifact_dir: str, *, mesh: Any = None, device=None) -> Artifact:
    """The newest intact artifact in ``artifact_dir``, rebuilt from its
    verified manifest alone onto ``device`` (the card unless ``"cpu"``):
    corrupt steps are skipped for older intact ones; none intact raises
    IOError.  With ``mesh`` (a ``parallel.collectives.Mesh``, live or
    ``Mesh.local``) the serving rules run on the manifest's abstract tree
    and every leaf is that rank's slice: its own shard files when the
    artifact was written for the same layout, the joined payload sliced
    otherwise."""
    # verify once (every payload hashed), then thread the manifest through
    step, manifest = ckpt.latest_intact(artifact_dir)
    if step is None:
        raise IOError(f"no intact quantized artifact under {artifact_dir!r}")
    d = ckpt.step_dir(artifact_dir, step)
    plan = ckpt.load_plan(d, manifest=manifest)
    shardings = None
    if mesh is not None:
        from repro_torch.parallel.sharding import qtensor_shardings

        shardings = qtensor_shardings(ckpt.tree_shapes(manifest), mesh, plan)
    return Artifact(params=ckpt.restore_tree(d, manifest=manifest, device=device, shardings=shardings, mesh=mesh),
                    plan=plan, extra=manifest.get("extra", {}), step=step, path=d, shardings=shardings)
