"""Training loop (counterpart of ``repro/training/trainer.py``): the train
step with microbatch accumulation, checkpoints and resume, INQ schedule
events, and the paper's Sec. 4 retraining at low precision.

``make_train_step`` builds the step: ``torch.autograd`` through the
model's loss (QAT's straight-through estimators included), then
``optimizer.apply_updates`` in place.  ``Trainer`` adds the operational
shell: periodic step-atomic checkpoints (the plan and the ``QuantState``
ride along), resume from the newest intact one, and metrics that stay on
the device until a flush fetches a whole window in one transfer.

One device: ``mesh=`` and ``param_shardings=`` (the sharded trainer: the
``"train"`` rules, FSDP, ``opt_shardings``) wait for ROADMAP Queue A step
10.2 (A10.2) and raise.  No ``torch.compile``: the step runs eagerly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_map_named
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import optimizer as opt_lib


@dataclasses.dataclass
class TrainConfig:
    opt: opt_lib.OptConfig = opt_lib.OptConfig()
    microbatches: int = 1  # gradient accumulation factor
    accum_dtype: str = "float32"  # bf16 halves the accumulator's memory
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3


def _grad_leaves(tree) -> List[torch.Tensor]:
    """The leaves gradients are taken for: every floating tensor but the
    frozen ones (``inq_mask``), in the optimizer's order."""
    picked = tree_map_named(lambda name, t: t if opt_lib.trainable(t, name) else None, tree)
    return list(tree_leaves(picked))


def mark_trainable(params) -> None:
    """Record gradients for every leaf ``_grad_leaves`` picks."""
    for leaf in _grad_leaves(params):
        leaf.requires_grad_(True)


def _split(batch: Dict[str, torch.Tensor], mb: int) -> List[Dict[str, torch.Tensor]]:
    """``mb`` microbatches of ``batch``: (B, ...) leaves split on axis 0,
    M-RoPE's (3, B, S) positions on axis 1."""
    bsz = batch["tokens"].shape[0] if "tokens" in batch else next(iter(batch.values())).shape[0]
    per = bsz // mb

    def part(x, i):
        if x.shape[0] == bsz:
            return x[i * per:(i + 1) * per]
        if x.ndim >= 2 and x.shape[1] == bsz:
            return x[:, i * per:(i + 1) * per]
        raise ValueError(f"cannot microbatch leaf of shape {tuple(x.shape)}")

    if bsz % mb:
        raise ValueError(f"batch {bsz} does not split into {mb} microbatches")
    return [{k: part(v, i) for k, v in batch.items()} for i in range(mb)]


def make_train_step(loss_fn: Callable, tcfg: TrainConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    gradient of ``loss_fn(params, batch) -> scalar`` (accumulated over
    ``tcfg.microbatches`` in ``accum_dtype``, then divided), then one
    AdamW step in place.  ``params``' gradient leaves must record gradients
    (``mark_trainable``).  metrics {"loss", "lr", "grad_norm"} stay on the
    device."""

    def value_and_grad(params, batch) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
        leaves = _grad_leaves(params)
        loss = loss_fn(params, batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), {id(t): (torch.zeros_like(t) if g is None else g) for t, g in zip(leaves, gs)}

    def step(params, opt_state, batch):
        if tcfg.microbatches > 1:
            acc_dt = getattr(torch, tcfg.accum_dtype)
            loss, acc = None, None
            for mb in _split(batch, tcfg.microbatches):
                l, g = value_and_grad(params, mb)
                if acc is None:
                    loss, acc = torch.zeros((), dtype=torch.float32, device=l.device) + l, {
                        k: torch.zeros(v.shape, dtype=acc_dt, device=v.device) + v.to(acc_dt) for k, v in g.items()}
                else:
                    loss = loss + l
                    for k, v in g.items():
                        acc[k] += v.to(acc_dt)
                del g
            loss = loss / tcfg.microbatches
            grads_by_id = {k: v / tcfg.microbatches for k, v in acc.items()}
        else:
            loss, grads_by_id = value_and_grad(params, batch)
        # zeros for a leaf the loss does not reach (as jax.grad gives them), None for an untrained one
        grads = tree_map(lambda t: grads_by_id.get(id(t)), params)
        del grads_by_id
        params, opt_state, metrics = opt_lib.apply_updates(params, grads, opt_state, tcfg.opt)
        return params, opt_state, dict(metrics, loss=loss)

    return step


class Trainer:
    """Checkpoints, restart from failure, INQ events, deferred host syncs.

    The trainer owns the ``params`` it is given: it marks their leaves to
    record gradients and updates them in place (no copy: at qwen3-8b's
    widths a copy is 16 GB of the card).  A caller that needs its tree
    afterwards passes a clone."""

    def __init__(self, loss_fn: Callable, params: Any, tcfg: TrainConfig, mesh=None, param_shardings=None,
                 batch_shardings_fn: Optional[Callable] = None, plan=None, quant_state=None):
        if mesh is not None or param_shardings is not None or batch_shardings_fn is not None:
            raise NotImplementedError("a sharded trainer (mesh= / param_shardings=) waits for ROADMAP Queue A "
                                      "step 10.2 (A10.2); the port trains on one device")
        self.tcfg = tcfg
        self.plan = plan  # the compiled QuantPlan a QAT run trains under
        self.quant_state = quant_state  # QuantState: the TTQ / INQ schedule record
        self.params = params
        mark_trainable(self.params)
        self.opt_state = opt_lib.init_state(self.params, tcfg.opt)
        self.step_count = 0
        self.sync_count = 0  # host syncs issued by train() (metrics flushes)
        self._step = make_train_step(loss_fn, tcfg)

    def maybe_restore(self) -> int:
        """Resume from the newest intact checkpoint: params, optimizer state,
        plan (``self.plan``: rebind the loss to it with ``rebind_loss``) and
        ``QuantState``.  Returns the step resumed at (0 without one)."""
        if not self.tcfg.ckpt_dir:
            return 0
        step, manifest = ckpt_lib.latest_intact(self.tcfg.ckpt_dir)
        if step is None:
            return self.step_count
        device = self.opt_state["step"].device
        tree = ckpt_lib.restore(self.tcfg.ckpt_dir, step, {"params": self.params, "opt": self.opt_state},
                                manifest=manifest, device=device)
        self.params, self.opt_state = tree["params"], tree["opt"]
        mark_trainable(self.params)
        self.step_count = step
        d = ckpt_lib.step_dir(self.tcfg.ckpt_dir, step)
        restored_plan = ckpt_lib.load_plan(d, manifest=manifest)
        if restored_plan is not None:
            self.plan = restored_plan
        qs_meta = ckpt_lib.load_quant_state(d, manifest=manifest)
        if qs_meta is not None:
            from repro_torch.quant.state import QuantState

            self.quant_state = QuantState.from_meta(qs_meta)
        return self.step_count

    def rebind_loss(self, loss_fn: Callable) -> None:
        """Rebuild the step around a new loss closure (one bound to the plan
        ``maybe_restore`` recovered)."""
        self._step = make_train_step(loss_fn, self.tcfg)

    def _maybe_advance_quant(self, i: int) -> None:
        """Fire the INQ events due at step ``i`` (before the step runs): grow
        each site's frozen partition, snap it onto the current learned grid,
        advance the resume cursor.  TTQ has no schedule."""
        qs = self.quant_state
        if qs is None or qs.method != "inq" or self.plan is None:
            return
        from repro_torch.quant import state as state_lib

        events = state_lib.inq_event_steps(qs.total_steps, qs.fractions)
        pos = qs.pos
        while pos < len(events) and i >= events[pos]:
            with torch.no_grad():
                self.params = state_lib.advance_inq(self.params, self.plan, qs.fractions[pos])
            mark_trainable(self.params)
            pos += 1
        if pos != qs.pos:
            self.quant_state = dataclasses.replace(qs, pos=pos)

    def _save_ckpt(self, step: int) -> None:
        ckpt_lib.save(self.tcfg.ckpt_dir, step, {"params": self.params, "opt": self.opt_state}, plan=self.plan,
                      quant_state=self.quant_state.to_meta() if self.quant_state is not None else None)
        ckpt_lib.retain(self.tcfg.ckpt_dir, self.tcfg.keep)

    def train(self, batch_fn: Callable[[int], Any], num_steps: int) -> Dict[str, list]:
        """``num_steps`` steps from ``step_count`` on ``batch_fn(i)``; a
        checkpoint every ``ckpt_every`` steps.  The loop never reads a
        metric back per step: the window's losses come over in one
        transfer at each checkpoint and at the end (``sync_count``)."""
        history: Dict[str, list] = {"loss": [], "step": [], "wall": []}
        t0 = time.time()
        pending: list = []  # (step, on-device metrics) awaiting one sync

        def flush():
            if not pending:
                return
            losses = torch.stack([m["loss"] for _, m in pending]).tolist()  # the one host transfer
            self.sync_count += 1
            wall = time.time() - t0
            for (idx, _), loss in zip(pending, losses):
                history["loss"].append(float(loss))
                history["step"].append(idx)
                history["wall"].append(wall)
            pending.clear()

        for i in range(self.step_count, self.step_count + num_steps):
            self._maybe_advance_quant(i)
            self.params, self.opt_state, metrics = self._step(self.params, self.opt_state, batch_fn(i))
            pending.append((i, metrics))
            if self.tcfg.ckpt_dir and (i + 1) % self.tcfg.ckpt_every == 0:
                flush()
                self._save_ckpt(i + 1)
        flush()
        self.step_count += num_steps
        return history
