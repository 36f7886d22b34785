"""Training launcher of the port (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
        --device cpu --steps 20 --quant qat --w-bits 2 --group-size 16
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base --smoke \\
        --device cpu --quant inq --steps 12 --ckpt-dir build/ck [--resume] \\
        [--save-artifact build/art]

Quantization (the paper's Sec. 4 retraining at low precision):

  --quant fp    full precision
  --quant qat   the policy's weight format through its straight-through
                estimator, 8-bit activations
  --quant ttq   Trained Ternary Quantization: per-cluster Wp / Wn scales
                train by gradient (forces --fmt ttq, 2 bits)
  --quant inq   Incremental Network Quantization on a learned grid: the
                smallest-magnitude fraction of each site freezes onto the
                grid at each of --inq-fractions of the run; the rest and
                the grid itself keep training

``--opt-bits 8`` keeps AdamW's moments as DFP-8 mantissas (per-row
exponents, the second moment in the sqrt domain).  ``--ckpt-dir`` writes a
step-atomic checkpoint every max(5, steps / 4) steps, the plan and the
TTQ / INQ schedule record with it; ``--resume`` restores the newest intact
one and finishes the planned run: it trains ``--steps`` less the restored
step (the reference's launcher trains ``--steps`` more), so a relaunch of
the same command line after a crash ends where the uninterrupted run ends,
the same learning-rate schedule and INQ events included.
``--save-artifact DIR`` quantizes on the learned grid (``quantize_and_plan``
consumes ``ttq_scales`` / ``inq_scales``) and writes the packed artifact
that ``repro_torch.launch.serve --artifact`` and the reference's launcher
cold-start.

Weights come from a seeded ``torch.Generator`` on ``--device`` (the card
unless ``--device cpu``), batches from ``training/data.py`` (seed 0).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import configs
from repro_torch.configs.base import QuantConfig
from repro_torch.models import build_model, quantize_and_plan, save_servable
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.trainer import TrainConfig, Trainer

SEED = 0


@dataclasses.dataclass
class TrainRun:
    api: Any  # the plan-bound ModelApi the run trained under
    trainer: Trainer
    history: Dict[str, list]
    start: int  # the step the run resumed at (0 for a fresh run)
    artifact: Optional[str] = None  # the saved artifact's step directory


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train", description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--quant", default="fp", choices=["fp", "qat", "ttq", "inq"])
    ap.add_argument("--w-bits", type=int, default=2)
    ap.add_argument("--group-size", type=int, default=16)
    ap.add_argument("--fmt", default=None, help="named weight format (nf4, mx, ttq, ...)")
    ap.add_argument("--inq-fractions", default="0.5,0.75,0.875,1.0",
                    help="INQ accumulative freeze fractions (comma-separated)")
    ap.add_argument("--save-artifact", default=None, metavar="DIR",
                    help="after training, quantize on the learned grid and write a serving artifact")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--opt-bits", type=int, default=32, choices=[8, 32])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain PyTorch versions)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    method = args.quant if args.quant in ("ttq", "inq") else None
    fmt, w_bits = args.fmt, args.w_bits
    if args.quant == "ttq":
        fmt, w_bits = "ttq", 2  # ttq is a ternary-code format by definition
    mode = "qat" if method else args.quant
    qc = QuantConfig(w_bits=w_bits, group_size=args.group_size, mode=mode, fmt=fmt)
    cfg = (configs.get_smoke if args.smoke else configs.get_config)(args.arch, qc)
    api = build_model(cfg, device=device)
    params = api.init(torch.Generator(device=device).manual_seed(SEED))
    n_params = sum(t.numel() for t in tree_leaves(params) if isinstance(t, torch.Tensor))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M quant={args.quant} w_bits={w_bits} N={args.group_size}"
          + (f" fmt={fmt}" if fmt else "") + f" device={device}")

    dcfg = DataConfig(batch=args.batch, seq=args.seq)
    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10), decay_steps=args.steps,
                      state_bits=args.opt_bits),
        microbatches=args.microbatches, ckpt_dir=args.ckpt_dir, ckpt_every=max(5, args.steps // 4),
    )
    # QAT compiles the policy once against the params; the plan rides in every checkpoint
    api = api.compiled(params)
    quant_state = None
    if method is not None:
        from repro_torch.quant.state import init_quant_state

        fractions = tuple(float(f) for f in args.inq_fractions.split(",") if f)
        params, quant_state = init_quant_state(params, api.ctx.plan, method, fractions=fractions,
                                               total_steps=args.steps)
    tr = Trainer(api.train_loss, params, tcfg, plan=api.ctx.plan, quant_state=quant_state)
    del params
    start = 0
    if args.resume and args.ckpt_dir:
        start = tr.maybe_restore()
        restored = tr.plan
        if restored is not None and (api.ctx.plan is None or restored.to_json() != api.ctx.plan.to_json()):
            # train under the checkpointed precision table, not the freshly compiled one
            api = api.with_plan(restored)
            tr.rebind_loss(api.train_loss)
        print(f"resumed at step {start}")
    hist = tr.train(lambda i: make_batch(cfg, dcfg, i, device=device), max(args.steps - start, 0))
    n = len(hist["loss"])
    for i in range(0, n, max(1, n // 10)):
        print(f"step {hist['step'][i]:5d}  loss {hist['loss'][i]:.4f}")
    if n:
        print(f"final loss {hist['loss'][-1]:.4f}")
    artifact = None
    if args.save_artifact:
        # the state-carrying tree threads the LEARNED scales into the artifact: deployment never re-fits the grid
        with torch.no_grad():
            qparams, plan, _ = quantize_and_plan(api, tree_map(_detached, tr.params))
        artifact = save_servable(args.save_artifact, api, qparams, plan)
        print(f"saved serving artifact at {artifact}")
    return TrainRun(api, tr, hist, start, artifact)


def _detached(leaf):
    return leaf.detach() if isinstance(leaf, torch.Tensor) else leaf


if __name__ == "__main__":
    main()
