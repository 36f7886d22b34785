"""Serving launcher of the port (counterpart of ``repro/launch/serve.py``):
boot a quantized model, then serve seeded requests through the staged
engine (default) or the lockstep oracle, with the fault-tolerance knobs.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --smoke \\
        --device cpu --bits 2 --group-size 16 --requests 8 [--engine lockstep] \\
        [--calibrate 2] [--save-artifact DIR] [--plan-json p.json]
    PYTHONPATH=src python -m repro_torch.launch.serve --artifact DIR --device cpu --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --bits 2 \\
        --group-size 64 --kv-fmt kv_int8 --flash-decode --flash-prefill \\
        --max-len 1024 --prefill-chunk 256          # full width, on the card

``--arch`` takes every registered config: the dense and MoE families, the
VLM qwen2-vl-72b (text-only prompts, M-RoPE), the SSM falcon-mamba-7b and
the hybrid zamba2-7b (the staged engine prefills the last two a token at a
time).

Two boot modes, as the reference's:

  * quantize on boot (``--arch``): the model is built on ``--device`` (the
    card unless ``--device cpu``) from a seeded ``torch.Generator``.  With
    ``--calibrate N`` the float weights are made whole, N batches of 2 x 16
    tokens (each from its own seeded generator, 100 + i -- the port's own
    draws, not the reference's ``jax.random`` ones) profile every site's
    static activation exponent, and the float tree is dropped; without,
    each site is quantized as it is made (``init_quantized``), so a
    full-width model never holds its float weights.  ``--save-artifact
    DIR`` then writes the packed artifact in the reference's format.
  * cold start (``--artifact DIR``): packed QTensors, the plan (calibrated
    exponents included) and the ArchConfig come from the newest intact step
    of an artifact written by either package; no float weights, no
    calibration.  ``--backend`` replaces the plan's backend (needed for an
    artifact of the reference's launcher, whose default is ``xla``).

``--kv-fmt`` and the flash flags are serving-time choices over either boot.
The report is the reference's: compression and plan (or the cold-start
banner), the kv banner, finished requests and tokens/s, the fault-tolerance
and watchdog lines, queue-wait / TTFT / TPOT percentiles and the first four
outputs.  With the same arguments the staged and lockstep engines print the
same greedy tokens.  ``--chaos "rate=0.05,kinds=nan_logits|stall_tick,seed=0"``
injects seeded faults (``serving/faults.py``), ``--retries`` budgets
quarantine retries, ``--deadline-ms / --max-queue / --ttft-slo-ms`` gate
admission and ``--tpot-slo-ms`` arms overload degradation.

``--mesh SPEC`` (``dp=2,ep=2``; aliases dp -> data, ep / tp -> model)
serves the dense and MoE families across ranks, one launcher process a
rank under ``torch.distributed.run``; the mesh size must equal
``WORLD_SIZE``.  Each rank runs on ``cuda:LOCAL_RANK`` (NCCL) unless
``--device`` says otherwise (``--device cpu``: gloo), holds only its shards
(read from its own shard files with ``--artifact``; ``--save-artifact``
writes shard files, from rank 0) and runs the same host loop; rank 0
prints the report and the tokens:

    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 4 \
        -m repro_torch.launch.serve --artifact DIR --device cpu --mesh dp=2,ep=2

``--compile-cache`` is accepted but not offered: it exits naming why.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.base import QuantConfig
from repro_torch.core.quantizer import QTensor
from repro_torch.launch.mesh import init_distributed, mesh_size, parse_mesh_spec
from repro_torch.models import (
    build_model, init_quantized, load_servable, make_smoke_batch, quantize_and_plan, save_servable,
)
from repro_torch.models.kv_cache import resolve_kv_fmt
from repro_torch.serving import (
    AdmissionConfig, FaultInjector, HealthConfig, Request, SamplerConfig, SchedulerConfig, ServingEngine,
    StagedEngine,
)
from repro_torch.tree import tree_leaves

SEED = 0  # weights (torch.Generator) and prompts (numpy), as the reference's PRNGKey(0) / default_rng(0)
PROMPT_TOKENS, NEW_TOKENS = 6, 8
CALIB_BATCH, CALIB_SEQ, CALIB_SEED = 2, 16, 100  # --calibrate's batches: 2 x 16 tokens, seeds 100 + i
UNPORTED = {  # flag -> the step it waits for
    "compile_cache": "a counterpart of XLA's persistent compilation cache, which the port does not have "
                     "(its kernels build once per checkout into build/kernels)",
}


@dataclasses.dataclass
class ServeRun:
    """What ``main`` served: the engine, the requests it completed (in
    completion order), those shed or rejected at submit, and host-clock
    seconds of boot (model, quantization, engine) and of the run."""

    engine: Any
    done: List[Request]
    not_admitted: List[Request]
    boot_s: float
    run_s: float


def weight_mb(qparams, dtype: torch.dtype):
    """(MB the float weights would take in ``dtype``, MB they take packed)."""
    item = torch.empty((), dtype=dtype).element_size()
    fp = q = 0
    for leaf in tree_leaves(qparams):
        if isinstance(leaf, QTensor):
            fp += max(leaf.experts, 1) * int(np.prod(leaf.shape)) * item
            q += leaf.nbytes()
        else:
            fp += leaf.numel() * item
            q += leaf.numel() * leaf.element_size()
    return fp / 1e6, q / 1e6


def draw_prompts(n: int, vocab: int) -> List[List[int]]:
    """The launcher's ``n`` prompts of ``PROMPT_TOKENS`` tokens, drawn as
    the reference's launcher draws them (numpy, seed 0)."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, PROMPT_TOKENS).tolist() for _ in range(n)]


def build_config(args) -> configs.ArchConfig:
    qc = QuantConfig(w_bits=args.bits, group_size=args.group_size, mode="ptq", backend=args.backend or "auto",
                     fmt=args.fmt)
    return (configs.get_smoke if args.smoke else configs.get_config)(args.arch, qc)


def serving_view(api, args, device: torch.device):
    """``api`` over the command line's KV format and flash knobs (serving-time
    choices: the weights and the plan do not depend on them)."""
    cfg = api.cfg
    view = dataclasses.replace(cfg, kv_fmt=args.kv_fmt or cfg.kv_fmt,
                               flash_decode=args.flash_decode or cfg.flash_decode,
                               flash_prefill=args.flash_prefill or cfg.flash_prefill)
    return api if view == cfg else build_model(view, api.ctx, device=device)


def calibration_batches(cfg, n: int, device: torch.device):
    """``--calibrate n``: n seeded batches of CALIB_BATCH x CALIB_SEQ tokens."""
    return [make_smoke_batch(torch.Generator(device=device).manual_seed(CALIB_SEED + i), cfg, CALIB_BATCH, CALIB_SEQ)
            for i in range(n)]


def boot_quantize(args, device: torch.device, mesh=None):
    """Quantize on boot: (api, qparams, plan), calibrated with ``--calibrate``
    (on a mesh every rank makes the whole model; the engine keeps its
    shards)."""
    cfg = build_config(args)
    api = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    if args.calibrate:
        params = api.init(gen)
        qparams, plan, api = quantize_and_plan(api, params, calibration_batches(cfg, args.calibrate, device))
        del params
    else:
        qparams, plan, api = init_quantized(api, gen)
    fp_mb, q_mb = weight_mb(qparams, getattr(torch, cfg.dtype))
    print(f"arch={cfg.name} weights {fp_mb:.1f} MB -> {q_mb:.1f} MB ({fp_mb / q_mb:.1f}x)  plan: "
          f"{len(plan.site_paths)} sites, {len(plan.act_exponents)} calibrated")
    if args.save_artifact and (mesh is None or mesh.rank == 0):
        out = save_servable(args.save_artifact, api, qparams, plan, mesh=mesh)
        print(f"saved packed artifact to {out}{'' if mesh is None else ' (per-host shards)'} "
              f"(serve it with --artifact {args.save_artifact})")
    if args.plan_json:
        with open(args.plan_json, "w") as f:
            f.write(plan.to_json())
        print(f"wrote QuantPlan to {args.plan_json}")
    return api, qparams, plan


def boot_from_artifact(artifact_dir: str, device: torch.device, backend: Optional[str] = None, mesh=None):
    """Cold start: (api, qparams, plan) from a packed on-disk artifact (on a
    mesh: this rank's shards)."""
    t0 = time.perf_counter()
    api, qparams, art = load_servable(artifact_dir, mesh=mesh, device=device, backend=backend)
    plan = art.plan
    plan_str = (f"plan: {len(plan.site_paths)} sites, {len(plan.act_exponents)} calibrated" if plan is not None
                else "plan: none (unquantized artifact)")
    _, q_mb = weight_mb(qparams, getattr(torch, api.cfg.dtype))
    mesh_str = "" if mesh is None else f" onto mesh {dict(mesh.shape)} (per-host shards assembled)"
    print(f"arch={api.cfg.name} cold-started from {art.path} in {time.perf_counter() - t0:.2f}s: {q_mb:.1f} MB "
          f"packed, {plan_str} (fp32 never materialized){mesh_str}")
    return api, qparams, plan


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve", description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=configs.ARCH_IDS)
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="cold-start from a packed artifact written by either package (replaces --arch, "
                         "--calibrate: no float weights, no requantization)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--bits", type=int, default=2, choices=[2, 4, 8])
    ap.add_argument("--fmt", default=None, metavar="NAME",
                    help="registered weight format by name (nf4, mx); overrides the --bits ladder")
    ap.add_argument("--group-size", type=int, default=16)
    ap.add_argument("--kv-fmt", default=None, choices=["kv_bf16", "kv_int8", "kv_mx"],
                    help="KV-cache format (models/kv_cache.py); overrides the config")
    ap.add_argument("--flash-decode", action="store_true",
                    help="single-token decode through the hand-written flash kernel")
    ap.add_argument("--flash-prefill", action="store_true",
                    help="chunked-prefill cache attends (and the in-chunk tail) through the flash kernel; "
                         "independent of --flash-decode")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--engine", default="staged", choices=["lockstep", "staged"],
                    help="staged (default): prefill / insert / generate stages with chunked prefill; "
                         "lockstep: the shared-tick oracle")
    ap.add_argument("--prefill-chunk", type=int, default=32, metavar="N",
                    help="staged engine: max prompt tokens one prefill dispatch may consume")
    ap.add_argument("--policy", default="decode", choices=["decode", "prefill"],
                    help="staged engine stage arbitration: decode priority (TPOT) or prefill priority (TTFT)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--calibrate", type=int, default=0, metavar="N",
                    help="profile N seeded batches of 2 x 16 tokens for static activation exponents")
    ap.add_argument("--save-artifact", default=None, metavar="DIR",
                    help="persist the quantized model as a packed artifact")
    ap.add_argument("--plan-json", default=None, help="write the compiled QuantPlan to this path")
    ap.add_argument("--backend", default=None, choices=["auto", "cuda", "ref"],
                    help="qdense backend the plan carries: cuda (the kernels; plain versions on the CPU), "
                         "ref (the bit-exact oracle), auto (cuda; the default); with --artifact it replaces "
                         "the artifact plan's")
    ap.add_argument("--device", default=None,
                    help="cuda (default; under --mesh cuda:LOCAL_RANK) or cpu (the plain PyTorch versions)")
    # fault tolerance: deadlines, load shedding, overload SLOs, chaos
    ap.add_argument("--deadline-ms", type=float, default=None, metavar="MS",
                    help="default per-request deadline; past it a request is expired, queued or in flight")
    ap.add_argument("--max-queue", type=int, default=None, metavar="N",
                    help="shed submissions once the queue holds N requests")
    ap.add_argument("--ttft-slo-ms", type=float, default=None, metavar="MS",
                    help="shed submissions whose estimated TTFT exceeds MS")
    ap.add_argument("--tpot-slo-ms", type=float, default=None, metavar="MS",
                    help="enter overload mode (smaller prefill chunks, decode priority) when recent TPOT p95 "
                         "exceeds MS")
    ap.add_argument("--retries", type=int, default=1, metavar="N",
                    help="retry budget of fault-quarantined requests (re-queued with exponential backoff)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="inject seeded faults, e.g. 'rate=0.01,kinds=nan_logits|kv_corrupt|stall_tick,seed=0'")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="serve across ranks under torch.distributed.run, e.g. dp=2,ep=2 (aliases dp -> data, "
                         "ep / tp -> model); the mesh size must equal WORLD_SIZE")
    # accepted so that the reference's command lines parse; it exits naming why
    ap.add_argument("--compile-cache", default=None, metavar="DIR", help="not ported")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> ServeRun:
    ap = parser()
    args = ap.parse_args(argv)
    for flag, step in UNPORTED.items():
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} is not ported yet: it waits for {step}")
    if bool(args.artifact) == bool(args.arch):
        ap.error("exactly one of --arch or --artifact is required")
    mesh = None
    if args.mesh:
        try:
            n = mesh_size(args.mesh)
        except ValueError as e:
            ap.error(str(e))
        world = int(os.environ.get("WORLD_SIZE", 1))
        if n != world:
            ap.error(f"--mesh {args.mesh} has {n} ranks but WORLD_SIZE is {world}: run one launcher a rank, "
                     f"python -m torch.distributed.run --nproc_per_node {n} -m repro_torch.launch.serve ...")
        device = torch.device(args.device or f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
        init_distributed(device)
        mesh = parse_mesh_spec(args.mesh, device)
        dist.barrier()  # every rank's group up (NCCL: its communicator) before boot
    else:
        device = torch.device(args.device or "cuda")
    try:
        # every rank serves; rank 0 reports
        with contextlib.nullcontext() if mesh is None or mesh.rank == 0 else contextlib.redirect_stdout(io.StringIO()):
            return _serve(args, device, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _serve(args, device: torch.device, mesh) -> ServeRun:
    t0 = time.perf_counter()
    if args.artifact:
        api, qparams, _ = boot_from_artifact(args.artifact, device, args.backend, mesh)
    else:
        api, qparams, _ = boot_quantize(args, device, mesh)
    api = serving_view(api, args, device)
    cfg = api.cfg
    # the banner always states both flash knobs
    print(f"kv cache: fmt={resolve_kv_fmt(cfg)} flash_decode={cfg.flash_decode} flash_prefill={cfg.flash_prefill}")

    faults = FaultInjector.from_spec(args.chaos) if args.chaos else None
    if faults is not None:
        print(f"chaos: rate={faults.rate} kinds={'|'.join(faults.kinds)}")
    eng_kw = dict(n_slots=args.slots, max_len=args.max_len, sampler=SamplerConfig(temperature=args.temperature),
                  admission=AdmissionConfig(max_queue=args.max_queue, ttft_slo_ms=args.ttft_slo_ms,
                                            deadline_ms=args.deadline_ms),
                  health=HealthConfig(overload_tpot_ms=args.tpot_slo_ms), faults=faults, mesh=mesh)
    if args.engine == "staged":
        eng = StagedEngine(api, qparams, sched=SchedulerConfig(prefill_chunk=args.prefill_chunk, policy=args.policy),
                           **eng_kw)
        print(f"engine=staged policy={args.policy} prefill_chunk={args.prefill_chunk}")
    else:
        eng = ServingEngine(api, qparams, **eng_kw)
        print("engine=lockstep (shared-tick oracle)")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    boot_s = time.perf_counter() - t0
    not_admitted = []
    for i, prompt in enumerate(draw_prompts(args.requests, cfg.vocab)):
        r = eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=NEW_TOKENS, max_retries=args.retries))
        if r.status != "queued":
            not_admitted.append(r)
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    finished = [r for r in done if r.status == "finished"]
    toks = sum(len(r.output) for r in finished)
    print(f"{len(finished)} finished / {toks} tokens in {dt:.1f}s ({toks / dt:.1f} tok/s); boot {boot_s:.1f}s")
    health = eng.stats()["health"]
    ev = health["events"]
    if not_admitted or any(ev[k] for k in ("expired", "failed", "quarantined", "retried")):
        print(f"  fault tolerance: shed={ev['shed']} rejected={ev['rejected']} expired={ev['expired']} "
              f"quarantined={ev['quarantined']} retried={ev['retried']} failed={ev['failed']}")
        for r in not_admitted[:4]:
            print(f"    req {r.uid} {r.status}: {r.reason}")
    print(f"  ticks={health['ticks']} slow={health['slow_ticks']} hung={health['hung_ticks']} "
          f"tick_ewma={health['tick_ms_ewma']:.1f}ms overload_entered={health['overload_entered']}")
    if health["faults"]:
        print(f"  chaos injected: {health['faults']}")
    left = eng.leftover()
    if left["in_flight"] or left["queued"]:
        print(f"UNFINISHED: {len(left['in_flight'])} in flight, {len(left['queued'])} queued (tick budget "
              "expired; drain() returns them)")
    lat = eng.stats()["latency"]
    for name in ("queue_wait", "ttft", "tpot"):
        p = lat[name]
        if p is not None:
            print(f"  {name:10s} p50={p['p50'] * 1e3:7.1f}ms p95={p['p95'] * 1e3:7.1f}ms "
                  f"p99={p['p99'] * 1e3:7.1f}ms (n={p['n']})")
    for r in sorted(done, key=lambda r: r.uid)[:4]:
        print(f"  req {r.uid}: {r.output}")
    return ServeRun(eng, done, not_admitted, boot_s, dt)


if __name__ == "__main__":
    main()
