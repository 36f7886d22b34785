"""One rank of the CPU mesh-serving tests (``test_torch_mesh_serving.py``):
started by ``torch.multiprocessing.spawn`` over gloo, it imports the port
only.  Each job cold-starts both engines from a sharded artifact on its
mesh, serves the prompts, and runs a decode loop and a prefill chunk
through the sharded api for their logits; rank 0 saves what it saw."""
import torch
import torch.distributed as dist

PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [5], [200, 17, 33, 4], [9, 9, 9, 9, 9, 9, 9]]
DECODE_TOKENS = [[3, 5, 250, 17], [11, 0, 2, 99], [42, 42, 1, 7], [6, 128, 255, 64], [8, 8, 8, 8]]
CHUNK = [4, 77, 130, 9, 201]
SLOTS, MAX_LEN, NEW = 4, 32, 5
WIDE_SLOTS = 16  # a decode batch of 16 tokens: 32 replicas over 4 experts, so capacity 8 drops some


def prompts(slots: int):
    """The prompts of a job: PROMPTS, or one a slot for a wide batch."""
    if slots == SLOTS:
        return PROMPTS
    return [[(7 * i + 3 * j) % 256 for j in range(1 + i % 4)] for i in range(slots)]


def serve(engine_cls, artifact: str, mesh, slots: int = SLOTS, **kw):
    from repro_torch.serving import Request

    eng = engine_cls.from_artifact(artifact, mesh=mesh, device="cpu", n_slots=slots, max_len=MAX_LEN, **kw)
    for i, p in enumerate(prompts(slots)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=NEW))
    done = eng.run()
    return {r.uid: list(r.output) for r in done}, eng.stats()


def logits(artifact: str, mesh):
    """Decode logits of 5 steps over 4 slots, and one prefill chunk's, through
    the (sharded) api of a cold start; and, on a mesh, how the rank placed
    its params."""
    from repro_torch.models import load_servable
    from repro_torch.models import spmd

    api, params, _ = load_servable(artifact, mesh=mesh, device="cpu")
    placed = None
    if mesh is not None:
        params, state = spmd.install(params, mesh, api.cfg)
        api = spmd.shard_api(api, state)
        experts = params["blocks"][0].get("moe", {}).get("experts", {}).get("gate", {}).get("w")
        placed = {"layouts": state.layouts, "heads_local": state.heads_local,
                  "local_experts": None if experts is None else (experts.experts, tuple(experts.scale_e.shape)),
                  "router_n": params["blocks"][0].get("moe", {}).get("router", {}).get("w", None)}
        placed["router_n"] = None if placed["router_n"] is None else placed["router_n"].n
    cache = api.init_cache(SLOTS, MAX_LEN)
    out = []
    with torch.inference_mode():
        for step, toks in enumerate(DECODE_TOKENS):
            tok = torch.tensor(toks, dtype=torch.int32)[:, None]
            pos = torch.tensor([step, step + 1, step, step + 2], dtype=torch.int32)
            lg, cache = api.decode(params, tok, pos, cache)
            out.append(lg)
        lg, _ = api.prefill_chunk(params, torch.tensor([CHUNK], dtype=torch.int32), 0, api.init_cache(1, MAX_LEN))
        out.append(lg)
    return out, placed


def run_jobs(jobs, mesh_factory=None):
    from repro_torch.parallel import collectives
    from repro_torch.serving import ServingEngine, StagedEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    results = {}
    for name, spec, artifact, slots in jobs:
        mesh = mesh_factory(spec) if mesh_factory else None
        collectives.reset_traffic()
        lock, stats = serve(ServingEngine, artifact, mesh, slots)
        traffic = collectives.traffic()
        staged, _ = serve(StagedEngine, artifact, mesh, slots, sched=SchedulerConfig(prefill_chunk=4))
        lg, placed = logits(artifact, mesh)
        results[name] = {"lockstep": lock, "staged": staged, "logits": lg, "placed": placed, "mesh": stats["mesh"],
                         "traffic": traffic}
    return results


def worker(rank: int, world: int, port: int, jobs, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    from repro_torch.launch.mesh import parse_mesh_spec

    try:
        results = run_jobs(jobs, lambda spec: parse_mesh_spec(spec, torch.device("cpu")))
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()

