"""Shared cases of the CPU mesh-serving tests: the port's artifacts (its
own whole and sharded writes), one ``torch.multiprocessing.spawn`` of
``_mesh_worker`` a world size over gloo, the single-process port's and the
reference's single-device results on the whole artifact."""
import dataclasses
import socket

import torch
import torch.multiprocessing as mp

import _mesh_worker as W
from repro import models as jmodels
from repro.serving import Request as JRequest
from repro.serving import StagedEngine as JStaged
from repro.serving.scheduler import SchedulerConfig as JSched
from repro_torch import configs
from repro_torch.configs.base import QuantConfig
from repro_torch.models import build_model, init_quantized, save_servable

PTQ = QuantConfig(w_bits=2, group_size=16, mode="ptq", backend="cuda")  # the card's route; plain versions here


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write(root, name: str, arch: str, over: dict, sizes: dict):
    """The port's (whole, sharded) artifacts of a seeded smoke model."""
    cfg = dataclasses.replace(configs.get_smoke(arch, PTQ), **over)
    qparams, plan, api = init_quantized(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    whole, sharded = str(root / f"{name}_whole"), str(root / f"{name}_sharded")
    save_servable(whole, api, qparams, plan)
    save_servable(sharded, api, qparams, plan, mesh=sizes)
    return whole, sharded


def spawn(jobs, world: int, root):
    """Rank 0's results of ``jobs`` (name, mesh spec, artifact, slots) on a
    gloo group of ``world`` ranks."""
    out = str(root / f"world{world}.pt")
    mp.spawn(W.worker, args=(world, free_port(), jobs, out), nprocs=world, join=True)
    return torch.load(out)


def single(artifact: str, slots: int = W.SLOTS):
    """The single-process port's results on the whole artifact."""
    return W.run_jobs([("single", None, artifact, slots)])["single"]


def reference(whole: str, engine, slots: int = W.SLOTS):
    """The reference's single-device engine on the port's whole artifact
    (its plan rebound to the reference's exact ``ref`` backend)."""
    api, params, art = jmodels.load_servable(whole)
    api = api.with_plan(dataclasses.replace(art.plan, backend="ref"))
    kw = {"sched": JSched(prefill_chunk=4)} if engine is JStaged else {}
    eng = engine(api, params, n_slots=slots, max_len=W.MAX_LEN, **kw)
    for i, p in enumerate(W.prompts(slots)):
        eng.submit(JRequest(uid=i, prompt=list(p), max_new_tokens=W.NEW))
    return {r.uid: list(r.output) for r in eng.run()}


def assert_logits_equal(got, want):
    assert len(got["logits"]) == len(W.DECODE_TOKENS) + 1
    for a, b in zip(got["logits"], want["logits"]):
        assert a.shape == b.shape and torch.equal(a, b)
    assert sum(got["traffic"].values()) > 0  # collectives really ran
    assert want["traffic"] == {} and want["mesh"] is None
