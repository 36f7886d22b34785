"""GPU smoke run of the PyTorch/CUDA port (src/repro_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. card     -- print the card's name and power limit; no CUDA -> exit 1
  2. build    -- compile every kernel under src/repro_torch/csrc (one nvcc
                 per source, all at once) into build/kernels
  3. parity   -- each kernel against its plain PyTorch version on the card,
                 at the main path's shapes
  4. main     -- serve the full-width qwen3-8b (ternary PTQ, group 64, all
                 36 layers, bf16, random weights from a seeded generator,
                 quantized on the card one site at a time) through the
                 lockstep engine: 4 slots, 8 requests, 16-token prompts,
                 16 greedy tokens each; every launch count must be > 0;
                 then 8 more ticks under torch.profiler (device busy
                 share, time by kernel); a 2-layer full-width twin checks
                 the kernel path against the plain path over 6 steps
  5. timings  -- kernel, plain version, library call (a yardstick the port
                 never calls) and the bound from bytes and operations

The last two lines are the `kernels` JSON and the device JSON.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SEED = 0
ARCH = "qwen3-8b"
GROUP = 64
SLOTS, MAX_LEN, N_REQ, PROMPT, NEW = 4, 256, 8, 16, 16
FLASH_SHAPE = dict(b=4, t=256, kh=8, g=4, hd=128)  # decode: 4 slots, max_len 256
FLASH_VALID = [1, 77, 200, 256]  # ragged fill levels
QDENSE_SITES = [  # (name, K, N, decode, act) -- one layer's sites, then lm_head
    ("wq", 4096, 4096, "ternary", None), ("wk", 4096, 1024, "ternary", None),
    ("wv", 4096, 1024, "ternary", None), ("wo", 4096, 4096, "ternary", None),
    ("gate", 4096, 12288, "ternary", "silu"), ("up", 4096, 12288, "ternary", None),
    ("down", 12288, 4096, "ternary", None), ("lm_head", 4096, 152064, "int8", None),
]
M_ROWS = SLOTS  # rows per decode-tick projection


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. card
# ---------------------------------------------------------------------------
def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false -- this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------
def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# 3. parity
# ---------------------------------------------------------------------------
def _qsite(k, n, decode, gen, dev):
    from repro_torch.quant.formats import quantize_weights

    w = torch.randn((k, n), generator=gen, device=dev) * k**-0.5
    return quantize_weights(w, 2 if decode == "ternary" else 8, GROUP, fmt=decode)


def _edge_rows(k, gen, dev, dtype):
    """4 rows: plain, one NaN, max exactly 127 * 2**-3, max one ulp above."""
    x = torch.randn((M_ROWS, k), generator=gen, device=dev) * 0.1
    x[1, 7] = float("nan")
    x[2, 11] = 127.0 * 2.0**-3
    above = torch.nextafter(torch.tensor(127.0 * 2.0**-3), torch.tensor(1e9)).item()
    if dtype == torch.bfloat16:  # one bf16 ulp above
        above = 127.0 * 2.0**-3 * (1 + 2.0**-7)
    x[3, 13] = above
    return x.to(dtype)


def _entry(decode):
    from repro_torch.kernels.int8_matmul import int8_matmul_fused
    from repro_torch.kernels.ternary_matmul import ternary_matmul_fused

    return ternary_matmul_fused if decode == "ternary" else int8_matmul_fused


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ai = a.view(torch.int32).to(torch.int64)
    bi = b.view(torch.int32).to(torch.int64)
    ai = torch.where(ai < 0, -(2**31) - ai, ai)
    bi = torch.where(bi < 0, -(2**31) - bi, bi)
    return int((ai - bi).abs().max())


def phase_parity(dev) -> dict:
    from repro_torch.kernels.flash_prefill import flash_attend, flash_attend_ref
    from repro_torch.kernels.fused_qmm import fused_qmm_ref

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"fused_qmm_ternary": 0.0, "fused_qmm_int8": 0.0, "flash_attend_bf16": 0.0}
    failures = []
    for name, k, n, decode, act in QDENSE_SITES:
        qt = _qsite(k, n, decode, gen, dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = _edge_rows(k, gen, dev, dtype)
            for static_e in (None, -4):
                kw = dict(group=GROUP, act=act, act_exponent=static_e)
                got = _entry(decode)(x, qt.packed, qt.scale_m, qt.scale_e, **kw)
                want = fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, **kw)
                torch.cuda.synchronize()
                finite = bool(torch.isfinite(got).all())
                err = float((got - want).abs().max())
                ulps = _ulps(got, want)
                key = f"fused_qmm_{decode}"
                errs[key] = max(errs[key], err)
                ok = finite and ulps == 0  # bit-exact on every site
                log(f"parity qdense {name:7s} K={k:5d} N={n:6d} {decode:7s} x={str(dtype)[6:]:8s} "
                    f"static_e={static_e} act={act}: max_abs_err={err:.3e} ulps={ulps} "
                    f"{'OK' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"qdense {name} {dtype} static_e={static_e}")
        del qt
    fs = FLASH_SHAPE
    for s in (1, 4):
        q = torch.randn((fs["b"], s, fs["kh"], fs["g"], fs["hd"]), generator=gen, device=dev)
        kc = torch.randn((fs["b"], fs["t"], fs["kh"], fs["hd"]), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((fs["b"], fs["t"], fs["kh"], fs["hd"]), generator=gen, device=dev).to(torch.bfloat16)
        valid = torch.tensor(FLASH_VALID, dtype=torch.int32, device=dev).reshape(-1, 1)
        q_start = torch.clamp(valid - s, min=0)
        win = torch.tensor([[2**30]], dtype=torch.int32, device=dev)
        for window in (None, 64):
            w = win if window is None else torch.tensor([[window]], dtype=torch.int32, device=dev)
            got = flash_attend(q, kc, vc, None, None, q_start, valid, w, fmt="kv_bf16")
            want = flash_attend_ref(q, kc, vc, None, None, q_start, valid, w, fmt="kv_bf16")
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs["flash_attend_bf16"] = max(errs["flash_attend_bf16"], err)
            ok = bool(torch.isfinite(got).all()) and err <= 5e-5
            log(f"parity flash S={s} window={window}: max_abs_err={err:.3e} (atol 5e-5) {'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash S={s} window={window}")
    if failures:
        raise SystemExit(f"parity failed: {failures}")
    return errs


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------
def _ptq_cfg(n_layers=None):
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig

    cfg = configs.get_config(ARCH, QuantConfig(w_bits=2, group_size=GROUP, mode="ptq", backend="auto"))
    cfg = dataclasses.replace(cfg, flash_decode=True)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def _boot(cfg, dev):
    from repro_torch.models import build_model, init_quantized

    gen = torch.Generator(device=dev).manual_seed(SEED)
    return init_quantized(build_model(cfg, device=dev), gen)


def _counters():
    from repro_torch.kernels.flash_prefill import flash_attend
    from repro_torch.kernels.int8_matmul import int8_matmul_fused
    from repro_torch.kernels.ternary_matmul import ternary_matmul_fused

    return {"fused_qmm_ternary": ternary_matmul_fused, "fused_qmm_int8": int8_matmul_fused,
            "flash_attend_bf16": flash_attend}


def phase_main(dev) -> dict:
    from repro_torch.models.kv_cache import cache_bytes
    from repro_torch.serving import Request, ServingEngine

    cfg = _ptq_cfg()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams, plan, api = _boot(cfg, dev)
    eng = ServingEngine(api, qparams, n_slots=SLOTS, max_len=MAX_LEN)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    wbytes = sum(qt.nbytes() for qt in _qtensors(qparams))
    log(f"main: {cfg.name} depth {cfg.n_layers}/36 d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"d_ff {cfg.d_ff} vocab {cfg.vocab}->{cfg.padded_vocab} dtype {cfg.dtype}; boot {boot_s:.2f} s; "
        f"packed weights {wbytes / 1e9:.3f} GB, embed {qparams['embed']['table'].numel() * 2 / 1e9:.3f} GB, "
        f"kv cache {cache_bytes(eng.cache) / 1e9:.3f} GB; peak alloc {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    gen = torch.Generator().manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (N_REQ, PROMPT), generator=gen).tolist()
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    stats = eng.stats()
    log(f"main: {len(done)} requests, {stats['tick']} ticks, {stats['tokens']} tokens in {run_s:.3f} s = "
        f"{stats['tokens'] / run_s:.2f} tokens/s ({stats['tick'] / run_s:.2f} ticks/s); launches {launches} "
        f"(per tick: {({k: v / stats['tick'] for k, v in launches.items()})})")
    bad = [name for name, n in launches.items() if n <= 0]
    if bad:
        raise SystemExit(f"main path never launched {bad}")
    if len(done) != N_REQ or any(len(r.output) != NEW for r in done):
        raise SystemExit("main path: not every request finished with its tokens")
    if any(not 0 <= t < cfg.padded_vocab for r in done for t in r.output):
        raise SystemExit("main path: token id out of range")
    log(f"main: first outputs {[r.output[:6] for r in done[:2]]}")
    _trace_ticks(eng, cfg, n_ticks=8)
    del eng, qparams
    torch.cuda.empty_cache()
    _agreement(dev)
    return launches


def _trace_ticks(eng, cfg, n_ticks: int) -> None:
    """torch.profiler over a few steady decode ticks (4 busy slots, after
    the counted run): device busy share and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request

    gen = torch.Generator().manual_seed(SEED + 3)
    for i in range(SLOTS):
        prompt = torch.randint(0, cfg.vocab, (PROMPT,), generator=gen).tolist()
        eng.submit(Request(uid=1000 + i, prompt=prompt, max_new_tokens=NEW))
    for _ in range(2):  # admit and warm
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"trace: {n_ticks} ticks, {wall_us / n_ticks / 1e3:.3f} ms/tick wall, device busy "
        f"{busy_us / n_ticks / 1e3:.3f} ms/tick = {busy_us / wall_us:.1%} (idle {1 - busy_us / wall_us:.1%}); "
        f"{sum(e.count for e in kernels) / n_ticks:.0f} kernels/tick")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"trace:   {e.self_device_time_total / n_ticks:9.1f} us/tick  {e.count / n_ticks:6.1f}/tick  {e.key[:90]}")
    eng.run()  # drain the traced requests


def _qtensors(tree):
    from repro_torch.core.quantizer import QTensor

    if isinstance(tree, QTensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _qtensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _qtensors(v)


def _agreement(dev) -> None:
    """A 2-layer full-width twin: 6 decode steps through the kernels (cuda
    backend, flash decode) against the plain path (ref backend, dense
    attention oracle) on the same weights.  Both paths round activations
    to bf16 between ops, so a last-bit difference can move a DFP mantissa;
    logits must agree to 0.1 and each greedy pick must be the plain path's
    best token or within the observed difference of it."""
    from repro_torch.models import build_model

    cfg = _ptq_cfg(n_layers=2)
    qparams, plan, api = _boot(cfg, dev)
    oracle = build_model(dataclasses.replace(cfg, flash_decode=False), device=dev)
    ref_api = oracle.with_plan(dataclasses.replace(plan, backend="ref"))
    gen = torch.Generator().manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (SLOTS, 6), generator=gen).to(dev)
    outs = {}
    for name, a in (("kernel", api), ("plain", ref_api)):
        cache = a.init_cache(SLOTS, 64)
        steps = []
        with torch.inference_mode():
            for i in range(tokens.shape[1]):
                pos = i + torch.arange(SLOTS, device=dev, dtype=torch.int32)  # ragged slots
                logits, cache = a.decode(qparams, tokens[:, i:i + 1], pos, cache)
                steps.append(logits[:, -1].float())
        outs[name] = torch.stack(steps)  # (steps, slots, vocab)
    got, want = outs["kernel"], outs["plain"]
    diff = float((got - want).abs().max())
    pick = got.argmax(-1, keepdim=True)
    near_best = (want.gather(-1, pick)[..., 0] >= want.amax(-1) - 2 * diff).all()
    exact = float((pick[..., 0] == want.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(got).all())
    log(f"agreement (2 layers, full width, 6 steps x {SLOTS} slots): logits max|kernel - plain| = {diff:.3e} "
        f"(logit scale {float(want.abs().max()):.3e}); argmax equal in {exact:.0%} of steps; finite {finite}")
    if not (finite and diff <= 0.1 and bool(near_best)):
        raise SystemExit("kernel path disagrees with the plain path")


# ---------------------------------------------------------------------------
# 5. timings
# ---------------------------------------------------------------------------
class _Timer:
    """CUDA-event time of one call, device memory flushed before each run
    (the decode tick streams 2.3 GB of weights, far more than the 50 MB L2,
    so every site finds its weights cold).  A device-side sleep after the
    flush keeps the card busy while the host enqueues the call, so the
    events time the device work, not the wrapper's host overhead."""

    def __init__(self, dev):
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters=20, warmup=3) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)  # ~1 ms of device time
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def phase_timings(dev) -> dict:
    from repro_torch.kernels.flash_prefill import flash_attend, flash_attend_ref
    from repro_torch.kernels.fused_qmm import fused_qmm_ref
    from repro_torch.quant.formats import dequantize_weights

    timer = _Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = {}
    for name, k, n, decode, act in QDENSE_SITES:
        qt = _qsite(k, n, decode, gen, dev)
        x = (torch.randn((M_ROWS, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        kw = dict(group=GROUP, act=act)
        entry = _entry(decode)
        before = entry.launches
        ms = timer(lambda: entry(x, qt.packed, qt.scale_m, qt.scale_e, **kw))
        entry.launches = before  # timing launches are not main-path launches
        plain_ms = timer(lambda: fused_qmm_ref(x, qt.packed, qt.scale_m, qt.scale_e, decode=decode, **kw), iters=3, warmup=1)
        w_bf16 = dequantize_weights(qt).to(torch.bfloat16)
        lib_ms = timer(lambda: torch.matmul(x, w_bf16))
        del w_bf16
        nbytes = (x.numel() * x.element_size() + qt.nbytes() + M_ROWS * n * 4)
        ops = 2 * M_ROWS * k * n  # int8 multiply-adds on the integer pipeline
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
        rows[name] = dict(decode=decode, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                          bytes=nbytes)
        log(f"time qdense {name:7s} K={k:5d} N={n:6d} {decode:7s}: kernel {ms:.4f} ms, bound {rows[name]['bound_ms']:.4f} ms "
            f"({nbytes / 1e6:.2f} MB by {rows[name]['bound_by']}), plain {plain_ms:.4f} ms, torch.matmul bf16 {lib_ms:.4f} ms; "
            f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s")
        del qt
    fs = FLASH_SHAPE
    q = torch.randn((fs["b"], 1, fs["kh"], fs["g"], fs["hd"]), generator=gen, device=dev)
    kc = torch.randn((fs["b"], fs["t"], fs["kh"], fs["hd"]), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn_like(kc, dtype=torch.float32).to(torch.bfloat16)
    valid = torch.tensor(FLASH_VALID, dtype=torch.int32, device=dev).reshape(-1, 1)
    q_start = valid - 1
    win = torch.tensor([[2**30]], dtype=torch.int32, device=dev)
    before = flash_attend.launches
    ms = timer(lambda: flash_attend(q, kc, vc, None, None, q_start, valid, win, fmt="kv_bf16"))
    flash_attend.launches = before
    plain_ms = timer(lambda: flash_attend_ref(q, kc, vc, None, None, q_start, valid, win, fmt="kv_bf16"), iters=5)
    qh = q[:, 0].reshape(fs["b"], fs["kh"] * fs["g"], 1, fs["hd"]).to(torch.bfloat16)
    kh_, vh_ = kc.transpose(1, 2), vc.transpose(1, 2)
    mask = (torch.arange(fs["t"], device=dev)[None, :] < valid)[:, None, None, :]
    lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh_, vh_, attn_mask=mask, enable_gqa=True))
    live = int(valid.sum())  # the keys this run's fill levels need
    nbytes = (q.numel() * 4 + 2 * live * fs["kh"] * fs["hd"] * 2 + 3 * fs["b"] * 4 + q.numel() * 4)
    flops = 4 * live * fs["kh"] * fs["g"] * fs["hd"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_OPS_PER_S * 1e3
    rows["flash"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes)
    log(f"time flash decode B={fs['b']} T={fs['t']} Kh={fs['kh']} G={fs['g']} hd={fs['hd']} valid={FLASH_VALID}: "
        f"kernel {ms:.4f} ms, bound {rows['flash']['bound_ms']:.5f} ms ({nbytes / 1e6:.3f} MB live cache), "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; full-cache read {2 * fs['b'] * fs['t'] * fs['kh'] * fs['hd'] * 2 / 1e6:.2f} MB")
    return rows


def _kernel_line(errs, launches, rows) -> dict:
    layer = [r for r in rows.values() if r.get("decode") == "ternary"]
    sums = lambda key: sum(r[key] for r in layer)  # noqa: E731
    lm, fl = rows["lm_head"], rows["flash"]
    return {"kernels": [
        {"name": "fused_qmm_ternary", "route": "cuda", "source": "src/repro_torch/csrc/fused_qmm.cu",
         "replaces": "src/repro/kernels/ternary_matmul.py:63", "launches": launches["fused_qmm_ternary"],
         "max_abs_err": errs["fused_qmm_ternary"], "ms": sums("ms"), "plain_ms": sums("plain_ms"),
         "bound_ms": sums("bound_ms"), "bound_by": "bytes", "library_ms": sums("library_ms")},
        {"name": "fused_qmm_int8", "route": "cuda", "source": "src/repro_torch/csrc/fused_qmm.cu",
         "replaces": "src/repro/kernels/int8_matmul.py:53", "launches": launches["fused_qmm_int8"],
         "max_abs_err": errs["fused_qmm_int8"], "ms": lm["ms"], "plain_ms": lm["plain_ms"],
         "bound_ms": lm["bound_ms"], "bound_by": lm["bound_by"], "library_ms": lm["library_ms"]},
        {"name": "flash_attend_bf16", "route": "cuda", "source": "src/repro_torch/csrc/flash_attend.cu",
         "replaces": "src/repro/kernels/flash_prefill.py:158", "launches": launches["flash_attend_bf16"],
         "max_abs_err": errs["flash_attend_bf16"], "ms": fl["ms"], "plain_ms": fl["plain_ms"],
         "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"], "library_ms": fl["library_ms"]},
    ]}


def main() -> None:
    t_start = time.perf_counter()
    phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    errs = phase_parity(dev)
    launches = phase_main(dev)
    rows = phase_timings(dev)
    line = _kernel_line(errs, launches, rows)
    if not all(math.isfinite(v) for k in line["kernels"] for v in k.values() if isinstance(v, float)):
        raise SystemExit("a measured number is not finite")
    log(f"total {time.perf_counter() - t_start:.1f} s; ternary ms/plain/library/bound are sums over one layer's 7 sites")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
