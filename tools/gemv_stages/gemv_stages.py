"""Why the grid-z expert-batched packed GEMV (the one-site GEMV with the
expert on grid z, planned for sms / E SMs an expert) streams at a fraction
of the H100's bandwidth: time its stages one by one, against a plain read of the
same bytes and the expert kernel that replaced it.

    python3 tools/gemv_stages/gemv_stages.py [--new-only]

Needs a card and nvcc.  grok-1's gate / up site (E 8, K 6144, N 32768,
ternary at group 64, C 8, every expert routed) and its down projection
(K 32768, N 6144): the grid-z kernel (a copy in this folder with a stage
switch: 0 the weight stream into the ring alone, 1 + the decode, 2 +
mma.sync, 3 + the per-cluster rescale, 4 the whole kernel) on its plan
(``gemv_plan`` at sms / E) and on a one-expert launch planned for the
whole card; the package's kernel (``packed_qmm``) and a copy of it with a
stage switch (0 the weight, x and scale stream into the ring alone, 1 +
the decode and x's permutation, 2 + mma.sync, 3 the whole kernel); a plain
16-byte read of the packed weights.  CUDA events, 256 MB of device memory written before
each call so the weights come cold, as chip_smoke.py's timer.  Prints
ptxas' registers and spills of both kernels.
"""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fused_qmm import gemv_args, gemv_plan  # noqa: E402
from repro_torch.kernels.packed_qmm import expert_plan, packed_qmm  # noqa: E402

HERE = Path(__file__).resolve().parent
NEW_ONLY = "--new-only" in sys.argv  # skip the grid-z kernel's stages
STAGES = ("stream into the ring", "+ decode", "+ mma.sync", "+ rescale", "whole kernel")
NEW_STAGES = [  # (stage, mask, ring stages (0: the package's 8), what): mask bit 0 streams x, bit 1 the scale
    # words, bit 2 the scales by one lane a group
    (0, 0, 0, "stream: the weights alone"), (0, 2, 0, "stream: weights + scales"), (0, 1, 0, "stream: weights + x"),
    (0, 3, 0, "stream: weights + x + scales (the package's)"),
    (0, 7, 0, "stream: weights + x + scales by one lane a group"),
    (0, 0, 16, "stream: the weights alone, 16 stages"), (0, 0, 32, "stream: the weights alone, 32 stages"),
    (0, 2, 16, "stream: weights + scales, 16 stages"), (0, 3, 16, "stream: weights + x + scales, 16 stages"),
    (1, 3, 0, "+ decode and x perm"), (2, 3, 0, "+ mma.sync"), (3, 3, 0, "whole kernel"),
    (3, 7, 0, "whole kernel, scales by one lane a group"),
]
if "--streams" in sys.argv:  # the stream variants only
    NEW_STAGES = [v for v in NEW_STAGES if v[0] == 0 and v[1] in (0, 3) and v[2] == 0]


def ring_smem(mask, depth, plan):
    """Shared memory of a stage variant: 8 warps x stages x 32 lanes x (weights, x if streamed, scales)."""
    return 8 * (depth or 8) * 32 * (16 + 16 * (mask & 1) + 4)  # the scale words' slots always


def build(name: str, tag: str) -> ctypes.CDLL:
    out = ROOT / "build" / "gemv_stages" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(HERE / f"{name}.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode:
        raise SystemExit(log.stdout + log.stderr)
    for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas {tag}:", line.strip())
    return ctypes.CDLL(str(out))


def build_all() -> tuple:
    lib = build("gemv_stages", "grid-z")
    lib.stage_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                                 + [ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p])
    lib.read_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    new = build("expert_stages", "new")
    new.expert_stage_launch.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                        + [ctypes.c_size_t, ctypes.c_void_p])
    new.strip_read_launch.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return lib, new


class Timer:
    def __init__(self, dev):
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters=10) -> float:
        fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


def site(name, e, k, n, c, libs, timer, dev, sms, routed=None):
    lib, new = libs
    gen = torch.Generator(device=dev).manual_seed(k)
    packed = torch.randint(-2**31, 2**31 - 1, (e, k // 16, n), generator=gen, device=dev, dtype=torch.int32)
    scale_m = torch.randint(-127, 128, (e, k // 64, n), generator=gen, device=dev, dtype=torch.int8)
    xq = torch.randint(-127, 128, (e, c, k), generator=gen, device=dev, dtype=torch.int8)
    if routed is not None:
        xq[routed:] = 0
    out = torch.empty((e, c, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    nbytes = packed.numel() * 4 + scale_m.numel() + xq.numel() + out.numel() * 4
    bound = nbytes / 3.35e12 * 1e3

    def report(label, ms):
        print(f"{name}: {label}: {ms:.4f} ms, {nbytes / ms / 1e6:.0f} GB/s ({bound / ms:.0%} of the byte bound "
              f"{bound:.4f} ms)", flush=True)

    if routed is not None:  # the routed experts' weights and scales only
        nbytes = (packed.numel() * 4 + scale_m.numel()) * routed // e + xq.numel() + out.numel() * 4
        bound = nbytes / 3.35e12 * 1e3
    plan = expert_plan(e, c, k, "ternary", 64, sms)
    flags = torch.empty(e * plan["slices"], dtype=torch.int32, device=dev)
    for stage, mask, depth, what in NEW_STAGES:
        smem = ring_smem(mask, depth, plan)
        blocks = min(2, 227 * 1024 // (smem + 2200))
        def fn(stage=stage, mask=mask, depth=depth, smem=smem, blocks=blocks):
            err = new.expert_stage_launch(stage, mask, depth, xq.data_ptr(), packed.data_ptr(), scale_m.data_ptr(),
                                          flags.data_ptr(), out.data_ptr(), e, plan["slices"], c, k, n, sms * blocks,
                                          smem, stream)
            if err:
                raise SystemExit(f"new stage {stage} mask {mask} depth {depth}: cudaError_t {err}")
        report(f"package kernel copy, stage {stage} mask {mask} ({what}; {smem} B smem, {blocks} blocks an SM)",
               timer(fn))
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    for depth, wide in ((8, 1), (16, 1), (8, 4), (16, 4)):
        for blocks in (2, 4):
            def fn(depth=depth, wide=wide, blocks=blocks):
                err = new.strip_read_launch(depth, wide, packed.data_ptr(), routed or e, k, n, sink.data_ptr(),
                                            sms * blocks, stream)
                if err:
                    raise SystemExit(f"strip read: cudaError_t {err}")
            report(f"register stream of the units' weights, {depth} loads a lane in flight, "
                   f"{'4 rows x 128 B' if wide == 1 else '512 contiguous B'} a warp load, {blocks} blocks an SM",
                   timer(fn))
    if routed is not None or NEW_ONLY:
        report("package kernel (qmm_gemv_experts.cuh)", timer(lambda: packed_qmm(xq, packed, scale_m, decode="ternary",
                                                                                  group=64)))
        return
    for label, experts, plan_sms, scale in (("grid-z plan (sms / E), E launches as one", e, -(-sms // e), 1),
                                             ("one expert, planned for the whole card, x E", 1, sms, e)):
        plan = gemv_plan(c, k, n, "ternary", 64, 512, plan_sms)
        print(f"{name}: {label}: plan {plan}", flush=True)
        for stage, what in enumerate(STAGES):
            def fn(stage=stage):
                err = lib.stage_launch(stage, xq.data_ptr(), packed.data_ptr(), scale_m.data_ptr(), out.data_ptr(),
                                       c, k, n, 64, 512, *gemv_args(plan), plan["smem"], experts, stream)
                if err:
                    raise SystemExit(f"stage {stage}: cudaError_t {err}")
            report(f"{label}, stage {stage} ({what})", timer(fn) * scale)
    report("package kernel (qmm_gemv_experts.cuh), every expert routed",
           timer(lambda: packed_qmm(xq, packed, scale_m, decode="ternary", group=64)))
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    for blocks in (sms * 4, sms * 8):
        report(f"plain 16-byte read of the packed weights, {blocks} blocks of 256",
               timer(lambda: lib.read_launch(packed.data_ptr(), packed.numel() // 4, sink.data_ptr(), blocks, stream)))
    torch.cuda.synchronize()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build_all()
    logs = _build.build_all(["packed_qmm"])
    log = logs["packed_qmm"] or _build.lib_path("packed_qmm").with_suffix(".log").read_text()
    entry = ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and "expert_gemv" in entry:
            print("ptxas package expert kernel:", entry[:60], line.strip())
    sms = _build.sm_count(dev)
    timer = Timer(dev)
    site("grok gate C 8", 8, 6144, 32768, 8, libs, timer, dev, sms)
    site("grok down C 8", 8, 32768, 6144, 8, libs, timer, dev, sms)
    site("arctic gate C 8, 8 of 128 routed", 128, 7168, 4864, 8, libs, timer, dev, sms, routed=8)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
