"""The expert GEMV at other stream depths and occupancies: copies of
``csrc/qmm_gemv_experts.cuh`` (or, with ``--regs FILE``, of a version of it
that streams through a pipeline of registers, its ``Pipe`` depths
replaced) with the ring's stages and the kernel's launch bounds replaced
(ternary at group 64 only), built in parallel, their ptxas registers and
spills printed, and timed at grok-1's gate and down (C 8, every expert
routed) and arctic's gate (8 of 128 routed) with chip_smoke.py's timer,
each checked bit for bit against the plain loop.

    python3 tools/gemv_stages/pipe_variants.py [--regs FILE]

Needs a card and nvcc; no part of the package.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from gemv_stages import Timer  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.packed_qmm import expert_plan, packed_qmm_ref  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "pipe_variants"
REGS = sys.argv[sys.argv.index("--regs") + 1] if "--regs" in sys.argv else None
# (ring stages, 0, blocks an SM); with --regs (weight steps in flight, x steps in flight, blocks an SM)
VARIANTS = ([(8, 2, 2), (8, 1, 2), (6, 1, 2), (4, 1, 2), (8, 1, 1), (12, 1, 1), (16, 2, 1)] if REGS else
            [(8, 0, 2), (8, 0, 3), (4, 0, 3), (4, 0, 4), (16, 0, 1)])
WRAPPER = """#include "header.cuh"
extern "C" int launch(const void* xq, const void* w, const void* sm, void* flags, void* out, int E, int P, int M, int K,
                      int N, int grid, void* stream) {
  const qmm::gemv::ExpertArgs a{static_cast<const int8_t*>(xq), w, static_cast<const int8_t*>(sm),
                                static_cast<const int*>(flags), static_cast<float*>(out), E, P, M, K, N, 64,
                                K < 512 ? K : 512, make_uint4(0, 0, 0, 0)};
  return static_cast<int>(qmm::gemv::launch_experts_v<qmm::gemv::kT64>(a, grid, SMEM static_cast<cudaStream_t>(stream)));
}
"""


def source(depth, xdepth, blocks) -> tuple:
    s = Path(REGS).read_text() if REGS else (CSRC / "qmm_gemv_experts.cuh").read_text()
    swaps = [('#include "qmm_gemv.cuh"', f'#include "{CSRC / "qmm_gemv.cuh"}"'),
             ("__launch_bounds__(kThreads, kBlocksPerSm) expert_gemv_kernel",
              f"__launch_bounds__(kThreads, {blocks}) expert_gemv_kernel")]
    if REGS:
        swaps += [("kDepth = Map<V>::kLaneBytes == 32 ? 4 : 8;", f"kDepth = Map<V>::kLaneBytes == 32 ? 4 : {depth};"),
                  ("kXDepth = 2;", f"kXDepth = {xdepth};")]
    else:
        swaps += [("constexpr int kRing = P::kRing,", f"constexpr int kRing = {depth},"),
                  ("Map<V>::kRing * 32 * (Map<V>::kLaneBytes", f"{depth} * 32 * (Map<V>::kLaneBytes")]
    for old, new in swaps:
        assert s.count(old) == 1, old
        s = s.replace(old, new)
    smem = "" if REGS else "qmm::gemv::expert_smem_bytes<qmm::gemv::kT64>(),"
    return s, WRAPPER.replace("SMEM", smem)


def main():
    dev = torch.device("cuda", 0)
    procs = []
    for v in VARIANTS:
        d = OUT / "_".join(map(str, v))
        d.mkdir(parents=True, exist_ok=True)
        header, wrapper = source(*v)
        (d / "header.cuh").write_text(header)
        (d / "wrapper.cu").write_text(wrapper)
        procs.append(subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "wrapper.cu")],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, p in zip(VARIANTS, procs):
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(log)
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line
            elif ("registers" in line or "spill" in line) and "expert_gemv" in entry:
                print(f"variant {v}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(OUT / "_".join(map(str, v)) / "lib.so"))
        lib.launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        libs[v] = lib
    timer = Timer(dev)
    sms = _build.sm_count(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, e, k, n, routed in (("grok gate", 8, 6144, 32768, 8), ("grok down", 8, 32768, 6144, 8),
                                  ("arctic gate 8 of 128", 128, 7168, 4864, 8)):
        gen = torch.Generator(device=dev).manual_seed(k)
        packed = torch.randint(-2**31, 2**31 - 1, (e, k // 16, n), generator=gen, device=dev, dtype=torch.int32)
        scale_m = torch.randint(-127, 128, (e, k // 64, n), generator=gen, device=dev, dtype=torch.int8)
        xq = torch.randint(-127, 128, (e, 8, k), generator=gen, device=dev, dtype=torch.int8)
        xq[routed:] = 0
        out = torch.empty((e, 8, n), dtype=torch.float32, device=dev)
        plan = expert_plan(e, 8, k, "ternary", 64, sms)
        flags = torch.empty(e * plan["slices"], dtype=torch.int32, device=dev)
        nbytes = (packed.numel() * 4 + scale_m.numel()) * routed // e + xq.numel() + out.numel() * 4
        want = packed_qmm_ref(xq[:routed], packed[:routed], scale_m[:routed], decode="ternary", group=64)
        for v, lib in libs.items():
            def fn(lib=lib, v=v):
                err = lib.launch(xq.data_ptr(), packed.data_ptr(), scale_m.data_ptr(), flags.data_ptr(), out.data_ptr(),
                                 e, plan["slices"], 8, k, n, sms * v[2], stream)
                if err:
                    raise SystemExit(f"{v}: cudaError_t {err}")
            ms = timer(fn)
            same = torch.equal(out[:routed].view(torch.int32), want.view(torch.int32)) and not out[routed:].any()
            what = f"depth {v[0]}, x depth {v[1]}" if REGS else f"ring of {v[0]} stages"
            print(f"{name}: {what}, {v[2]} blocks an SM: {ms:.4f} ms "
                  f"({nbytes / 3.35e12 * 1e3 / ms:.0%} of the byte bound), bits equal the plain loop: {same}", flush=True)


if __name__ == "__main__":
    main()
