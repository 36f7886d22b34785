"""The int8 loop's stages, timed apart: copies of ``csrc/qmm_gemv8.cuh`` with
a part switched off or a constant replaced, built in parallel (their ptxas
registers and spills printed), each launched over the packed path's plan
(``int8_loop_plan``) at a few shapes with the timer of ``chip_smoke.py``:

- ``base``: the kernel as it is (checked bit for bit against the plain
  version);
- ``load_only``: the ring's copies and waits, no products;
- ``compute_only``: the products over whatever the ring holds, no weight
  copies (scale rows still copied);
- ``ring2``: 2 ring stages a warp (no copy in flight past the one awaited;
  checked bit for bit);

and, beside them, ``torch.sum`` over the same int8 weights viewed as int64
(a plain contiguous read of the same bytes).  ``--splits 1,4`` also
times ``base`` and ``load_only`` at every shape with those k-splits (and
the most warps that fit).

    python3 tools/int8_loop_variants.py [--splits 1,4]

Needs a card and nvcc; no part of the package.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from int8_loop_check import Timer, site  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_qmm as fq  # noqa: E402
from repro_torch.kernels.fused_qmm import (  # noqa: E402
    LOOP_COLS, LOOP_STAGE_K, int8_loop_plan, loop_x_stride, n_tiles,
)
from repro_torch.kernels.packed_qmm import packed_qmm_ref  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
SPLITS = [int(v) for v in sys.argv[sys.argv.index("--splits") + 1].split(",")] if "--splits" in sys.argv else []
OUT = ROOT / "build" / "int8_loop_variants"
SHAPES = [("qwen3-8b lm_head", 4096, 152064, 64), ("whisper-base lm_head", 512, 51968, 64),
          ("zamba2-7b lm_head", 3584, 32000, 64), ("mx gate", 4096, 12288, 32)]
RING = "constexpr int kRing = 4;"
VARIANTS = {  # name -> (ring stages, text swaps, checked against the plain version)
    "base": (4, [], True),
    "load_only": (4, [("          if (kk >= kt1) break;", "          if (kk >= kt1 || kk >= 0) break;")], False),
    "compute_only": (4, [("          cp16(d, ok ? s : a.w, ok);\n        } else {",
                          "          (void)d, (void)s, (void)ok;\n        } else {")], False),
    "ring2": (2, [], True),
}
WRAPPER = """#include "header.cuh"
extern "C" int launch(const void* xq, const void* w, const void* sm, void* out, void* ws, void* counters, int M, int K,
                      int N, int group, int bk, int rows, int splits, int tps, int warps, int grid_x, size_t smem,
                      void* stream) {
  const qmm::gemv8::Args a{xq, static_cast<const int8_t*>(w), static_cast<const int8_t*>(sm), nullptr, nullptr,
                           static_cast<float*>(out), static_cast<float*>(ws), static_cast<int*>(counters), M, K, N,
                           group, bk, 0, 8, 0, 0, rows, splits, tps};
  return static_cast<int>(qmm::gemv8::launch<int8_t>(a, warps, grid_x, smem, static_cast<cudaStream_t>(stream)));
}
"""


def build() -> dict:
    procs = {}
    for name, (ring, swaps, _) in VARIANTS.items():
        s = (CSRC / "qmm_gemv8.cuh").read_text()
        for old, new in [('#include "qmm_common.cuh"', f'#include "{CSRC / "qmm_common.cuh"}"'),
                         (RING, f"constexpr int kRing = {ring};")] + swaps:
            assert s.count(old) == 1, old
            s = s.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "header.cuh").write_text(s)
        (d / "wrapper.cu").write_text(WRAPPER)
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                                        str(d / "wrapper.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(log)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_size_t, ctypes.c_void_p]
        lib.launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def plan_for(m, k, n, group, sms, splits=None):
    """int8_loop_plan, or a plan with ``splits`` k-splits and the most warps that fit."""
    plan = dict(int8_loop_plan(m, k, n, group, sms=sms))
    if splits is not None:
        nk = n_tiles(k)
        tps = -(-nk // splits)
        warps = max(w for w in range(fq.LOOP_MIN_WARPS, fq.LOOP_MAX_WARPS + 1)
                    if fq.smem_bytes(w, plan["rows"], k, group) <= fq.LOOP_SMEM)
        items = -(-n // LOOP_COLS)
        plan.update(splits=-(-nk // tps), tps=tps, warps=warps, ws_floats=items * nk * plan["rows"] * LOOP_COLS,
                    counters=items)
    return plan


def main():
    dev = torch.device("cuda", 0)
    libs = build()
    sms = _build.sm_count(dev)
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    failures = []
    for label, k, n, group in SHAPES:
        w, sm, _ = site(k, n, group, gen, dev)
        xq = torch.randint(-127, 128, (4, k), generator=gen, device=dev, dtype=torch.int8)
        want = packed_qmm_ref(xq, w, sm, decode="int8", group=group)
        nbytes = k * n + (k // group) * n + xq.numel() + 4 * n * 4
        runs = [(name, None) for name in VARIANTS] + [(name, sp) for name in ("base", "load_only") for sp in SPLITS
                                                      if sp <= n_tiles(k)]
        for name, sp in runs:
            ring = VARIANTS[name][0]
            plan = plan_for(4, k, n, group, sms, sp)
            smem = plan["warps"] * ring * (LOOP_STAGE_K + -(-LOOP_STAGE_K // group)) * LOOP_COLS + \
                plan["rows"] * loop_x_stride(k)
            if smem > fq.LOOP_SMEM:
                print(f"{label}: {name} needs {smem} bytes: skipped", flush=True)
                continue
            ws = torch.empty(max(1, plan["ws_floats"]), dtype=torch.float32, device=dev)
            counters = torch.zeros(max(1, plan["counters"]), dtype=torch.int32, device=dev)
            out = torch.empty((4, n), dtype=torch.float32, device=dev)

            def fn():
                err = libs[name].launch(xq.data_ptr(), w.data_ptr(), sm.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                        counters.data_ptr(), 4, k, n, group, min(512, k), plan["rows"],
                                        plan["splits"], plan["tps"], plan["warps"], plan["grid_x"], smem, stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")

            fn()
            torch.cuda.synchronize()
            note = ""
            if VARIANTS[name][2]:
                same = torch.equal(out.view(torch.int32), want.view(torch.int32))
                note = " bit-exact" if same else " DIFFERS"
                if not same:
                    failures.append(f"{label} {name} splits {plan['splits']}")
            ms = timer(fn)
            print(f"{label} K={k} N={n} M=4 {name}{'' if sp is None else ' (splits forced)'}: "
                  f"warps {plan['warps']} splits {plan['splits']} ring {ring}: {ms:.4f} ms, "
                  f"{nbytes / ms / 1e9:.3f} TB/s{note}", flush=True)
        ms = timer(lambda: torch.sum(w.view(torch.int64)))
        print(f"{label}: torch.sum over the weights as int64 {ms:.4f} ms, {k * n / ms / 1e9:.3f} TB/s", flush=True)
        del w, sm
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if failures:
        raise SystemExit(f"variants differ from the plain version: {failures}")


if __name__ == "__main__":
    main()
