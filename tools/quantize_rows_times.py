"""quantize_rows on the card: the package's kernel beside the two-pass one
it replaced (one block a row, the row read twice), a plain ``x.to(torch.int8)`` over the
same x (a one-pass elementwise kernel of PyTorch's: read x, write a byte
an element), the package's kernel on other splits of the row (cs blocks a
row) and an empty kernel (the timer's floor), at the decode tick's,
a prefill chunk's and the MoE capacity buffers' shapes.

    python3 tools/quantize_rows_times.py

Needs a card and nvcc.  CUDA events around one call, 256 MB of device
memory written and a device-side sleep before each (chip_smoke.py's timer),
20 calls a row, the four timed in turns (two-pass, package, package, two-pass).
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import quantize as qr  # noqa: E402
from repro_torch.kernels.quantize import quantize_rows, quantize_rows_plain, rows_plan  # noqa: E402

SHAPES = [(4, 4096, torch.bfloat16), (256, 12288, torch.bfloat16), (64, 6144, torch.bfloat16),
          (64, 32768, torch.float32), (1024, 7168, torch.bfloat16), (1024, 4864, torch.float32)]


def timer(flush, fn, iters=20) -> float:
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out = ROOT / "build" / "quantize_rows_two_pass" / "libquantize_rows_two_pass.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = ROOT / "tools" / "quantize_rows_two_pass.cu"
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)], capture_output=True, text=True)
    if log.returncode:
        raise SystemExit(log.stdout + log.stderr)
    old = ctypes.CDLL(str(out))
    old.quantize_rows_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    old.empty_launch.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    print(f"empty kernel: {timer(flush, lambda: old.empty_launch(stream)):.4f} ms", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, d, dtype in SHAPES:
        x = (torch.randn((m, d), generator=gen, device=dev) * 0.1).to(dtype)
        q = torch.empty((m, d), dtype=torch.int8, device=dev)
        e = torch.empty((m, 1), dtype=torch.int32, device=dev)

        def two_pass():
            err = old.quantize_rows_launch(int(dtype == torch.bfloat16), x.data_ptr(), q.data_ptr(), e.data_ptr(), m, d,
                                           8, stream)
            if err:
                raise SystemExit(f"two-pass kernel: cudaError_t {err}")

        ms = {"two-pass": [], "new": []}
        for which in ("two-pass", "new", "new", "two-pass"):
            ms[which].append(timer(flush, two_pass if which == "two-pass" else lambda: quantize_rows(x)))
        cast = timer(flush, lambda: x.to(torch.int8))
        lib = qr._lib()
        plans = {}
        vecs = d * x.element_size() // 16
        for cs in (1, 2, 4, 8):  # other splits of the row, each at the fewest loads a thread that hold it
            nv = -(-(-(-vecs // cs)) // 256)
            if 1 <= nv <= 8:
                def other(cs=cs, nv=nv):
                    err = lib(int(dtype == torch.bfloat16), x.data_ptr(), q.data_ptr(), e.data_ptr(), m, d, 8, cs, nv,
                              stream)
                    if err:
                        raise SystemExit(f"cs {cs}: cudaError_t {err}")
                plans[f"cs {cs} nv {nv}"] = round(timer(flush, other), 4)
        nbytes = x.numel() * x.element_size() + m * d + m * 4
        wq, we = quantize_rows_plain(x)
        nq, ne = quantize_rows(x)
        torch.cuda.synchronize()
        same = torch.equal(q, wq) and torch.equal(e, we) and torch.equal(nq, wq) and torch.equal(ne, we)
        print(f"({m}, {d}) {str(dtype)[6:]} plan {rows_plan(m, d, x.element_size())}: package {ms['new']} ms, two-pass "
              f"{ms['two-pass']} ms, x.to(int8) {cast:.4f} ms, other plans {plans}, "
              f"byte bound {nbytes / 3.35e12 * 1e3:.5f} ms; "
              f"both equal the plain version: {same}", flush=True)


if __name__ == "__main__":
    main()
