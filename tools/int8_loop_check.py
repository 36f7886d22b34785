"""The int8 loop (``csrc/qmm_gemv8.cuh``) on the card, alone: builds the two
qdense libraries, holds the loop against its plain versions at every
family's lm_head shape and on the mx layer's sites, and times each shape on
the loop beside the GEMV on the same calls (``uses_int8_loop`` forced either
way: fused with the dynamic and a static exponent, packed) and
``torch.matmul`` on bf16 weights of the same shape.

  python3 tools/int8_loop_check.py [--quick]   # --quick: parity at M = 4 only, no timings

Weights are seeded random int8 codes and scale mantissas made on the card
(no quantizer pass: the loop's arithmetic does not depend on where the codes
came from).  Prints one line a case and, last, the card's name and power
limit.  Exits 1 on a parity failure or without a card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "src"), os.path.join(HERE, "..")]

import torch  # noqa: E402

from chip_smoke import _Timer as Timer  # noqa: E402
from chip_smoke import _ulps as ulps  # noqa: E402

HBM = 3.35e12
LM_HEADS = {  # family -> (K, N) of the int8 lm_head at the published widths (vocab padded to 256)
    "qwen3-8b": (4096, 152064), "phi4-mini-3.8b": (3072, 200192), "gemma3-12b": (3840, 262144),
    "qwen1.5-110b": (8192, 152064), "grok-1-314b": (6144, 131072), "arctic-480b": (7168, 32000),
    "falcon-mamba-7b": (4096, 65024), "zamba2-7b": (3584, 32000), "whisper-base": (512, 51968),
}
MX_SITES = [("wq", 4096, 4096), ("wk", 4096, 1024), ("wv", 4096, 1024), ("wo", 4096, 4096), ("gate", 4096, 12288),
            ("up", 4096, 12288), ("down", 12288, 4096)]


def site(k, n, group, gen, dev):
    w = torch.randint(-128, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    sm = torch.randint(-127, 128, (k // group, n), generator=gen, device=dev, dtype=torch.int8)
    return w, sm, torch.tensor([-9], dtype=torch.int32, device=dev)


class Route:
    """Force the int8 route of both wrappers: "loop", "gemv" or None (the plan's)."""

    def __init__(self, which):
        from repro_torch.kernels import fused_qmm as fq
        from repro_torch.kernels import packed_qmm as pq

        self.mods, self.saved, self.which = (fq, pq), fq.uses_int8_loop, which

    def __enter__(self):
        if self.which is not None:
            force = self.which == "loop"
            for mod in self.mods:
                mod.uses_int8_loop = lambda decode, *a, **kw: decode == "int8" and force

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.uses_int8_loop = self.saved


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int8_loop_check: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_qmm import fused_qmm, fused_qmm_ref, int8_loop_plan, uses_int8_loop
    from repro_torch.kernels.packed_qmm import packed_qmm, packed_qmm_ref
    from repro_torch.kernels.quantize import quantize_rows

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    logs = _build.build_all(("fused_qmm", "packed_qmm"))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in logs.items():
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "loop_kernel" in line:
                for follow in lines[i:i + 4]:
                    if "registers" in follow or "spill" in follow:
                        print(f"  {name}: {follow.strip()}", flush=True)
    sms = _build.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    failures = []
    timer = Timer(dev)

    def check(what, got, want):
        torch.cuda.synchronize()
        u = ulps(got, want)
        ok = u == 0 and bool(torch.isfinite(got).all())
        print(f"parity {what}: ulps {u} {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(what)

    cases = [(f"lm_head {fam}", k, n, 64) for fam, (k, n) in LM_HEADS.items()]
    cases += [(f"mx {name}", k, n, 32) for name, k, n in MX_SITES]
    for label, k, n, group in cases:
        w, sm, se = site(k, n, group, gen, dev)
        bias = torch.randn((n,), generator=gen, device=dev)
        for i, m in enumerate((4,) if args.quick else (1, 4, 8)):
            dtype = (torch.bfloat16, torch.float32)[i % 2]
            x = (torch.randn((m, k), generator=gen, device=dev) * 0.3).to(dtype)
            kw = dict(decode="int8", group=group, act_exponent=(None, -3)[i % 2], bias=bias if i == 2 else None,
                      act="silu" if i == 2 else None)
            plan = int8_loop_plan(m, k, n, group, sms=sms)
            route = "loop" if uses_int8_loop("int8", m, k, n, group, sms=sms) else "gemv"
            desc = (f"{label} K={k} N={n} M={m} {str(dtype)[6:]} [{route}; splits {plan['splits']} warps "
                    f"{plan['warps']} rows {plan['rows']}]")
            with Route("loop"):
                got = fused_qmm(x, w, sm, se, **kw)
                again = fused_qmm(x, w, sm, se, **kw)
            check(f"fused {desc}", got, fused_qmm_ref(x, w, sm, se, **kw))
            if plan["splits"] > 1:
                check(f"fused repeat {desc}", again, got)
            xq, _ = quantize_rows(x)
            with Route("loop"):
                got = packed_qmm(xq, w, sm, decode="int8", group=group)
            check(f"packed {desc}", got, packed_qmm_ref(xq, w, sm, decode="int8", group=group))
            del x, xq, got, again
        if not args.quick:
            x = (torch.randn((4, k), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
            xq, _ = quantize_rows(x)
            calls = {"fused": lambda: fused_qmm(x, w, sm, se, decode="int8", group=group),
                     "fused static": lambda: fused_qmm(x, w, sm, se, decode="int8", group=group, act_exponent=-3),
                     "packed": lambda: packed_qmm(xq, w, sm, decode="int8", group=group)}
            ms = {}
            for which in ("loop", "gemv", "loop", "gemv"):
                with Route(which):
                    for name, fn in calls.items():
                        ms.setdefault((which, name), []).append(timer(fn))
            wb = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
            lib = timer(lambda: torch.matmul(x, wb))
            del wb
            nbytes = k * n + (k // group) * n + x.numel() * 2 + 4 * n * 4
            plan = int8_loop_plan(4, k, n, group, sms=sms)
            taken = "loop" if uses_int8_loop("int8", 4, k, n, group, sms=sms) else "gemv"
            times = "; ".join(f"{which} {name} {v[0]:.4f} / {v[1]:.4f}" for (which, name), v in ms.items())
            print(f"time {label} K={k} N={n} M=4 (ms): {times}; torch.matmul bf16 {lib:.4f}; bound "
                  f"{nbytes / HBM * 1e3:.4f} (bytes); plan takes {taken}; loop plan splits {plan['splits']} "
                  f"warps {plan['warps']} units {plan['units']}", flush=True)
        del w, sm
        torch.cuda.empty_cache()
    print(smi, flush=True)
    if failures:
        raise SystemExit(f"int8_loop_check: {len(failures)} parity failures: {failures}")


if __name__ == "__main__":
    main()
