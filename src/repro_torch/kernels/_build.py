"""Build the CUDA sources under ``src/repro_torch/csrc`` on first use.

Each ``<name>.cu`` compiles with nvcc into ``build/kernels/lib<name>-<hash>.so``
at the repository root (a directory ``.gitignore`` lists) and loads through
ctypes: a plain C interface, no PyTorch headers, so a build takes seconds.
The file name carries a hash of the source, the shared headers and the
flags, so an edited source rebuilds and an unchanged one is reused.
``build_all`` starts one nvcc per source at once and waits for all of them;
each nvcc splits its device compilation over the host's cores
(``-split-compile=0``: the template-heavy qdense sources took ~230 s alone,
~90 s split, on the 8 cores beside the H100).

Every kernel entry counts its launches (``counted``, ``count_launch``), so a
run can show that its path went through the kernels.  Kernels that combine
their blocks' partials in one launch share the zeroed arrival counters of
``arrival_counters``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("fused_qmm", "packed_qmm", "quantize_rows", "flash_attend", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "--fmad=false", "-split-compile=0", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# The quantized dense kernels take M <= GEMV_MAX_ROWS rows with their GEMV
# kernels and more with the tensor-core tile; the launch counts split there.
GEMV_MAX_ROWS = 8

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Popen of the nvcc call for ``name``, or None when already built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic publish: a reader never sees half a file
    out.with_suffix(".log").write_text(log)
    return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source not yet built, all nvcc processes at once.
    Returns {name: compiler log} (empty for sources already built)."""
    names = list(names)
    started: List = [_start(n) for n in names]
    return {n: _finish(n, s) for n, s in zip(names, started)}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(lib_path(name)))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def counted(entry):
    """Give a kernel entry its launch counts: ``launches`` and
    ``mode_launches`` by rows, "m<=8" (the GEMV kernels) | "m>8" (the
    tensor-core tile)."""
    entry.launches = 0
    entry.mode_launches = Counter()
    return entry


def count_launch(entry, x) -> None:
    """One launch on ``entry`` if ``x`` lies on the card (the wrapper then
    launched the kernel or raised; a CPU tensor ran the plain version).
    The mode goes by x's rows, an expert's rows for (E, C, K) x."""
    if x.is_cuda:
        entry.launches += 1
        entry.mode_launches["m<=8" if x.shape[-2] <= GEMV_MAX_ROWS else "m>8"] += 1


_COUNTERS: Dict = {}  # (device, stream) -> zeroed int32 arrival counters, reset by the kernels after use


def arrival_counters(dev, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for kernels on ``stream``: the
    last block of a group to arrive (atomicAdd) combines and resets its
    counter, so kernels that follow on the stream find zeros again."""
    c = _COUNTERS.get((dev, stream))
    if c is None or c.numel() < n:
        c = _COUNTERS[(dev, stream)] = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
    return c


@functools.cache
def sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count
