"""Build the port's CUDA kernels with `nvcc` and load them with `ctypes`.

Each source under ``repro_torch/csrc/`` is one shared library with a
plain C interface (no PyTorch headers, so `nvcc` takes seconds, not
minutes).  Libraries are built at first use into ``build/kernels/`` at
the root of the checkout, named by a digest of the source and the flags,
so an edited source rebuilds and an unchanged one is loaded as it is.
`build()` starts one `nvcc` per missing library, all at once, and waits
for them together.  Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("scan_chunk", "coupled_chunk", "flash_attention",
           "flash_attention_bwd", "rmsnorm",
           "moe_gemm", "xent", "xent_bwd", "decode_attention", "ssm_scan",
           "selective_scan", "objective_scan", "fleet_objective")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: `ptxas -v` report (registers, spills, shared memory) of each build
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (``PATH`` first, then the toolkit's)."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return path


def target(name: str) -> Path:
    """The shared library a source builds into (digest of the source, the
    shared headers and the flags)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library in `names` that is not built yet, one `nvcc`
    process per source, all started together.  Returns the seconds each
    build took (0.0 for a library that was already there)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    took = {}
    for name in names:
        out = target(name)
        if out.exists():
            took[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the launch plans'
    `sms`)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(target(name)))
    return lib
