"""Build and load the CUDA kernels (route (b): nvcc → shared library →
ctypes).

Each ``csrc/<name>.cu`` compiles on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/repro_torch/<name>-<hash>.so`` at the repository root (the
hash covers the source and the flags, so an edited kernel rebuilds).
Every source exposes plain C functions that launch on the stream they
are given and return ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception.

Nothing here runs at import: the CPU tests import every module, and this
machine-independent part only needs ``nvcc`` when a kernel is launched.
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
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/_build.py → the repository root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("mxint_matmul", "decode_attention", "flash_attention",
           "mxint_quantize")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, object] = {}


class _BuildSeconds:
    """Wall seconds this process has spent waiting on ``nvcc`` (the
    serving telemetry's ``compile_seconds_<entry>``: the port's
    counterpart of an XLA compile)."""
    total = 0.0


BUILD_SECONDS = _BuildSeconds()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "CUDA kernels build only on a machine with the toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha1()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that are not built yet, one ``nvcc``
    per source, all started together. Returns wall seconds per source
    built; raises with the compiler's output if any build fails. The
    ``-Xptxas -v`` register/shared-memory report is kept beside each
    library as ``<name>.ptxas.txt``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)))
    took: Dict[str, float] = {}
    failed: List[str] = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.ptxas.txt").write_bytes(log)
        if proc.returncode:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n"
                          + log.decode(errors="replace"))
            continue
        os.replace(tmp, out)        # atomic: a concurrent loader never
        # sees a half-written library
    if procs:
        BUILD_SECONDS.total += time.perf_counter() - min(p[3] for p in procs)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def function(name: str, fn: str, n_ptrs: int, n_ints: int,
             n_floats: int = 0):
    """The launcher ``fn(ptr × n_ptrs, int × n_ints, float × n_floats,
    stream)`` of ``csrc/<name>.cu``, returning a CUDA error code; built
    and declared on first use. Pointers and the stream go as
    ``c_void_p``: the default conversion would cut a Python int to 32
    bits."""
    key = (name, fn)
    f = _FNS.get(key)
    if f is None:
        f = getattr(library(name), fn)
        f.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                      + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        _FNS[key] = f
    return f


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"(cudaGetLastError)")
