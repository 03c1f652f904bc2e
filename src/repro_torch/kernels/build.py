"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `kernels/csrc/` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for Hopper only:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC [extra flags] -o build/kernels/lib<name>_<hash>.so

into `build/kernels/` at the repository root, at first use. The file
name carries a hash of the source, the headers under `csrc/` (`*.cuh`)
and the flags, so an edited source or header is rebuilt and never mixed
up with an old library. `build_all` starts one nvcc per source at once
and waits for all of them. A failed build
raises with nvcc's output; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel name -> (source file, extra nvcc flags)
SOURCES = {
    "contention": ("contention.cu", []),
    # the walk's float updates must round like the plain version: no
    # fused multiply-add contraction
    "walk": ("walk.cu", ["-fmad=false"]),
    # the max-min levels and residuals must round like the plain version
    "maxmin": ("maxmin.cu", ["-fmad=false"]),
    # the SSD scan is held to a float tolerance, not bit for bit
    "ssd_scan": ("ssd_scan.cu", []),
    # its backward (K8) likewise
    "ssd_scan_bwd": ("ssd_scan_bwd.cu", []),
    # attention is held to a float tolerance too
    "flash_attention": ("flash_attention.cu", []),
    # its backward (K7) likewise
    "flash_attention_bwd": ("flash_attention_bwd.cu", []),
    # the prefix sums' adds are all __fadd_rn: exact whatever the flags
    "prefix_sum": ("prefix_sum.cu", []),
}

_loaded: dict = {}
# the kernels this process has compiled, in build order (the sanitizer
# `analysis.sanitize.assert_no_recompiles` counts new entries)
built: list = []
# wall seconds this process has spent waiting on nvcc (`build_all`), so
# that a first run's time can report its kernel builds apart
build_seconds = 0.0


def check(t, name: str, shape, dtype, device) -> None:
    """Raise ValueError unless `t` has the shape, dtype and device a
    kernel's C interface expects (a raw pointer carries none of them)."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def checked(t, name: str, shape, dtype, device):
    """`t` made contiguous, after `check`."""
    check(t, name, shape, dtype, device)
    return t.contiguous()


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else the toolkit's default
    install location; raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src, flags = SOURCES[name]
    h = hashlib.sha256((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(ARCH + BASE_FLAGS + flags).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None, *, ptxas_info: bool = False) -> dict:
    """Compile every missing library of `names` (default: all), one
    nvcc process per source, all started together. Returns
    {name: nvcc output} for the sources built now (with `ptxas_info`,
    nvcc prints each kernel's registers and shared memory)."""
    global build_seconds
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        src, flags = SOURCES[n]
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH, *BASE_FLAGS, *flags,
               *(["-Xptxas", "-v"] if ptxas_info else []),
               "-o", str(tmp), str(CSRC / src)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    logs, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        text, _ = p.communicate()
        logs[n] = text
        if p.returncode != 0:
            failed.append(f"{n} (exit {p.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            built.append(n)
    build_seconds += time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


__all__ = ["SOURCES", "BUILD_DIR", "build_all", "check", "checked", "load",
           "library_path", "nvcc_path"]
