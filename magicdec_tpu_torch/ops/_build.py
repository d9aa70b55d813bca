"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc and ctypes.

Each source compiles on its own into a shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<digest>.so csrc/<name>.cu

which takes seconds, where a build that includes PyTorch's headers takes
minutes. All sources build in parallel, one nvcc each, at first use. The
library name carries a digest of the sources and flags, so an edited source
is never served by a stale library. The build directory lies inside the
package and is listed in .gitignore; the sources in the checkout are the
only input.

Host sources (csrc/*.cpp, plain C++ with no CUDA: the wave buffer of
engine/wave_buffer.py) build the same way with g++ instead of nvcc:

    g++ -O3 -std=c++17 -fPIC -shared -pthread -o build/lib<name>-<digest>.so \
        csrc/<name>.cpp
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("flash_decode", "flash_prefill", "page_gather", "centroid_scores",
           "int4_matmul", "fused_block")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SOURCES = ("wave_buffer",)
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def _source(name: str) -> Path:
    return CSRC_DIR / (f"{name}.cpp" if name in HOST_SOURCES
                       else f"{name}.cu")


def _command(name: str, out: Path) -> list[str]:
    if name in HOST_SOURCES:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the host wave buffer "
                               "(csrc/wave_buffer.cpp) needs a C++ compiler")
        return [gxx, *GXX_FLAGS, "-o", str(out), str(_source(name))]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(_source(name))]


def lib_path(name: str) -> Path:
    host = name in HOST_SOURCES
    h = hashlib.sha256(" ".join(GXX_FLAGS if host else NVCC_FLAGS).encode())
    h.update(_source(name).read_bytes())
    if not host:
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> float:
    """Compile every named source whose library is missing, all at once;
    returns the wall seconds. Raises with the compiler's output if one
    fails. The ptxas report (registers, shared memory, spills) of each CUDA
    build is kept beside its library as a .log file."""
    t0 = time.perf_counter()
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = lib_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = _command(name, tmp)
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        if name not in _libs:
            build((name,))
            _libs[name] = ctypes.CDLL(str(lib_path(name)))
        return _libs[name]
