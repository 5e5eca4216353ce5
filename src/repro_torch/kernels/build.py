"""Build and load the port's CUDA kernels.

Each kernel is one `.cu` file with a plain C interface under
`repro_torch/kernels/<name>/csrc/<name>.cu`; the TMA/wgmma kernels also
include the shared `repro_torch/kernels/hopper.cuh`.  It is compiled with
`nvcc` for `sm_90a` into `build/kernels/lib<name>-<hash>.so` at the
repository root (the hash is over the source, the shared headers and the
flags, so an edited source or header rebuilds) and loaded with `ctypes`.
Nothing is built when a module is imported: the first launch builds, or a
caller builds every kernel at once with `build_all()`, one `nvcc` process
per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NAMES = ("paged_attention", "flash_attention", "delta_apply", "pulse_count",
         "crossbar_mvm")

_loaded: Dict[str, ctypes.CDLL] = {}


def source(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers (`*.cuh`, which sources include) and the flags."""
    h = hashlib.sha1(source(name).read_bytes())
    for header in sorted(KERNELS_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def log_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.log"


def _start(name: str) -> subprocess.Popen:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(log_path(name), "w")
    try:
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def build_all(names: Sequence[str] = NAMES) -> List[Path]:
    """Compile every kernel whose library is missing, all in parallel;
    returns the library paths.  Raises with the compiler's log when a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: _start(n) for n in names if not library_path(n).exists()}
    failed = []
    for name, proc in procs.items():
        rc = proc.wait()
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        if rc == 0:
            os.replace(tmp, library_path(name))
        else:
            failed.append(f"{name} (exit {rc}):\n{log_path(name).read_text()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return [library_path(n) for n in names]


def launch_error(err: int) -> str:
    """A kernel library's nonzero return code in words: a cudaError_t, or
    100000 + the CUresult of a TMA tensor map CUDA refused to encode."""
    if err >= 100000:
        return f"tensor map refused, CUresult {err - 100000}"
    return f"cudaError {err}"


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
