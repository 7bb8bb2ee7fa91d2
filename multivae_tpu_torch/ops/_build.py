"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/lib<name>_<hash>.so`` under the
checkout root, where ``<hash>`` covers the source and the flags, so an edited
source builds anew. A build that fails raises with the compiler's output;
nothing falls back. Only the functions that launch a kernel call in here,
never an import, so the CPU tests import every module without a toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


class BuildResult(NamedTuple):
    path: Path
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output (ptxas registers/spills), "" if cached


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on the PATH)")


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source, every shared header
    of ``csrc/`` and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_kernel(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    so = library_path(name)
    if so.exists():
        return BuildResult(so, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return BuildResult(so, seconds, proc.stdout + proc.stderr)


def build_kernels(names) -> Dict[str, BuildResult]:
    """Build several sources at once, one ``nvcc`` process each."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build_kernel, names)))


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_kernel(name).path))
        _LOADED[name] = lib
    return lib
