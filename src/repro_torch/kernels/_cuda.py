"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each ``.cu`` source is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so
a build takes seconds. Builds run at first use (or all at once, in
parallel, through :func:`build_all`) into a directory keyed by the
sources' content hash; a later process reuses a finished build.

Nothing here runs at import time: the CPU-only test environment imports
every module of the package and never reaches a build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

__all__ = ["SMEM_LIMIT", "SOURCES", "LAUNCHES", "BUILDS",
           "reset_launch_counts", "count_launch", "build_all", "load",
           "check", "stream_ptr", "build_dir"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"

#: dynamic shared memory one block may opt into on an H100 (227 KB)
SMEM_LIMIT = 232448

#: kernel library -> its source under ``csrc/``
SOURCES = {"mgs_matmul": "mgs_matmul.cu",
           "mgs_attention": "mgs_attention.cu",
           "mgs_dmac": "mgs_dmac.cu"}

#: launches per kernel wrapper, counted where the wrapper launches
LAUNCHES: Dict[str, int] = {"mgs_matmul_exact_fused": 0,
                            "mgs_matmul_exact_fused_stationary": 0,
                            "mgs_matmul_exact": 0,
                            "mgs_matmul_exact_partials": 0,
                            "mgs_matmul_stationary_partials": 0,
                            "mgs_matmul_exact_flush": 0,
                            "mgs_matmul_dmac": 0,
                            "mgs_flash_attention": 0}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false"]

#: ``nvcc`` runs of this process (serving after warm-up must keep it flat)
BUILDS = {"nvcc": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# the replica fleet's workers launch from several threads at once
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """Count one launch of kernel wrapper ``name`` (thread-safe)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*")):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR``, else ``build/kernels`` of the checkout."""
    root = os.environ.get("REPRO_TORCH_BUILD_DIR")
    base = Path(root) if root else CSRC.parents[2] / "build" / "kernels"
    return base / _hash()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
        cand = home / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH): the "
                           "Hopper kernels are built from csrc/ at first use")
    return nvcc


def build_all(names: Optional[Iterable[str]] = None, *,
              verbose: bool = False) -> Dict[str, str]:
    """Compile the named kernel libraries, one ``nvcc`` each, all at once.

    Returns ``{name: compiler output}`` (``-Xptxas -v`` register and
    shared-memory report when ``verbose``). Raises on the first failure.
    """
    names = list(SOURCES if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        so = out_dir / f"lib{name}.so"
        if so.exists() and not verbose:
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / SOURCES[name])]
        BUILDS["nvcc"] += 1
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs = {}
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            so = build_dir() / f"lib{name}.so"
            if not so.exists():
                build_all([name])
            lib = ctypes.CDLL(str(so))
            _LIBS[name] = lib
    return lib


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a nonzero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
