"""Builds the port's CUDA sources with nvcc into shared libraries with a
plain C interface, loaded with ctypes.

Each source compiles on its own (one nvcc process per source, all
started together) into ``build/torch_kernels/`` at the repository root,
named by a hash of the source, every local header it includes
(``#include "..."``, followed recursively) and the flags, so an
unchanged source is not rebuilt and ``python3 chip_smoke.py`` alone
builds everything it runs.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
SOURCES: Dict[str, Path] = {"list_rank": PKG_DIR / "csrc" / "list_rank.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the CUDA kernels")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _inputs(src: Path) -> List[Path]:
    """`src` and every local header it includes, directly or through
    another header (paths relative to the including file)."""
    seen: List[Path] = []
    todo = [src.resolve()]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        for inc in _LOCAL_INCLUDE.findall(f.read_bytes()):
            dep = (f.parent / inc.decode()).resolve()
            if dep.exists():
                todo.append(dep)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in _inputs(SOURCES[name]):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Dict[str, object]]:
    """Compile every source whose library is missing, in parallel.
    Returns {name: {"path", "seconds", "log"}}; raises RuntimeError with
    the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, src in SOURCES.items():
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    report: Dict[str, Dict[str, object]] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"path": str(out), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    for name in SOURCES:
        report.setdefault(name, {"path": str(_target(name)), "seconds": 0.0, "log": _cached_log(name)})
    return report


def _cached_log(name: str) -> Optional[str]:
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else None


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for one source, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
