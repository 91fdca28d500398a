"""Builds the port's native sources into shared libraries with a plain C
interface, loaded with ctypes: the CUDA kernels (``.cu``) with nvcc, the
host payload codec and the resident batch's order engine and id map
(``.cpp``) with g++.

Each source compiles on its own (one compiler process per source, all
started together) into ``build/torch_kernels/`` at the repository root,
named by a hash of the source, every local header it includes
(``#include "..."``, followed recursively) and the flags, so an
unchanged source is not rebuilt and ``python3 chip_smoke.py`` alone
builds everything it runs.  A library is built at its first use
(``library``) or by ``build_all``; nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from .errors import KernelBuildError

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
SOURCES: Dict[str, Path] = {
    "list_rank": PKG_DIR / "csrc" / "list_rank.cu",
    "sparse_rank": PKG_DIR / "csrc" / "sparse_rank.cu",
    "tree_replay": PKG_DIR / "csrc" / "tree_replay.cu",
    "seq_codec": PKG_DIR / "native" / "seq_codec.cpp",
    "order_idmap": PKG_DIR / "native" / "order_idmap.cpp",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the CUDA kernels")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise KernelBuildError("g++ not found on PATH: cannot build the host codec")


def _flags(name: str) -> List[str]:
    """Compiler flags of one source, by its suffix (.cu: nvcc, else g++)."""
    return NVCC_FLAGS if SOURCES[name].suffix == ".cu" else GXX_FLAGS


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
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Dict[str, object]]:
    """Compile every source (or those of `names`) whose library is
    missing, in parallel.  Returns {name: {"path", "seconds", "log"}};
    raises KernelBuildError with the compiler's output when a build fails
    or a compiler cannot start."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        compiler = _nvcc() if SOURCES[name].suffix == ".cu" else _gxx()
        cmd = [compiler, *_flags(name), "-o", str(tmp), str(SOURCES[name])]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            for started, _tmp, _out in procs.values():  # leave no compiler running
                started.kill()  # tpulint: disable=LT-TUNNEL(kills only an nvcc/g++ compiler this build started; a compiler holds no device work)
                started.wait()
            raise KernelBuildError(f"cannot start {compiler} for {name}: {e}") from e
        procs[name] = (proc, tmp, out)
    report: Dict[str, Dict[str, object]] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} ({Path(proc.args[0]).name} rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"path": str(out), "seconds": seconds, "log": log}
    if failed:
        raise KernelBuildError("native build failed: " + "\n".join(failed))
    for name in names:
        report.setdefault(name, {"path": str(_target(name)), "seconds": 0.0, "log": _cached_log(name)})
    return report


def _cached_log(name: str) -> Optional[str]:
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else None


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for one source, built at first use
    (thread-safe: decode threads may ask for it at once).  Raises
    KernelBuildError when it cannot be built or loaded."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all([name])
            path = _target(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _loaded[name] = lib
    return lib
