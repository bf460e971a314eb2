"""Builds the CUDA sources under ``kernels/csrc/`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by its
own ``nvcc`` process into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout (``.gitignore`` lists ``build/``); all the processes start
together, so the build takes as long as the slowest source.  The hash
covers the source, every ``csrc`` header it includes (``#include
"name.cuh"``, followed into the headers' own includes) and the flags, so
an edited source or header is rebuilt and an unchanged one is loaded as
it is.  The libraries are loaded with
``ctypes``.  Nothing here runs at import time: the CPU tests import every
module of the port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def sources() -> Dict[str, Path]:
    """Every kernel source, keyed by its stem."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_includes(src: Path) -> list:
    """The headers beside ``src`` that it includes with quotes, directly or
    through other such headers, in first-seen order."""
    seen, todo = [], [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_bytes()):
            dep = src.parent / name.decode()
            if dep.is_file() and dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def library_path(src: Path) -> Path:
    """Where the library built from ``src`` lives (content-addressed: the
    source, the headers it includes and the flags)."""
    h = hashlib.sha256(src.read_bytes())
    for dep in local_includes(src):
        h.update(dep.name.encode() + b"\0" + dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no library yet (one ``nvcc`` per
    source, all started together), then load all of them.  Raises with
    the compiler's output when a build fails."""
    with _LOCK:
        srcs = sources()
        if set(_LIBS) == set(srcs):
            return _LIBS
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name, src in srcs.items():
            out = library_path(src)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            log = out.with_suffix(".log")
            with open(log, "w") as fh:
                proc = subprocess.Popen(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=fh, stderr=subprocess.STDOUT)
            jobs.append((name, out, tmp, log, proc))
        failed = []
        for name, out, tmp, log, proc in jobs:
            if proc.wait() != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                              + log.read_text())
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for name, src in srcs.items():
            _LIBS[name] = ctypes.CDLL(str(library_path(src)))
        return _LIBS


def library(name: str, functions: Dict[str, tuple] | None = None
            ) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on demand).
    ``functions`` maps C function names to (argument types, return type),
    set on the library's functions at the first call (without argument
    types ctypes passes every int as a 32-bit C int)."""
    lib = build_all()[name]
    if functions:
        with _LOCK:
            for fname, (args, res) in functions.items():
                fn = getattr(lib, fname)
                if fn.argtypes is None:
                    fn.argtypes, fn.restype = args, res
    return lib


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas=-v`` register and spill report) of
    the last build of ``csrc/<name>.cu``, or '' when it was not built here."""
    log = library_path(sources()[name]).with_suffix(".log")
    return log.read_text() if log.exists() else ""
