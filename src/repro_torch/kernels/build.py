"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``.cu`` file under ``kernels/*/csrc/`` with a plain C
interface (no PyTorch headers, so a build takes seconds); device code
shared by several kernels sits in headers under ``kernels/csrc/``.  It
compiles for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -I kernels/csrc -o <lib>.so <source>.cu

into ``build/repro_torch_kernels/`` at the repository root, keyed by a hash
of the source, the shared headers and the flags, so an edited source
rebuilds and an unchanged one loads from the cache.  ``ptxas``'s
register/shared-memory report is kept beside each library (``<lib>.log``).  Nothing here runs at import:
the first wrapper call on a CUDA tensor builds what it needs, and
:func:`build` starts several sources' ``nvcc`` at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

_HERE = Path(__file__).resolve().parent
REPO_ROOT = _HERE.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"

SOURCES = {
    "paged_decode_attention": _HERE / "decode_attention" / "csrc" / "paged_decode_attention.cu",
    "ragged_ffn": _HERE / "moe_dropless" / "csrc" / "ragged_ffn.cu",
    "moe_ffn": _HERE / "moe_ffn" / "csrc" / "moe_ffn.cu",
    "flash_attention": _HERE / "flash_attention" / "csrc" / "flash_attention.cu",
}
# headers shared by several sources (``#include "<name>.cuh"``)
INCLUDE_DIR = _HERE / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}   # one handle per library per process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Cache key: the source, every shared header, and the flags."""
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile ``names`` (default: every kernel), one ``nvcc`` per source,
    all started together.  Returns ``{name: ptxas report}``; raises with
    the compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    procs = {}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in todo:
        lib = library_path(name)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        with open(lib.with_suffix(".log"), "w") as log:
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp), str(SOURCES[name])],
                stdout=log, stderr=subprocess.STDOUT), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        if proc.wait() == 0:
            os.replace(tmp, lib)
        else:
            failed.append(name)
    logs = {n: library_path(n).with_suffix(".log") for n in names}
    reports = {n: p.read_text() if p.exists() else "" for n, p in logs.items()}
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(reports[n] for n in failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if it is not cached."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
