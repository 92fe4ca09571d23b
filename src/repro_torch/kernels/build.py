"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``.cu`` file under ``kernels/*/csrc/`` with a plain C
interface (no PyTorch headers, so a build takes seconds); device code
shared by several kernels sits in headers under ``kernels/csrc/``.  A
library whose instantiations take long to compile has more translation
units (``EXTRA_SOURCES``), each compiled by its own ``nvcc`` beside the
others.  It compiles for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -Xptxas -v -I kernels/csrc -c -o <unit>.o <unit>.cu        (each unit)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib>.so <unit>.o ...

into ``build/repro_torch_kernels/`` at the repository root, keyed by a hash
of the sources, the shared headers and the flags, so an edited source
rebuilds and an unchanged one loads from the cache.  ``ptxas``'s
register/shared-memory report (the units' in order) is kept beside each
library (``<lib>.log``).  Nothing here runs at import: the first wrapper
call on a CUDA tensor builds what it needs, and :func:`build` starts every
unit's ``nvcc`` at once.
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
    "quantized_paged_decode_attention": (_HERE / "decode_attention" / "csrc"
                                         / "quantized_paged_decode_attention.cu"),
    "decode_attention": _HERE / "decode_attention" / "csrc" / "decode_attention.cu",
    "ragged_ffn": _HERE / "moe_dropless" / "csrc" / "ragged_ffn.cu",
    "ragged_combine": _HERE / "moe_dropless" / "csrc" / "ragged_combine.cu",
    "moe_ffn": _HERE / "moe_ffn" / "csrc" / "moe_ffn.cu",
    "flash_attention": _HERE / "flash_attention" / "csrc" / "flash_attention.cu",
}
# more translation units of a library: the ragged FFN's widest tiles (96 and
# 128 rows; 192), whose persistent kernels take the longest to compile
EXTRA_SOURCES = {
    "ragged_ffn": [_HERE / "moe_dropless" / "csrc" / f"ragged_ffn_n{n}.cu" for n in (128, 192)],
}
# headers shared by several sources (``#include "<name>.cuh"``)
INCLUDE_DIR = _HERE / "csrc"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def units(name: str) -> list:
    """The translation units of library ``name``: its source, then any more."""
    return [SOURCES[name], *EXTRA_SOURCES.get(name, [])]


def library_path(name: str) -> Path:
    """Cache key: the sources, every shared header, and the flags."""
    digest = hashlib.sha256()
    for source in units(name):
        digest.update(source.read_bytes())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile ``names`` (default: every kernel), one ``nvcc`` per
    translation unit, all started together, then link each library.
    Returns ``{name: ptxas report}``; raises with the compiler's output if
    any build fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    procs = {}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in todo:
        lib = library_path(name)
        compiles = []
        for i, src in enumerate(units(name)):
            obj, log = (lib.with_suffix(f".{i}.{os.getpid()}{ext}") for ext in (".o", ".log"))
            with open(log, "w") as out:
                compiles.append((subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-c", "-o", str(obj), str(src)],
                    stdout=out, stderr=subprocess.STDOUT), obj, log))
        procs[name] = (nvcc, lib, compiles)
    failed = []
    for name, (nvcc, lib, compiles) in procs.items():
        ok = all([proc.wait() == 0 for proc, _, _ in compiles])
        with open(lib.with_suffix(".log"), "w") as out:     # the units' reports, in order
            for _, _, log in compiles:
                out.write(log.read_text())
                log.unlink()
        if ok:
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            with open(lib.with_suffix(".log"), "a") as out:
                ok = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                                     *(str(obj) for _, obj, _ in compiles)],
                                    stdout=out, stderr=subprocess.STDOUT).returncode == 0
            if ok:
                os.replace(tmp, lib)
        for _, obj, _ in compiles:
            obj.unlink(missing_ok=True)
        if not ok:
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
