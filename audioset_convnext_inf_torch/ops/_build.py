"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` (Hopper) into a shared library under
``build/torch_kernels/`` at the root of the checkout. The library's file
name carries a hash of the source, of every header it includes from
``csrc/`` (``#include "..."``, followed through headers that include
others) and of the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is. A build may add ``-D`` macros
(``defines``, e.g. ``("ABLATE_STENCIL",)``); they are part of the flags and
so of the name. The package itself defines none; only
``scripts/ablate_fused_block_torch.py`` does. ``nvcc`` is found through
``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda/bin``; without it, building
raises. ``use_library`` runs a kernel from a library built elsewhere (a
serving bundle carries the one it was exported with,
``engine/aot_export.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> Optional[str]:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and, in the order first met, every file of
    ``csrc/`` it includes by ``#include "..."``, directly or through another
    header. Quoted includes that are not in ``csrc/`` are the toolkit's."""
    csrc = CSRC.resolve()
    found: List[Path] = []
    todo = [csrc / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            dep = (path.parent / inc).resolve()
            if dep.is_file() and dep.parent == csrc:
                todo.append(dep)
    return found


def _flags(defines: Sequence[str]) -> List[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, defines: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` with ``defines`` unless its library is
    built already. The compiler's report (registers, shared memory, spills)
    goes to a ``.log`` file beside the library."""
    out = library_path(name, defines)
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): cannot build kernel {name!r}"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *_flags(defines), "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True,
        )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name!r}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


_PINNED: Dict[str, Path] = {}  # kernel name -> the library file to load instead of its build


def use_library(name: str, path) -> bool:
    """Run kernel ``name`` from the built library ``path`` (a serving
    bundle's copy). Where the package's own build has the same file name
    (the name carries the hash of the sources and flags), the two are one
    library: the build is used, installed from ``path`` if it is not built
    yet, and nothing is pinned. Otherwise ``name`` is pinned to ``path``
    for every caller for the rest of the process, which is logged. A
    missing file raises, and so does another file for a pinned kernel.
    Returns whether ``name`` is pinned."""
    path = Path(path).resolve()
    if not path.is_file():
        raise FileNotFoundError(f"kernel library {path} not found")
    held = _PINNED.get(name)
    if held is not None:
        if held.name != path.name:
            raise RuntimeError(f"kernel {name!r} is pinned to {held}, not {path}")
        return True
    own = library_path(name) if (CSRC / f"{name}.cu").is_file() else None
    if own is not None and own.name == path.name:
        if not own.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            shutil.copyfile(path, tmp)
            os.replace(tmp, own)
        return False
    _PINNED[name] = path
    logging.getLogger(__name__).warning(
        "kernel %r runs from %s for the rest of the process, not from this package's build %s",
        name, path, own.name if own is not None else "(no sources)")
    return True


def library(name: str, defines: Sequence[str] = ()) -> Path:
    """The library file kernel ``name`` loads from: its pinned file, else
    its build with ``defines`` (built if needed, once per process: the
    hash of the sources is not taken again at each launch). A pinned kernel
    takes no ``defines``."""
    if name in _PINNED:
        if defines:
            raise RuntimeError(f"kernel {name!r} is pinned to {_PINNED[name]}: no -D builds")
        return _PINNED[name]
    return _build_once(name, tuple(defines))


@lru_cache(maxsize=None)
def _build_once(name: str, defines: Sequence[str]) -> Path:
    return build(name, defines)


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Load ``library(name, defines)``, once per process and file. Each
    kernel launch calls this."""
    return _open(str(library(name, defines)))


@lru_cache(maxsize=None)
def _open(path: str) -> ctypes.CDLL:
    return ctypes.CDLL(path)
