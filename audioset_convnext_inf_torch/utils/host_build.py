"""Build the port's host C++ libraries at first use, once for all processes.

The port keeps two libraries for the host: the audio data plane
(``csrc/audio_host.cpp``, ``utils/native.py``) and the FLAC decoder
(``csrc/flac_decode.cpp``, ``data/flac.py``). Each is compiled with the host
C++ compiler (``CXX``, else ``g++`` or ``c++`` on ``PATH``) into
``BUILD_DIR`` (``build/host_libs/`` at the root of the checkout, or the
directory ``utils/cache.py`` names). A library's file name carries a hash of
its flags and sources, as the kernels' do (``ops/_build.py``), so an
unchanged source is loaded as it is, from any checkout.

The build runs under an ``fcntl`` lock on a file beside the library and
links to a temporary name that ``os.replace`` moves into place: processes
that start together (pytest workers, loader processes) wait for one build
and never see a half-written library. A missing compiler or a failed build
raises; there is no fallback.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_libs"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")


def compiler(what: str) -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError(f"no C++ compiler (CXX, g++, c++): cannot build {what}")


def library_path(name: str, sources: Sequence[Path], flags: Sequence[str],
                 build_dir: Optional[Path] = None, link_flags: Sequence[str] = ()) -> Path:
    """``<build_dir>/lib<name>_<hash>.so``: the hash of the flags (compile,
    then link), then each source's bytes in order."""
    h = hashlib.sha256(" ".join([*flags, *link_flags]).encode() + b"\0")
    for src in sources:
        h.update(Path(src).read_bytes())
    return Path(build_dir or BUILD_DIR) / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[Path], flags: Sequence[str], what: str,
          build_dir: Optional[Path] = None, link_flags: Sequence[str] = ()) -> Path:
    """Compile ``sources`` into ``library_path(...)`` unless it is built
    already; ``what`` names the library in errors. Each source compiles to
    an object with ``flags -c``; one command links the objects with
    ``-shared`` and ``link_flags``."""
    out = library_path(name, sources, flags, build_dir, link_flags)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
        if out.exists():
            return out
        cxx = compiler(what)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
        cmds = [[cxx, *flags, "-c", str(src), "-o", obj] for src, obj in zip(sources, objs)]
        cmds.append([cxx, *objs, "-shared", "-o", tmp, *link_flags])
        try:
            for cmd in cmds:
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"building {what} failed:\n{proc.stderr[-4000:]}")
            os.replace(tmp, out)
        finally:
            for path in (tmp, *objs):
                if os.path.exists(path):
                    os.unlink(path)
    return out
