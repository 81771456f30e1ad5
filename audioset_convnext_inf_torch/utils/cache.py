"""Where the port keeps what it compiles, across processes and checkouts.

The port's counterpart of the JAX package's ``utils/cache.py`` (which points
XLA's persistent compilation cache at a directory). What the port compiles
is its nvcc kernels (``ops/_build.py``) and its host C++ libraries
(``utils/host_build.py``). Each library's file name is a hash of its sources
and flags, so a build directory is a cache by itself: a process loads what
an earlier one built, and rebuilds only what changed. By default the
directories are ``build/torch_kernels/`` and ``build/host_libs/`` in the
checkout. ``AUDIOSET_TPU_COMPILE_CACHE=DIR`` moves both under ``DIR``
(``DIR/torch_kernels``, ``DIR/host_libs``), so a fresh checkout of the same
sources loads them without building. Every CLI calls
``enable_compilation_cache`` first.

``AUDIOSET_TPU_NO_COMPILE_CACHE=1`` is accepted because the JAX package reads
it, but in the port it cannot turn caching off: the build directories are
hash-named caches whatever is set, and the libraries cannot be used without
building them there. All it does is keep ``AUDIOSET_TPU_COMPILE_CACHE`` from
moving the directories, and make the call return False.
"""

from __future__ import annotations

import os
from pathlib import Path

_ENABLED = False


def enable_compilation_cache() -> bool:
    """Apply the environment's cache setting: False under
    ``AUDIOSET_TPU_NO_COMPILE_CACHE`` (the directories stay in the checkout,
    where they still cache), else True, with the build directories under
    ``AUDIOSET_TPU_COMPILE_CACHE`` when it is set."""
    global _ENABLED
    if _ENABLED:
        return True
    if os.environ.get("AUDIOSET_TPU_NO_COMPILE_CACHE"):
        return False
    cache_dir = os.environ.get("AUDIOSET_TPU_COMPILE_CACHE")
    if cache_dir:
        from audioset_convnext_inf_torch.ops import _build
        from audioset_convnext_inf_torch.utils import host_build

        root = Path(cache_dir).expanduser().resolve()
        _build.BUILD_DIR = root / "torch_kernels"
        host_build.BUILD_DIR = root / "host_libs"
        _build._build_once.cache_clear()  # libraries found in the old directory
    _ENABLED = True
    return True
