"""The kernel build names each library by everything it compiles: the
``.cu`` source, every ``csrc/`` header it includes (directly or through
another header) and the flags, -D macros included. So an edited header is
rebuilt, and an unchanged tree loads what it built before. The tests edit a temporary copy
of ``csrc/``; nothing is compiled."""

import shutil

import pytest

from audioset_convnext_inf_torch.ops import _build

KERNELS = ("fused_block", "fused_block_bwd")


@pytest.fixture
def before():
    """The library paths the package's own sources name."""
    return {name: _build.library_path(name) for name in KERNELS}


@pytest.fixture
def csrc(tmp_path, monkeypatch, before):
    """A copy of the package's csrc/ that the build reads instead."""
    d = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, d)
    monkeypatch.setattr(_build, "CSRC", d)
    return d


def _append(path, text="\n// edited\n"):
    path.write_text(path.read_text() + text)


@pytest.mark.parametrize("name", KERNELS)
def test_sources_list_the_kernel_and_the_shared_header(name):
    assert [p.name for p in _build.sources(name)] == [f"{name}.cu", "mma_bf16.cuh"]


@pytest.mark.parametrize("name", KERNELS)
def test_an_unchanged_tree_keeps_its_library(csrc, before, name):
    """Same bytes, same library: a copy of the tree names the library the
    package's own sources name, call after call."""
    assert _build.library_path(name) == before[name]
    assert _build.library_path(name) == _build.library_path(name)


@pytest.mark.parametrize("name", KERNELS)
def test_editing_the_shared_header_changes_the_library(csrc, before, name):
    _append(csrc / "mma_bf16.cuh")
    assert _build.library_path(name) != before[name]


@pytest.mark.parametrize("name", KERNELS)
def test_editing_the_source_changes_only_its_library(csrc, before, name):
    _append(csrc / f"{name}.cu")
    other = KERNELS[1 - KERNELS.index(name)]
    assert _build.library_path(name) != before[name]
    assert _build.library_path(other) == before[other]


def test_headers_included_through_headers_are_followed(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n")
    _append(csrc / "mma_bf16.cuh", '\n#include "inner.cuh"\n')
    with_inner = _build.library_path("fused_block")
    assert [p.name for p in _build.sources("fused_block")][-1] == "inner.cuh"
    _append(csrc / "inner.cuh")
    assert _build.library_path("fused_block") != with_inner


def test_files_that_are_not_included_do_not_count(csrc):
    (csrc / "unused.cuh").write_text("#pragma once\n// not included by any kernel\n")
    _append(csrc / "fused_block.cu", '\n#include <cuda_fp16.h>\n#include "not_in_csrc.h"\n')
    path = _build.library_path("fused_block")
    assert "unused.cuh" not in [p.name for p in _build.sources("fused_block")]
    _append(csrc / "unused.cuh")
    assert _build.library_path("fused_block") == path


def test_an_include_cycle_ends(csrc):
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')
    _append(csrc / "mma_bf16.cuh", '\n#include "a.cuh"\n')
    names = [p.name for p in _build.sources("fused_block")]
    assert names == ["fused_block.cu", "mma_bf16.cuh", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("name", KERNELS)
def test_defines_name_their_own_library(before, name):
    """A build with -D macros (the ablation script's) is a library of its
    own, one per set of macros; the package's build, with none, keeps its
    name."""
    stencil = _build.library_path(name, ("ABLATE_STENCIL",))
    assert stencil != before[name]
    assert stencil != _build.library_path(name, ("MT_WIDE=16",))
    assert stencil == _build.library_path(name, ("ABLATE_STENCIL",))
    assert _build.library_path(name, ()) == before[name]
