"""The kernel build names each library by everything it compiles: the
``.cu`` source, every ``csrc/`` header it includes (directly or through
another header) and the flags, -D macros included. So an edited header is
rebuilt, and an unchanged tree loads what it built before. The tests edit a temporary copy
of ``csrc/``; nothing is compiled."""

import shutil

import pytest

from audioset_convnext_inf_torch.ops import _build

KERNELS = ("fused_block", "fused_block_bwd")
# what each kernel compiles from csrc/: its source and the one header both
# kernels share (the bf16 pieces, wgmma, TMA, mbarrier, clusters)
SOURCES = {"fused_block": ["fused_block.cu", "wgmma_bf16.cuh"],
           "fused_block_bwd": ["fused_block_bwd.cu", "wgmma_bf16.cuh"]}


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
    assert [p.name for p in _build.sources(name)] == SOURCES[name]


def test_the_shared_header_renames_both_libraries_and_a_kernels_own_header_only_its(csrc, before):
    """Editing the shared header renames both libraries: K1 and K2 both
    include wgmma_bf16.cuh. A header that only one kernel includes renames
    only that kernel's library."""
    _append(csrc / "wgmma_bf16.cuh")
    assert _build.library_path("fused_block_bwd") != before["fused_block_bwd"]
    assert _build.library_path("fused_block") != before["fused_block"]
    (csrc / "only_k1.cuh").write_text("#pragma once\n")
    _append(csrc / "fused_block.cu", '\n#include "only_k1.cuh"\n')
    k1, k2 = _build.library_path("fused_block"), _build.library_path("fused_block_bwd")
    _append(csrc / "only_k1.cuh")
    assert _build.library_path("fused_block") != k1
    assert _build.library_path("fused_block_bwd") == k2


@pytest.mark.parametrize("name", KERNELS)
def test_an_unchanged_tree_keeps_its_library(csrc, before, name):
    """Same bytes, same library: a copy of the tree names the library the
    package's own sources name, call after call."""
    assert _build.library_path(name) == before[name]
    assert _build.library_path(name) == _build.library_path(name)


@pytest.mark.parametrize("name", KERNELS)
def test_editing_the_shared_header_changes_the_library(csrc, before, name):
    _append(csrc / "wgmma_bf16.cuh")
    assert _build.library_path(name) != before[name]


@pytest.mark.parametrize("name", KERNELS)
def test_editing_the_source_changes_only_its_library(csrc, before, name):
    _append(csrc / f"{name}.cu")
    other = KERNELS[1 - KERNELS.index(name)]
    assert _build.library_path(name) != before[name]
    assert _build.library_path(other) == before[other]


def test_the_adamw_kernel_compiles_its_source_alone(csrc, before):
    """csrc/adamw.cu includes no header of csrc/: editing the shared
    header leaves its library, editing it leaves K1's and K2's."""
    assert [p.name for p in _build.sources("adamw")] == ["adamw.cu"]
    adamw = _build.library_path("adamw")
    _append(csrc / "wgmma_bf16.cuh")
    assert _build.library_path("adamw") == adamw
    k1, k2 = _build.library_path("fused_block"), _build.library_path("fused_block_bwd")
    _append(csrc / "adamw.cu")
    assert _build.library_path("adamw") != adamw
    assert (_build.library_path("fused_block"), _build.library_path("fused_block_bwd")) == (k1, k2)


def test_headers_included_through_headers_are_followed(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n")
    _append(csrc / "wgmma_bf16.cuh", '\n#include "inner.cuh"\n')
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
    _append(csrc / "wgmma_bf16.cuh", '\n#include "a.cuh"\n')
    names = [p.name for p in _build.sources("fused_block")]
    assert names == ["fused_block.cu", "wgmma_bf16.cuh", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("name", KERNELS)
def test_defines_name_their_own_library(before, name):
    """A build with -D macros (the ablation script's) is a library of its
    own, one per set of macros; the package's build, with none, keeps its
    name."""
    stencil = _build.library_path(name, ("ABLATE_STENCIL",))
    assert stencil != before[name]
    assert stencil != _build.library_path(name, ("K1_SPLIT=2",))
    assert stencil == _build.library_path(name, ("ABLATE_STENCIL",))
    assert _build.library_path(name, ()) == before[name]


def test_a_pinned_kernel_loads_its_file_and_keeps_it(monkeypatch, tmp_path, caplog):
    """A serving bundle of another build pins K1 to its copy of the
    library, and says so: the kernel then resolves to that file and builds
    nothing; the same build from another directory is the same pin, another
    build raises, and so does a missing file or a -D build of a pinned
    kernel."""
    monkeypatch.setattr(_build, "_PINNED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build", lambda *a: pytest.fail("a pinned kernel built"))
    first, again = tmp_path / "a", tmp_path / "b"
    for d in (first, again):
        d.mkdir()
        (d / "libfused_block_0000.so").write_bytes(b"")
    (first / "libfused_block_1111.so").write_bytes(b"")
    with pytest.raises(FileNotFoundError):
        _build.use_library("fused_block", first / "libfused_block_2222.so")
    assert _build.use_library("fused_block", first / "libfused_block_0000.so")
    assert "libfused_block_0000.so" in caplog.text
    assert _build.use_library("fused_block", again / "libfused_block_0000.so")
    assert _build.library("fused_block") == first / "libfused_block_0000.so"
    with pytest.raises(RuntimeError, match="pinned"):
        _build.use_library("fused_block", first / "libfused_block_1111.so")
    with pytest.raises(RuntimeError, match="no -D"):
        _build.library("fused_block", ("ABLATE_STENCIL",))


def test_a_bundle_of_this_build_pins_nothing(monkeypatch, tmp_path):
    """A bundle whose library has the name of the package's own build (the
    same sources and flags) runs that build: the bundle's copy is installed
    as the build where none exists, an existing build is kept, nothing is
    pinned, and -D builds stay open."""
    monkeypatch.setattr(_build, "_PINNED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    own = _build.library_path("fused_block")
    copy = tmp_path / "bundle" / own.name
    copy.parent.mkdir()
    copy.write_bytes(b"bundle")
    assert _build.use_library("fused_block", copy) is False
    assert own.read_bytes() == b"bundle" and not _build._PINNED
    own.write_bytes(b"built")
    assert _build.use_library("fused_block", copy) is False
    assert own.read_bytes() == b"built"
    monkeypatch.setattr(_build, "build",
                        lambda name, defines=(): _build.library_path(name, defines))
    _build._build_once.cache_clear()
    try:
        assert _build.library("fused_block") == own
        assert _build.library("fused_block", ("ABLATE_STENCIL",)) != own
    finally:
        _build._build_once.cache_clear()


def test_a_launch_does_not_hash_the_sources_again(monkeypatch, tmp_path):
    """Every kernel launch resolves its library (``load``): the build, and
    so the hash of the sources, runs once per process and set of macros,
    not at each launch."""
    calls = []

    def build(name, defines=()):
        calls.append((name, tuple(defines)))
        return tmp_path / f"lib{name}.so"

    monkeypatch.setattr(_build, "_PINNED", {})
    monkeypatch.setattr(_build, "build", build)
    _build._build_once.cache_clear()
    try:
        for _ in range(3):
            assert _build.library("fused_block") == tmp_path / "libfused_block.so"
            _build.library("fused_block", ("ABLATE_STENCIL",))
        assert calls == [("fused_block", ()), ("fused_block", ("ABLATE_STENCIL",))]
    finally:
        _build._build_once.cache_clear()
