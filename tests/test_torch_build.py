"""The kernels' build cache (``repro_torch.kernels._build``), on the CPU.

A library's file name hashes its ``.cu`` source, every ``csrc`` header the
source includes (through other headers too) and the nvcc flags, so an
edited header can never load a stale library. nvcc is never called here:
the tests look at target paths, at the build log and at ptxas's report.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary ``csrc``: a.cu includes h.cuh, which includes g.cuh;
    other.cuh is included by nothing."""
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "a.cu").write_text('#include <cuda_runtime.h>\n#include "h.cuh"\n'
                            'int f() { return h(); }\n')
    (d / "h.cuh").write_text('#pragma once\n#  include "g.cuh"\n'
                             'inline int h() { return g(); }\n')
    (d / "g.cuh").write_text("#pragma once\ninline int g() { return 1; }\n")
    (d / "other.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", d)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    return d


def test_sources_follow_includes_through_headers(csrc):
    assert [p.name for p in _build._sources("a")] == ["a.cu", "h.cuh", "g.cuh"]


@pytest.mark.parametrize("edited", ["a.cu", "h.cuh", "g.cuh"])
def test_editing_the_source_or_an_included_header_changes_the_target(csrc, edited):
    before = _build._target("a")
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    after = _build._target("a")
    assert after != before
    assert after.parent == before.parent and after.name.startswith("a-")


def test_a_header_not_included_leaves_the_target(csrc):
    before = _build._target("a")
    (csrc / "other.cuh").write_text("#pragma once\nint x;\n")
    assert _build._target("a") == before


def test_flags_change_the_target(csrc, monkeypatch):
    before = _build._target("a")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._target("a") != before


def test_flash_sources_hash_their_shared_header():
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        assert [p.name for p in _build._sources(name)] == [f"{name}.cu",
                                                          "flash_mma.cuh"]
    assert [p.name for p in _build._sources("copyscore")] == [
        "copyscore.cu", "copyscore_eq6.cuh", "copyscore_mma.cuh",
        "flash_mma.cuh"]


@pytest.mark.parametrize("name", ["copyscore", "copyscore_fused"])
def test_copyscore_sources_hash_their_shared_headers(name):
    """B1 (copyscore_fused) and B2/B3 (copyscore) take Eq. 3 and Eq. 6 from
    one header and the int8 tensor-core pieces from another: both are in
    each library's hash, so an edit to either rebuilds both."""
    assert [p.name for p in _build._sources(name)] == [
        f"{name}.cu", "copyscore_eq6.cuh", "copyscore_mma.cuh",
        "flash_mma.cuh"]


def test_a_library_found_on_disk_keeps_this_process_build_log(csrc):
    """``load`` after ``build_all`` finds the library on disk; the entry the
    build wrote (with ptxas's report) stays, and a library this process did
    not build is logged as cached."""
    out = _build._target("a")
    out.parent.mkdir(parents=True)
    out.write_bytes(b"")
    _build.BUILD_LOG["a"] = {"path": str(out), "seconds": 2.5, "cached": False,
                             "ptxas": "ptxas info : Used 96 registers"}
    assert _build._start("a") is None
    assert _build.BUILD_LOG["a"]["ptxas"] == "ptxas info : Used 96 registers"
    del _build.BUILD_LOG["a"]
    assert _build._start("a") is None
    assert _build.BUILD_LOG["a"] == {"path": str(out), "seconds": 0.0,
                                     "cached": True, "ptxas": ""}


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2tc19flash_fwd_tc_kernelILi64EEEvPK' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc19flash_fwd_tc_kernelILi64EEEvPK
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2tc19flash_fwd_tc_kernelILi128EEEvPK' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc19flash_fwd_tc_kernelILi128EEEvPK
    16 bytes stack frame, 16 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_report_splits_by_kernel():
    got = _build.ptxas_entries(PTXAS)
    assert got == {
        "_ZN2tc19flash_fwd_tc_kernelILi64EEEvPK": [
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "Used 128 registers, used 1 barriers, 400 bytes cmem[0]"],
        "_ZN2tc19flash_fwd_tc_kernelILi128EEEvPK": [
            "16 bytes stack frame, 16 bytes spill stores, 32 bytes spill loads",
            "Used 255 registers, used 1 barriers, 400 bytes cmem[0]"]}
    assert _build.ptxas_entries("") == {}
