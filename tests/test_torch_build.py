"""The port's kernel build cache: a library is named by a hash of what it
is built from, so an edit to a source or to any header under ``csrc/``
rebuilds. No compiler is needed: only the names are computed."""

import pytest

from rafiki_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_editing_a_header_changes_the_library(csrc):
    before = _build.library_path("k")
    assert before == _build.library_path("k")  # stable
    (csrc / "common.cuh").write_text("// v2\n")
    assert _build.library_path("k") != before


def test_adding_a_header_or_editing_the_source_changes_it(csrc):
    before = _build.library_path("k")
    (csrc / "more.h").write_text("// new\n")
    with_header = _build.library_path("k")
    assert with_header != before
    (csrc / "k.cu").write_text('#include "common.cuh"\n// edit\n')
    assert _build.library_path("k") != with_header


def test_other_files_do_not(csrc):
    before = _build.library_path("k")
    (csrc / "notes.txt").write_text("not compiled\n")
    (csrc / "other.cu").write_text("// another source\n")
    assert _build.library_path("k") == before
    assert _build.library_path("k").parent == _build.BUILD_DIR
    assert _build.library_path("k").name.startswith("k-")


def test_the_shipped_sources_include_the_shared_header():
    """flash_fwd.cu and flash_bwd.cu build on hopper.cuh: all sit under
    csrc/ and the header is part of every library's hash."""
    assert (_build.CSRC / "hopper.cuh").exists()
    for name in _build.SOURCES:
        source = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper.cuh"' in source, name
