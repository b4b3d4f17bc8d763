"""The port's kernel build (``repro_torch.kernels._build``) without a
compiler: which files key the library's name, and that every entry point
the wrappers call has its argument types.  Building itself needs ``nvcc``
and runs on the card (``chip_smoke.py``)."""

import re

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// header\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("changed", ["a.cu", "h.cuh"])
def test_library_name_follows_sources_and_headers(csrc, changed):
    """A changed source or header gives another library name, so it is
    rebuilt; an unchanged set keeps its name."""
    before = _build.library_path()
    assert _build.library_path() == before
    (csrc / changed).write_text((csrc / changed).read_text() + "// edit\n")
    assert _build.library_path() != before


def test_only_cu_files_are_compiled(csrc):
    assert [p.name for p in _build.sources()] == ["a.cu"]


def test_every_entry_point_has_argument_types():
    """Each ``extern "C"`` entry of the CUDA sources is bound with its
    argument count (an unbound one would pass pointers as 32-bit ints)."""
    found = {}
    for src in _build.sources():
        text = src.read_text()
        body = text[text.index('extern "C" {'):]
        for name, args in re.findall(r"\nint (\w+)\(([^)]*)\)", body):
            found[name] = len(args.split(","))
    assert found
    for name, n_args in found.items():
        assert len(_build._SIGNATURES[name]) == n_args, name
