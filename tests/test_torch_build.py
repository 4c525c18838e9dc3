"""The kernels' build cache: a library's name hashes its source, every
header beside it and the nvcc flags, so an edited shared header never
loads a stale library. Runs on the CPU: nothing is compiled."""
from repro_torch.kernels import build


def test_library_name_changes_with_a_shared_header(tmp_path, monkeypatch):
    (tmp_path / "walk.cu").write_text('#include "walk.cuh"\n')
    (tmp_path / "walk.cuh").write_text("// first\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    first = build._lib_path("walk")
    assert build._lib_path("walk") == first
    assert first.parent == tmp_path / "out"
    (tmp_path / "walk.cuh").write_text("// edited\n")
    edited = build._lib_path("walk")
    assert edited != first
    (tmp_path / "more.h").write_text("// a plain header\n")
    assert build._lib_path("walk") not in (first, edited)
    assert build.sources() == ["walk"]           # headers are not sources


def test_every_kernel_source_finds_its_headers():
    """The repository's sources include only headers that lie in csrc/."""
    import re
    for name in build.sources():
        text = (build.CSRC / f"{name}.cu").read_text()
        for inc in re.findall(r'#include "([^"]+)"', text):
            assert (build.CSRC / inc).is_file(), (name, inc)
