"""The kernel build's cache key (repro_torch/kernels/_build.py): a library
is named by a hash of its source, the csrc headers it includes (directly or
through another header) and the nvcc flags, so a change to any of them
names a new library and is rebuilt.  Runs without nvcc: nothing is
compiled."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('  #  include "b.cuh"\n'
                                    '#include "missing.cuh"\n')
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\nint y;\n')
    return tmp_path


def test_sources_follow_includes_once(csrc):
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh",
                                                     "b.cuh"]


@pytest.mark.parametrize("edit", ["k.cu", "a.cuh", "b.cuh", "flags"])
def test_library_path_changes_with_every_input(csrc, monkeypatch, edit):
    before = _build.library_path("k")
    assert before == _build.library_path("k")
    if edit == "flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS",
                            _build.NVCC_FLAGS + ("-I/opt/include",))
    else:
        path = csrc / edit
        path.write_text(path.read_text() + "// edited\n")
    after = _build.library_path("k")
    assert after != before and after.parent == _build.BUILD_DIR
