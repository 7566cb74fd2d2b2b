"""The CUDA build's cache key: a library is named by a hash of its source,
of every shared header in ``csrc/`` and of the flags, so an edit to a
header the source includes builds a new library instead of loading a
stale one. ``library_path`` computes the name without ``nvcc``."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build as kbuild  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "k.cu").write_text('#include "core.cuh"\nint k() { return f(); }\n')
    (d / "core.cuh").write_text("inline int f() { return 1; }\n")
    monkeypatch.setattr(kbuild, "CSRC", d)
    return d


def test_header_edit_changes_library_path(csrc):
    before = kbuild.library_path("k")
    (csrc / "core.cuh").write_text("inline int f() { return 2; }\n")
    assert kbuild.library_path("k") != before


def test_new_header_changes_library_path(csrc):
    before = kbuild.library_path("k")
    (csrc / "more.cuh").write_text("inline int g() { return 3; }\n")
    assert kbuild.library_path("k") != before


def test_library_path_is_stable_and_per_source(csrc):
    (csrc / "j.cu").write_text('#include "core.cuh"\n')
    first = kbuild.library_path("k")
    assert kbuild.library_path("k") == first
    assert kbuild.library_path("j") != first
    assert first.parent == kbuild.BUILD_DIR
    assert first.name.startswith("libk_") and first.suffix == ".so"
    (csrc / "k.cu").write_text("int k() { return 0; }\n")
    assert kbuild.library_path("k") != first


def test_attention_sources_share_the_headers():
    """The two attention sources include the split-TF32 headers, which
    the cache key covers."""
    names = {h.name for h in kbuild.headers()}
    assert {"tf32_mma.cuh", "attn_fwd.cuh"} <= names
    for src in ("flash_attention", "swa_attention"):
        text = kbuild.source(src).read_text()
        assert '#include "attn_fwd.cuh"' in text
