"""The kernel build (``dvf_tpu_torch.ops._build``) without a real nvcc:
a stand-in compiler script exercises the parallel build, the source-hash
cache and the error paths. That the CUDA sources compile is checked on the
card (chip_smoke.py)."""

import os
import stat
import sys

import pytest

from dvf_tpu_torch.ops import _build

_FAKE_NVCC = """#!{py}
import sys
args = sys.argv[1:]
src = args[-1]
text = open(src).read()
if "#error" in text:
    print(src + ": error: deliberate failure")
    sys.exit(2)
out = args[args.index("-o") + 1]
open(out, "w").write("built " + src)
print("ptxas info    : Used 32 registers")
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(_FAKE_NVCC.format(py=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "build_log", {})
    monkeypatch.setenv("PATH", f"{nvcc.parent}{os.pathsep}{os.environ['PATH']}")
    return csrc, build


def test_builds_every_source_once_then_caches(fake_tree):
    csrc, build = fake_tree
    secs = _build.build_all()
    assert set(secs) == {"a", "b"} and all(v > 0 for v in secs.values())
    for name in ("a", "b"):
        lib = _build.library_path(name)
        assert lib.parent == build and lib.read_text().startswith("built")
        assert "registers" in _build.build_log[name]
    assert _build.build_all() == {"a": 0.0, "b": 0.0}   # cached
    assert not list(build.glob("*.tmp"))


def test_edited_source_gets_a_new_library(fake_tree):
    csrc, _ = fake_tree
    before = _build.library_path("a")
    (csrc / "a.cu").write_text("// a, edited\n")
    assert _build.library_path("a") != before
    assert _build.library_path("a").name.startswith("liba-")


def test_failed_build_raises_with_compiler_output(fake_tree):
    csrc, build = fake_tree
    (csrc / "b.cu").write_text("#error broken\n")
    with pytest.raises(RuntimeError, match="deliberate failure"):
        _build.build_all()
    assert not _build.library_path("b").exists()
    assert not list(build.glob("*.tmp"))


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["stencils"])
