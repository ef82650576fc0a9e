"""Build-and-load for the port's host C++ shims (``jpeg_shim.cpp`` and
``ring.cpp``), port of ``dvf_tpu/transport/_native.py``.

The source is compiled with g++ at first use (ctypes keeps the binding
free of any build dependency) into ``dvf_tpu_torch/_build/`` (git-ignored;
the ``DVF_COMPILE_CACHE_DIR`` variable or
``runtime.engine.enable_compilation_cache`` move it), never next to the
source. The library's name carries a hash of the source
and the compile command, so an edited source or a changed flag is rebuilt
and an unchanged one is loaded as it is. A missing g++, a missing library
to link (``-ljpeg``) or a failed compile raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Type

BUILD_DIR = Path(os.environ.get("DVF_COMPILE_CACHE_DIR")
                 or Path(__file__).resolve().parent.parent / "_build")

_lock = threading.Lock()
# Keyed by the library's file name (it carries the hash), so a library
# loaded before the build directory moved is not loaded a second time.
_loaded: Dict[str, ctypes.CDLL] = {}


def loaded_paths() -> set:
    """The files of the libraries this process has loaded."""
    with _lock:
        return {lib._name for lib in _loaded.values()}


def library_path(src: str, extra_flags: Sequence[str] = ()) -> Path:
    """Where ``src`` builds to: keyed by its content and the command."""
    src_path = Path(src)
    digest = hashlib.sha256(src_path.read_bytes() + b"\0" + "\0".join(
        _command("SRC", "OUT", extra_flags)).encode()).hexdigest()
    return BUILD_DIR / f"lib{src_path.stem}-{digest[:16]}.so"


def _command(src: str, out: str, extra_flags: Sequence[str]) -> list:
    # -lrt: glibc < 2.34 keeps shm_open in librt; harmless on newer glibc.
    return ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", src, "-o", out,
            *extra_flags, "-lrt"]


def load_native(src: str, extra_flags: Sequence[str] = (),
                cdll_cls: Type[ctypes.CDLL] = ctypes.CDLL) -> ctypes.CDLL:
    """Build ``src`` unless its library is built, and load it.

    ``cdll_cls`` picks the GIL policy: ``ctypes.CDLL`` releases the GIL
    for each call (right for milliseconds of JPEG work that a thread pool
    should run in parallel), ``ctypes.PyDLL`` holds it (right for the
    ring's sub-microsecond calls)."""
    out = library_path(src, extra_flags)
    with _lock:
        lib = _loaded.get(out.name)
        if lib is not None:
            return lib
        if not out.exists():
            if shutil.which("g++") is None:
                raise RuntimeError(f"g++ not found on PATH: cannot build {src}")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run(_command(src, str(tmp), extra_flags),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"g++ failed to build {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = _loaded[out.name] = cdll_cls(str(out))
        return lib
