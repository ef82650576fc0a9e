"""Build the hand-written CUDA kernels from ``dvf_tpu_torch/csrc`` at first
use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ctypes. The
library lands in ``dvf_tpu_torch/_build/`` (git-ignored; the
``DVF_COMPILE_CACHE_DIR`` variable or
``runtime.engine.enable_compilation_cache`` move it) under a name that
carries a hash of its source and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. ``build_all`` starts one ``nvcc`` per
source, all together. A missing ``nvcc`` or a failed build raises with the
compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = Path(os.environ.get("DVF_COMPILE_CACHE_DIR") or _PKG / "_build")

# No --use_fast_math: the kernels rely on IEEE division/sqrt and the
# accurate expf to stay within 1e-5 of their plain versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Compiler output (ptxas register / shared-memory / spill report) of each
# build this process ran, by source name.
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    """The nvcc to build with: on PATH, else under CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (not on PATH, nor under CUDA_HOME or /usr/local/cuda): "
        "the CUDA kernels in dvf_tpu_torch/csrc cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str, nvcc: str):
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every listed source (default: all of ``csrc/*.cu``) whose
    library is not built yet, one nvcc per source, all started together.
    Returns the seconds each build took (0.0 for a cached library)."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    names = list(names)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [n for n in names if not library_path(n).exists()]
        secs = {n: 0.0 for n in names}
        if not todo:
            return secs
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        running = {n: _start(n, nvcc) for n in todo}
        failed = []
        for n, (proc, tmp, out) in running.items():
            log, _ = proc.communicate()
            secs[n] = time.perf_counter() - t0
            build_log[n] = log
            if proc.returncode != 0:
                failed.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return secs


def loaded_paths() -> set:
    """The files of the libraries this process has loaded."""
    with _lock:
        return {lib._name for lib in _libs.values()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
