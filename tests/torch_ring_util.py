"""Shared pieces of the port's ring and wire tests.

The JAX package's native loader builds ``ring.cpp`` and ``jpeg_shim.cpp``
next to their sources with a write that is not atomic, and its own tests
may build them at the same moment in another pytest-xdist worker. The
port's tests hold the port to those libraries, so before the JAX package
first loads either one in a process, :func:`jax_native_isolated` points
its loader at a private directory: no port test writes into ``dvf_tpu/``.
A library the process already loaded stays as it is.
"""

import pytest


@pytest.fixture(scope="module", autouse=True)
def jax_native_isolated(tmp_path_factory):
    import dvf_tpu.transport.codec as jax_codec
    import dvf_tpu.transport.ring as jax_ring

    build = tmp_path_factory.mktemp("jax_native")
    if jax_ring._lib is None:
        jax_ring._LIB = str(build / "_ring.so")
    if jax_codec._shim is None and jax_codec._shim_error is None:
        jax_codec._SHIM_LIB = str(build / "_jpeg_shim.so")
    yield


# A JAX-package CLI run in a child process, its ring shim built into the
# directory given as the first argument (never into ``dvf_tpu/``):
# ``[sys.executable, "-c", JAX_CLI_ISOLATED, lib_dir, "camera", ...]``.
JAX_CLI_ISOLATED = (
    "import os, sys\n"
    "import dvf_tpu.transport.ring as ring\n"
    "ring._LIB = os.path.join(sys.argv[1], '_ring.so')\n"
    "from dvf_tpu.cli import main\n"
    "sys.exit(main(sys.argv[2:]))\n"
)
