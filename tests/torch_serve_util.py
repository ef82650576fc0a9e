"""Shared pieces of the port's serving tests (``tests/test_torch_*.py``
over ``dvf_tpu_torch.serve``): the frontend and engine on the CPU, and
the port-side leak guard.

The guard mirrors ``tests/conftest.py``'s session-end pool and memory
guards, which look only at ``dvf_tpu.*``: after each module that
imports it, no pool-managed engine of the port is live and the port's
streamed ingest and egress hold no host slab, within a 5 s grace window.
"""

import gc
import time

import pytest

from dvf_tpu_torch.runtime import egress, ingest
from dvf_tpu_torch.runtime.engine import Engine as _Engine
from dvf_tpu_torch.runtime.engine import live_pool_engines
from dvf_tpu_torch.serve import ServeFrontend as _Frontend


def ServeFrontend(filt, config=None, engine=None):  # noqa: N802 — the class's name
    """The port's frontend on the CPU (the tests' only device)."""
    return _Frontend(filt, config, engine=engine, device="cpu")


def Engine(filt, **kw):  # noqa: N802 — the class's name
    """The port's engine on the CPU."""
    return _Engine(filt, device="cpu", **kw)


def _residual() -> dict:
    gc.collect()
    out = {}
    live = live_pool_engines()
    if live:
        out["pool_engines"] = [getattr(e, "op_chain", "?") for e in live]
    for name, mod in (("ingest_slab_bytes", ingest),
                      ("egress_slab_bytes", egress)):
        b = mod.occupied_slab_bytes()
        if b:
            out[name] = b
    return out


@pytest.fixture(scope="module", autouse=True)
def port_leak_guard():
    """Every port frontend a module built released its pool engines and
    its host slabs by the module's end."""
    yield
    deadline = time.time() + 5.0
    leaked = _residual()
    while leaked and time.time() < deadline:
        time.sleep(0.05)
        leaked = _residual()
    assert not leaked, (
        f"the port's serving state outlived its frontends (stop() not "
        f"called, or no longer freeing?): {leaked}")
