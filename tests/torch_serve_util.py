"""Shared pieces of the port's serving tests (``tests/test_torch_*.py``
over ``dvf_tpu_torch.serve`` and ``dvf_tpu_torch.fleet``): the frontend,
engine and fleet on the CPU, and the port-side leak guards.

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


def FleetFrontend(filt=None, config=None):  # noqa: N802 — the class's name
    """The port's fleet on the CPU: every replica, local or process."""
    from dvf_tpu_torch.fleet import FleetFrontend as _Fleet

    return _Fleet(filt, config, device="cpu")


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


@pytest.fixture(scope="module", autouse=True)
def port_fleet_guard():
    """The port's fleet tests leak no replica worker process and no warm
    standby past their module (``tests/conftest.py``'s session guard
    watches only the JAX package's fleet; it does catch the port's
    ``dvf-fleet*`` threads by name)."""
    yield
    import sys

    replica = sys.modules.get("dvf_tpu_torch.fleet.replica")
    elastic = sys.modules.get("dvf_tpu_torch.fleet.elastic")
    deadline = time.time() + 10.0

    def leaked():
        out = {}
        if replica is not None and replica.live_worker_processes():
            out["workers"] = [p.pid for p in replica.live_worker_processes()]
        if elastic is not None and elastic.live_standby_handles():
            out["standbys"] = [h.id for h in elastic.live_standby_handles()]
        return out

    left = leaked()
    while left and time.time() < deadline:
        time.sleep(0.1)
        left = leaked()
    assert not left, (f"the port's fleet outlived its FleetFrontend "
                      f"(stop() not called?): {left}")
