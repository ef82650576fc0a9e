"""The BIGGER-replica flavor: one replica spanning a process group (port
of ``dvf_tpu.fleet.multihost``).

:class:`MultiHostReplica` is the fleet handle for a replica whose
worker is a ``MultiHostEngine`` process group — ``hosts`` child
processes joined by ``torch.distributed`` (a gloo group; member *i* on
``cuda:{i % device_count}``, so on one card every member shares it),
running ONE program over every member's rows and serving it behind the
standard replica RPC. The fleet router cannot tell it from a
:class:`~dvf_tpu_torch.fleet.replica.ProcessReplica`: same transport, same health/stats surface, same
drain/migrate/restart supervision — a peer loss inside the group makes
the LEADER unhealthy and the whole group is replaced as a unit
(replica-granular loss, the router's existing domain; intra-group
elasticity is `parallel.distributed.ElasticMeshRunner` territory).

This is the elasticity controller's second axis: when the measured
stage profiles say one host's device time IS the latency,
``scale_out`` targets this flavor instead of another single-host
replica — more devices under one program, not more queues.

A multihost replica serves ONE signature, fixed at spawn (the fleet
pins it to the first ``--precompile`` manifest entry): the group
compiles one program in lockstep, and re-pointing it is a respawn.
Leader/peer wiring lives in ``fleet._mh_worker``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from typing import Dict, List, Optional

from dvf_tpu_torch.fleet.replica import _LIVE_PROCS, ProcessReplica


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class MultiHostReplica(ProcessReplica):
    """Process-group replica behind the standard replica RPC (module
    docstring). Reuses ProcessReplica's whole client side — handshake,
    serial channel, bounded health/stats probes, clock-offset estimate
    — and overrides only the spawn/teardown to manage ``hosts``
    processes instead of one."""

    def __init__(
        self,
        replica_id: str,
        op_chain: str,
        frame_shape: tuple,
        frame_dtype: str = "uint8",
        hosts: int = 2,
        batch_size: int = 8,
        slo_ms: float = 1000.0,
        queue_size: int = 64,
        out_queue_size: int = 1024,
        env: Optional[Dict[str, str]] = None,
        startup_timeout_s: float = 180.0,
        rpc_timeout_s: float = 60.0,
        device: str = "cuda",
    ):
        if hosts < 2:
            raise ValueError("a multihost replica needs hosts >= 2")
        # The global batch must divide evenly across the group: a
        # non-divisible batch axis replicates (every host feeds every
        # row), which defeats the sharding the flavor exists for.
        batch_global = max(1, batch_size // hosts) * hosts
        self.hosts = hosts
        self.mh_config = {
            "op_chain": op_chain,
            "frame_shape": [int(d) for d in frame_shape],
            "frame_dtype": str(frame_dtype),
            "batch_global": batch_global,
            "slo_ms": float(slo_ms),
            "queue_size": int(queue_size),
            "out_queue_size": int(out_queue_size),
            "hosts": hosts,
            "device": "cpu" if str(device).startswith("cpu") else "cuda",
        }
        self._group: List[subprocess.Popen] = []
        super().__init__(
            replica_id,
            wire_config={"mh": dict(self.mh_config)},
            env=env,
            startup_timeout_s=startup_timeout_s,
            rpc_timeout_s=rpc_timeout_s,
        )

    # -- group spawn/teardown (the ProcessReplica seams) -----------------

    def _launch(self, port: int) -> subprocess.Popen:
        coordinator_port = _free_port()
        peer_port = _free_port()
        env = self._child_env()
        env["DVF_MH_CONFIG"] = json.dumps(self.mh_config)
        stderr = (None
                  if os.environ.get("DVF_FLEET_WORKER_STDERR") == "1"
                  else subprocess.DEVNULL)
        self._group = []
        leader = None
        for pid in range(self.hosts):
            p = subprocess.Popen(
                [sys.executable, "-m", "dvf_tpu_torch.fleet._mh_worker",
                 "--parent-port", str(port),
                 "--peer-port", str(peer_port),
                 "--coordinator", f"127.0.0.1:{coordinator_port}",
                 "--num-processes", str(self.hosts),
                 "--process-id", str(pid),
                 "--replica-id", self.id],
                env=env,
                stdout=subprocess.DEVNULL,
                stderr=stderr,
                # close_fds=False keeps posix_spawn eligible: the parent
                # may have CUDA up, and must never fork it.
                close_fds=False,
            )
            self._group.append(p)
            _LIVE_PROCS.add(p)
            if pid == 0:
                leader = p
        return leader

    def _sweep_group(self, timeout: float) -> None:
        """Reap every group member (the leader's stop already asked
        peers to exit; a wedged one is killed)."""
        group, self._group = self._group, []
        for p in group:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass

    def stop(self, timeout: float = 10.0) -> None:
        super().stop(timeout=timeout)
        self._sweep_group(timeout=min(timeout, 5.0))

    def kill(self) -> None:
        super().kill()
        for p in self._group:
            try:
                p.kill()
            except OSError:
                pass

    def alive(self) -> bool:
        # The group lives and dies as a unit: any member's death is the
        # replica's (the leader's next collective would wedge — don't
        # wait for it).
        return bool(not self._lost and self._group
                    and all(p.poll() is None for p in self._group))
