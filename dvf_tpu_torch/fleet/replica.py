"""Replica manager: one handle per engine replica, two transports (port
of ``dvf_tpu.fleet.replica``).

A *replica* is one complete ``serve.ServeFrontend`` (its own Engine, its
own dispatch/collect threads, its own fault budgets and watchdog). The
fleet router (`fleet.router`) talks to replicas only through the
:class:`ReplicaHandle` interface defined here, so the same routing /
affinity / drain logic runs over both transports:

:class:`LocalReplica`
    The frontend lives in this process, on one device (replica *i* on
    ``cuda:{i % device_count}``; on one card every local replica shares
    it, each with its own engines, streams and slabs). Zero IPC cost —
    the mode for single-process deployments and unit tests.

:class:`ProcessReplica`
    The frontend lives in a child process (``fleet._worker``) with its
    own torch runtime and CUDA context, reached over a length-prefixed
    pickle RPC on a localhost socket. This is the scale-out shape:
    replica loss is a real process death, replica restart is a real
    respawn, and each replica owns its own GIL. A deployment picks a
    replica's card with ``CUDA_VISIBLE_DEVICES`` in
    ``FleetConfig.replica_env``.

Every RPC failure (socket error, timeout, dead process) surfaces as
:class:`ReplicaLostError`; the router classifies it as a ``replica``
fault and runs the drain → migrate → restart procedure. Handles are
transport only: session placement and health policy live in the router.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from dvf_tpu_torch.serve.session import (
    AdmissionError,
    ServeError,
    SessionClosedError,
)

# Replica lifecycle states (fleet-owned; the handle just stores them).
HEALTHY, DRAINING, RESTARTING, DEAD = (
    "healthy", "draining", "restarting", "dead")

# Live replica child processes, for the leak guards of the fleet tests:
# a test that leaks a worker process would otherwise keep a whole torch
# runtime (and on a card its CUDA context) alive past the suite.
_LIVE_PROCS: "weakref.WeakSet" = weakref.WeakSet()


class ReplicaLostError(ServeError):
    """The replica's process/channel is gone (or it timed out) — the
    fleet tier's signal to drain, migrate, and restart."""


def pid_alive(pid: int) -> bool:
    """Signal-0 liveness probe — what an ADOPTED replica (continuity
    plane: the front door restarted, the worker didn't) has instead of
    a ``Popen`` to poll."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True      # exists, just not ours to signal
    except OSError:
        return False
    return True


# -- wire protocol (ProcessReplica <-> fleet._worker) --------------------

def send_msg(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("!I", len(payload)) + payload)


def recv_msg(sock: socket.socket) -> Any:
    header = _recv_exact(sock, 4)
    (n,) = struct.unpack("!I", header)
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed the replica channel")
        buf.extend(chunk)
    return bytes(buf)


# Exceptions that cross the RPC boundary by NAME (worker sends
# ("err", type_name, message); the parent re-raises the mapped type so
# fleet admission/session semantics survive the process hop).
_WIRE_ERRORS = {
    "AdmissionError": AdmissionError,
    "SessionClosedError": SessionClosedError,
    "ServeError": ServeError,
    "KeyError": KeyError,
    "ValueError": ValueError,
}


def raise_wire_error(type_name: str, message: str) -> None:
    exc_type = _WIRE_ERRORS.get(type_name, ServeError)
    if exc_type is KeyError:
        raise KeyError(message)
    raise exc_type(f"{message}" if exc_type is not ServeError
                   else f"[{type_name}] {message}")


# -- handle interface ----------------------------------------------------

class ReplicaHandle:
    """Transport-agnostic view of one replica (see module docstring)."""

    def __init__(self, replica_id: str):
        self.id = replica_id
        self.state = DEAD          # until start() succeeds
        self.restarts = 0
        self.started_at: Optional[float] = None
        self.clock_offset_s = 0.0  # replica wall clock − front-door
        #   wall clock: what frame-lineage marks crossing this replica's
        #   boundary are re-based by (obs.lineage.FrameLineage.rebase —
        #   the merge_tracer_snapshots epoch discipline, per frame).
        #   Exactly 0 for in-process replicas; process replicas estimate
        #   it from the health RPC's midpoint each monitor tick.

    # lifecycle
    def start(self) -> "ReplicaHandle":
        raise NotImplementedError

    def stop(self, timeout: float = 10.0) -> None:
        raise NotImplementedError

    def restart(self) -> None:
        raise NotImplementedError

    def kill(self) -> None:
        """Hard loss, for chaos/tests: the replica becomes unreachable
        NOW (process replicas die for real)."""
        raise NotImplementedError

    def alive(self) -> bool:
        raise NotImplementedError

    # serving ops (any may raise ReplicaLostError)
    def open_stream(self, session_id, slo_ms=None, frame_shape=None,
                    frame_dtype=None, op_chain=None, tier=None) -> str:
        raise NotImplementedError

    def submit(self, session_id, frame, ts=None, tag=None) -> None:
        """Enqueue one frame. No return value by contract: the fleet
        assigns indices itself, and the process transport is one-way on
        this path (see ProcessReplica._send_only)."""
        raise NotImplementedError

    def poll(self, session_id, max_items=None, meta_only=False) -> list:
        raise NotImplementedError

    def close(self, session_id, drain=True) -> None:
        raise NotImplementedError

    def release(self, session_id) -> None:
        raise NotImplementedError

    def drain(self, timeout: float = 30.0) -> bool:
        raise NotImplementedError

    def session_drained(self, session_id) -> bool:
        """Whether a closed session has delivered everything it ever
        will (``ServeFrontend.session_drained``): the end condition of
        a graceful migration's salvage."""
        raise NotImplementedError

    def begin_drain(self) -> None:
        """Replica-side admission off (``ServeFrontend.begin_drain``):
        the first half of a graceful retire — the fleet stops placing
        there anyway (state flips out of HEALTHY), but the replica's own
        gate closing too means a raced direct open cannot slip in."""
        raise NotImplementedError

    def health(self) -> dict:
        """Liveness + the replica's cheap ``load`` row (queue depth,
        occupancy, monotone counters, p99 — ``ServeFrontend.load_row``):
        what the fleet monitor caches for the RPC-free elastic view."""
        raise NotImplementedError

    def stats_full(self) -> dict:
        """{"stats": frontend.stats(), "latency": latency_snapshot(),
        "health": health()} — one RPC for the whole export."""
        raise NotImplementedError

    def trace_snapshot(self) -> dict:
        """The replica frontend's ``Tracer.snapshot()`` — its bounded
        event window plus wall-clock epoch, the unit the fleet merges
        into ONE Perfetto session (``obs.trace.merge_tracer_snapshots``).
        Plain pickle-safe values, so the same export crosses the process
        RPC unchanged."""
        raise NotImplementedError

    def audit_probe(self, signature=None) -> dict:
        """Run the audit plane's deterministic probe frame through this
        replica's compiled program for ``signature`` and return
        ``{"signature", "digest"}`` (``ServeFrontend.audit_probe``) —
        the fleet's cross-replica divergence detector compares these
        across replicas warm on the same signature."""
        raise NotImplementedError


class LocalReplica(ReplicaHandle):
    """In-process replica: a ServeFrontend over a device slice."""

    def __init__(self, replica_id: str, frontend_factory):
        super().__init__(replica_id)
        self._make = frontend_factory   # () -> started ServeFrontend
        self.frontend = None
        self._lost = False

    def start(self) -> "LocalReplica":
        self.frontend = self._make()
        self._lost = False
        self.state = HEALTHY
        self.started_at = time.monotonic()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        fe, self.frontend = self.frontend, None
        self.state = DEAD
        if fe is not None:
            try:
                fe.stop(timeout=timeout)
            except Exception:  # noqa: BLE001 — teardown best-effort; a
                pass           # failed replica's stored error re-raises

    def restart(self) -> None:
        self.stop(timeout=2.0)
        self.start()
        self.restarts += 1  # on success only (see ProcessReplica)

    def kill(self) -> None:
        # Simulated hard loss: ops fail from now on; the abandoned
        # frontend is torn down best-effort (unlike a process kill there
        # is no OS to reap its threads for us). Lifecycle state is NOT
        # touched — the router's monitor owns it: it must still see this
        # replica as one whose loss needs handling.
        self._lost = True
        fe, self.frontend = self.frontend, None
        if fe is not None:
            try:
                fe.stop(timeout=2.0)
            except Exception:  # noqa: BLE001 — it is being abandoned
                pass

    def alive(self) -> bool:
        return (not self._lost and self.frontend is not None
                and self.frontend._error is None)

    def _fe(self):
        if self._lost or self.frontend is None:
            raise ReplicaLostError(f"replica {self.id} is lost")
        return self.frontend

    def open_stream(self, session_id, slo_ms=None, frame_shape=None,
                    frame_dtype=None, op_chain=None, tier=None) -> str:
        return self._fe().open_stream(
            session_id=session_id, slo_ms=slo_ms,
            frame_shape=frame_shape, frame_dtype=frame_dtype,
            op_chain=op_chain, tier=tier)

    def submit(self, session_id, frame, ts=None, tag=None) -> int:
        return self._fe().submit(session_id, frame, ts=ts, tag=tag)

    def poll(self, session_id, max_items=None, meta_only=False) -> list:
        got = self._fe().poll(session_id, max_items)
        if meta_only:
            got = [d._replace(frame=None) for d in got]
        return got

    def close(self, session_id, drain=True) -> None:
        self._fe().close(session_id, drain=drain)

    def release(self, session_id) -> None:
        self._fe().release(session_id)

    def drain(self, timeout: float = 30.0) -> bool:
        return self._fe().drain(timeout=timeout)

    def session_drained(self, session_id) -> bool:
        return self._fe().session_drained(session_id)

    def begin_drain(self) -> None:
        self._fe().begin_drain()

    def health(self) -> dict:
        fe = self._fe()
        return dict(fe.health(), load=fe.load_row())

    def stats_full(self) -> dict:
        fe = self._fe()
        return {"stats": fe.stats(), "latency": fe.latency_snapshot(),
                "signals": fe.signals(), "health": fe.health()}

    def trace_snapshot(self) -> dict:
        return self._fe().tracer.snapshot()

    def audit_probe(self, signature=None) -> dict:
        return self._fe().audit_probe(signature)


class ProcessReplica(ReplicaHandle):
    """Replica in a child process, reached over the pickle RPC.

    ``wire_config`` is the dict ``fleet._worker`` builds its frontend
    from: ``{"replica_id", "filter": (name, kwargs), "serve": {simple
    ServeConfig fields}, "chaos_spec", "chaos_seed"}`` — specs, not
    objects, because filters (closures) and armed FaultPlans (locks)
    don't pickle. Each replica parses its OWN chaos plan, so event
    streams stay deterministic per replica.
    """

    def __init__(
        self,
        replica_id: str,
        wire_config: dict,
        env: Optional[Dict[str, str]] = None,
        startup_timeout_s: float = 120.0,
        rpc_timeout_s: float = 60.0,
        rpc_op_timeout_s: float = 5.0,
        rpc_lock_timeout_s: float = 5.0,
    ):
        super().__init__(replica_id)
        self._wire_config = dict(wire_config, replica_id=replica_id)
        self._env = dict(env) if env is not None else None
        self._startup_timeout_s = startup_timeout_s
        self._rpc_timeout_s = rpc_timeout_s
        # Bounded control-plane RPCs (health, begin_drain, stats pulls):
        # previously hardcoded 5.0s constants — promoted to knobs
        # (FleetConfig.rpc_op_timeout_s / rpc_lock_timeout_s) so slow
        # deployments can widen the monitor's patience, and exported in
        # the fleet's stats()["fleet"] provenance.
        self._rpc_op_timeout_s = rpc_op_timeout_s
        self._rpc_lock_timeout_s = rpc_lock_timeout_s
        self._proc: Optional[subprocess.Popen] = None
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._lost = False
        self.pid: Optional[int] = None
        self.reattach_port: Optional[int] = None  # the worker's own
        #   listener for front-door crash recovery (continuity plane);
        #   None when the worker predates it or the grace is unarmed

    def _child_env(self) -> Dict[str, str]:
        # The port has no device runtime to steer through the
        # environment: the child's device rides the wire config
        # ("device"), and a deployment that gives each replica its own
        # card sets CUDA_VISIBLE_DEVICES in replica_env.
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        if self._env:
            env.update(self._env)
        return env

    def _launch(self, port: int) -> subprocess.Popen:
        """Spawn the worker process; returns the one that dials the
        parent RPC listener. A ``cpu_affinity`` in the wire config is
        the child's from its first instruction: the spawn runs on a
        throwaway thread pinned to those cores, whose mask the child
        inherits — so torch, imported with the worker's package before
        its main() runs, sizes its thread pools to it."""
        affinity = self._wire_config.get("cpu_affinity")
        if affinity and hasattr(os, "sched_setaffinity"):
            out: list = []

            def pinned():
                try:
                    os.sched_setaffinity(0, set(affinity))
                    out.append(self._popen(port))
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    out.append(e)

            t = threading.Thread(target=pinned,
                                 name=f"dvf-fleet-spawn-{self.id}")
            t.start()
            t.join()
            if isinstance(out[0], BaseException):
                raise out[0]
            return out[0]
        return self._popen(port)

    def _popen(self, port: int) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", "dvf_tpu_torch.fleet._worker",
             "--port", str(port), "--replica-id", self.id],
            env=self._child_env(),
            stdout=subprocess.DEVNULL,
            stderr=(None
                    if os.environ.get("DVF_FLEET_WORKER_STDERR") == "1"
                    else subprocess.DEVNULL),
            # close_fds=False keeps posix_spawn eligible: a restart
            # from a large parent (a loaded test suite, a long-lived
            # server with CUDA initialised) must not have to FORK the
            # whole address space just to exec a worker. The worker
            # dials its own socket and ignores inherited fds.
            close_fds=False,
        )

    def start(self) -> "ProcessReplica":
        listener = socket.socket()
        try:
            listener.bind(("127.0.0.1", 0))
            listener.listen(1)
            listener.settimeout(self._startup_timeout_s)
            port = listener.getsockname()[1]
            self._proc = self._launch(port)
            _LIVE_PROCS.add(self._proc)
            try:
                self._sock, _ = listener.accept()
            except socket.timeout:
                raise ReplicaLostError(
                    f"replica {self.id}: worker never connected within "
                    f"{self._startup_timeout_s:.0f}s (spawn failed?)")
        finally:
            listener.close()
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(self._startup_timeout_s)
        hello = recv_msg(self._sock)
        if not (isinstance(hello, tuple) and hello[0] == "hello"):
            raise ReplicaLostError(f"replica {self.id}: bad hello {hello!r}")
        self.pid = hello[1]
        send_msg(self._sock, ("config", self._wire_config))
        ready = recv_msg(self._sock)
        if not (isinstance(ready, tuple) and ready[0] == "ready"):
            raise ReplicaLostError(
                f"replica {self.id}: worker failed to start: {ready!r}")
        # Trailing extras dict since the continuity plane (the worker's
        # reattach listener port); a 2-tuple from an older worker still
        # reads as ready, just never adoptable.
        extras = ready[2] if len(ready) > 2 and isinstance(ready[2], dict) \
            else {}
        self.reattach_port = extras.get("reattach_port")
        self._sock.settimeout(self._rpc_timeout_s)
        self._lost = False
        self.state = HEALTHY
        self.started_at = time.monotonic()
        return self

    def adopt(self, pid: int, reattach_port: int) -> "ProcessReplica":
        """Re-attach to a still-running worker left behind by a crashed
        front door (continuity plane): dial the worker's own reattach
        listener instead of spawning. No ``Popen`` exists for an
        adopted child — liveness degrades to a signal-0 probe and stop
        falls back to a pid wait + SIGKILL."""
        sock = socket.create_connection(
            ("127.0.0.1", int(reattach_port)),
            timeout=min(self._startup_timeout_s, 10.0))
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(min(self._startup_timeout_s, 10.0))
            send_msg(sock, ("adopt", self.id))
            reply = recv_msg(sock)
            if not (isinstance(reply, tuple) and reply[0] == "adopted"):
                raise ReplicaLostError(
                    f"replica {self.id}: adoption refused: {reply!r}")
        except Exception:
            try:
                sock.close()
            except OSError:
                pass
            raise
        self.pid = int(pid)
        self.reattach_port = int(reattach_port)
        self._proc = None
        self._sock = sock
        self._sock.settimeout(self._rpc_timeout_s)
        self._lost = False
        self.state = HEALTHY
        self.started_at = time.monotonic()
        return self

    def abandon(self) -> None:
        """Front-door crash simulation (FleetFrontend.crash): drop the
        RPC channel and FORGET the child without a stop op — the worker
        sees a parent loss and waits on its reattach listener for the
        next front-door incarnation to adopt it."""
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._proc = None
        self.state = DEAD

    def stop(self, timeout: float = 10.0) -> None:
        self.state = DEAD
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.settimeout(min(timeout, self._rpc_op_timeout_s))
                send_msg(sock, ("stop",))
                recv_msg(sock)
            except Exception:  # noqa: BLE001 — it may already be dead
                pass
            try:
                sock.close()
            except OSError:
                pass
        proc, self._proc = self._proc, None
        if proc is not None:
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        elif self.pid is not None:
            # Adopted child: no Popen to reap — wait for the pid to
            # exit on its own stop, then escalate to SIGKILL. When the
            # worker is OUR child (in-process crash simulation: the
            # same process abandoned and re-adopted it), it zombifies
            # until reaped, and a zombie still answers signal 0 — so
            # try waitpid first and fall back to the signal-0 probe for
            # true cross-process adoption (init reaps that one).
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                try:
                    done, _ = os.waitpid(self.pid, os.WNOHANG)
                    if done == self.pid:
                        return
                except ChildProcessError:
                    if not pid_alive(self.pid):
                        return
                except OSError:
                    return
                time.sleep(0.05)
            try:
                os.kill(self.pid, 9)
            except OSError:
                pass

    def restart(self) -> None:
        self.stop(timeout=5.0)
        self.start()
        self.restarts += 1  # counted on SUCCESS only: the router's
        #   restart budget bounds replica loss events, not respawn
        #   attempts that never produced a replica

    def kill(self) -> None:
        # Real hard loss (state untouched — the router's monitor owns
        # lifecycle and must still handle this as a fresh loss).
        self._lost = True
        if self._proc is not None:
            try:
                self._proc.kill()
            except OSError:
                pass
        elif self.pid is not None:   # adopted child: kill by pid
            try:
                os.kill(self.pid, 9)
            except OSError:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def alive(self) -> bool:
        if self._lost:
            return False
        if self._proc is not None:
            return self._proc.poll() is None
        # Adopted child (no Popen): the connected RPC socket plus a
        # signal-0 probe stand in for poll().
        return (self._sock is not None and self.pid is not None
                and pid_alive(self.pid))

    def _rpc(self, op: Tuple, timeout: Optional[float] = None,
             lock_timeout: Optional[float] = None) -> Any:
        # The channel lock serializes ops on the one socket. A bounded
        # lock_timeout keeps the health monitor's short-timeout probe
        # honest: a submit's sendall against a non-draining worker can
        # hold the lock for up to rpc_timeout_s, and the monitor must
        # not be wedged behind it (a busy channel reads as "try next
        # tick", not as replica loss — the blocked submit itself will
        # classify a truly dead worker within its own socket timeout).
        if lock_timeout is not None:
            if not self._lock.acquire(timeout=lock_timeout):
                raise TimeoutError(
                    f"replica {self.id}: channel busy for "
                    f"{lock_timeout:.1f}s (op {op[0]!r} skipped)")
        else:
            self._lock.acquire()
        try:
            if self._lost or self._sock is None:
                raise ReplicaLostError(f"replica {self.id} is lost")
            try:
                if timeout is not None:
                    self._sock.settimeout(timeout)
                send_msg(self._sock, op)
                reply = recv_msg(self._sock)
            except (OSError, ConnectionError, EOFError,
                    pickle.UnpicklingError) as e:
                self._lost = True
                raise ReplicaLostError(
                    f"replica {self.id}: RPC {op[0]!r} failed: {e!r}")
            finally:
                if timeout is not None and self._sock is not None:
                    try:
                        self._sock.settimeout(self._rpc_timeout_s)
                    except OSError:
                        pass
        finally:
            self._lock.release()
        if reply[0] == "ok":
            return reply[1]
        if reply[0] == "err":
            raise_wire_error(reply[1], reply[2])
        raise ReplicaLostError(f"replica {self.id}: bad reply {reply[0]!r}")

    def _send_only(self, op: Tuple) -> None:
        """Fire-and-forget op (no reply): the hot submit path. Waiting
        for a reply would serialize every frame on the worker's GIL
        latency (~one thread-switch interval per frame — measured 5 ms,
        an order of magnitude over the wire cost); the socket itself is
        the backpressure — a slow worker fills its buffers and sendall
        blocks. Replica-side errors are counted there and surface
        through ``health()``/``stats`` (``submit_errors``) instead of a
        per-frame ack; frame loss is already accounted by the fleet's
        index-gap arithmetic (submitted − delivered)."""
        with self._lock:
            if self._lost or self._sock is None:
                raise ReplicaLostError(f"replica {self.id} is lost")
            try:
                send_msg(self._sock, op)
            except (OSError, ConnectionError) as e:
                self._lost = True
                raise ReplicaLostError(
                    f"replica {self.id}: send {op[0]!r} failed: {e!r}")

    def open_stream(self, session_id, slo_ms=None, frame_shape=None,
                    frame_dtype=None, op_chain=None, tier=None) -> str:
        # 7-tuple since the control plane (trailing tier); a 6-tuple
        # from an older parent still opens at the worker's default tier.
        return self._rpc(("open", session_id, slo_ms, frame_shape,
                          str(frame_dtype) if frame_dtype is not None
                          else None, op_chain, tier))

    def submit(self, session_id, frame, ts=None, tag=None) -> None:
        self._send_only(("submit1", session_id, frame, ts, tag))

    def poll(self, session_id, max_items=None, meta_only=False) -> list:
        return self._rpc(("poll", session_id, max_items, meta_only))

    def close(self, session_id, drain=True) -> None:
        self._rpc(("close", session_id, drain))

    def release(self, session_id) -> None:
        self._rpc(("release", session_id))

    def drain(self, timeout: float = 30.0) -> bool:
        return self._rpc(("drain", timeout), timeout=timeout + 10.0)

    def session_drained(self, session_id) -> bool:
        return self._rpc(("session_drained", session_id))

    def begin_drain(self) -> None:
        self._rpc(("begin_drain",), timeout=self._rpc_op_timeout_s,
                  lock_timeout=self._rpc_lock_timeout_s)

    def health(self) -> dict:
        # Short timeouts on BOTH the socket and the channel lock: the
        # monitor polls this at hertz rates and must never sit behind a
        # slow submit for the full RPC budget (TimeoutError = "busy,
        # retry next tick"; liveness and the submit path's own socket
        # timeout still catch real deaths).
        t0 = time.time()
        out = self._rpc(("health",), timeout=self._rpc_op_timeout_s,
                        lock_timeout=self._rpc_lock_timeout_s)
        t1 = time.time()
        if isinstance(out, dict):
            wall = out.get("wall_time_s")
            # RPC-midpoint clock-offset estimate (NTP's trick): the
            # worker stamped its wall clock somewhere inside [t0, t1];
            # the midpoint bounds the error by half the round trip.
            # GATED on that round trip: a health RPC that waited
            # seconds behind a busy submit (the channel lock allows up
            # to 5 s) would poison the offset by up to half that wait,
            # garbling every lineage re-base until the next tick —
            # keep the previous estimate and wait for a clean probe.
            if wall is not None and (t1 - t0) <= 0.25:
                self.clock_offset_s = wall - (t0 + t1) / 2.0
        return out

    def stats_full(self) -> dict:
        # Bounded on the CHANNEL LOCK only: a stats pull queued behind a
        # busy submit degrades to TimeoutError — "no export this tick"
        # at the caller — without touching the socket. The socket keeps
        # the default rpc_timeout_s deliberately: a mid-flight socket
        # timeout desynchronizes the serial channel (the late reply
        # would answer the NEXT request), so it must keep meaning
        # replica loss — and a scrape must not be able to declare a
        # merely-slow replica dead.
        return self._rpc(("stats",),
                         lock_timeout=self._rpc_lock_timeout_s)

    def trace_snapshot(self) -> dict:
        # Same bound discipline as stats_full: busy channel → benign
        # TimeoutError (one skipped lane); socket-level death → loss.
        # Dump pulls run off the monitor/loss paths (router dumps are
        # off-thread), so the worst case blocks a dump thread, not
        # supervision.
        return self._rpc(("trace",),
                         lock_timeout=self._rpc_lock_timeout_s)

    def audit_probe(self, signature=None) -> dict:
        # Bounded like the monitor's health probe: a divergence check
        # runs at the monitor's cadence and must degrade to "replica
        # unprobeable this round" behind a busy submit, never wedge.
        return self._rpc(("audit_probe", signature),
                         lock_timeout=self._rpc_lock_timeout_s)


def live_worker_processes() -> List[subprocess.Popen]:
    """Still-running replica child processes (the conftest leak guard)."""
    return [p for p in list(_LIVE_PROCS) if p.poll() is None]
