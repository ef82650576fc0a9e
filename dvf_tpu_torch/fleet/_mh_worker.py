"""Multi-host replica worker: one member of a process group (port of
``dvf_tpu.fleet._mh_worker``).

Spawned by ``fleet.multihost.MultiHostReplica`` as

    python -m dvf_tpu_torch.fleet._mh_worker --parent-port P --peer-port Q \\
        --coordinator 127.0.0.1:C --num-processes H --process-id i \\
        --replica-id rN

with the replica's pinned signature in the ``DVF_MH_CONFIG`` env var
(JSON: op_chain / frame_shape / frame_dtype / batch_size / slo_ms /
device — env, not a handshake, because every group member needs it
BEFORE the lockstep engine compile, and only the leader ever talks to
the parent).

All members bring up ONE program: ``parallel.distributed.
init_distributed`` (a gloo group; rank *i* on ``cuda:{i % device_count}``,
or on the CPU when the fleet runs there), a global ``data=H`` mesh, and a
:class:`~dvf_tpu_torch.fleet.multiproc.MultiHostEngine` compiled for the
global batch. Process 0 — the LEADER — additionally speaks the replica
RPC to the fleet front door (the same pickle protocol as
``fleet._worker``: open/submit1/poll/close/drain/health/stats) and owns
the group's data plane: client frames queue leader-side, a batch thread
slices each global batch into per-process row intervals (computed from
the compiled sharding's ``devices_indices_map`` — never assumed),
ships peers their shards over localhost sockets, contributes its own
via ``submit_local`` (its all_reduce meets the group), gathers
the peers' output rows, and reassembles the global result in row
order. Peers run the five-line lockstep loop at the bottom.

Serving here is deliberately lean — one signature, FIFO batching, no
per-session SLO scheduling: a multihost replica exists to make ONE
heavy program wider (the controller's bigger-replica axis), not to
re-implement the single-host frontend's multi-tenant machinery. Peer
loss mid-collective surfaces as a failed ``submit_local``
(`parallel.distributed.is_peer_loss`): the leader marks itself
unhealthy, the fleet drains and respawns the whole group — replica-
granular supervision, exactly the router's existing loss domain.

Every member ends with ``os._exit``: a process group with a dead peer
can hang in its shutdown.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import threading
import time


def _peer_loss(exc: BaseException) -> bool:
    from dvf_tpu_torch.parallel.distributed import is_peer_loss

    return is_peer_loss(exc)


class _MhSession:
    __slots__ = ("sid", "queue", "out", "next_index", "submitted",
                 "delivered", "closed")

    def __init__(self, sid: str, queue_size: int, out_queue_size: int):
        self.sid = sid
        self.queue: "collections.deque" = collections.deque(
            maxlen=queue_size)  # drop-oldest ingress (serve's contract)
        self.out: "collections.deque" = collections.deque(
            maxlen=out_queue_size)  # bounded like ServeConfig.
        #   out_queue_size: a slow poller drops its OLDEST deliveries
        #   (freshness-first) instead of growing leader memory per frame
        self.next_index = 0
        self.submitted = 0
        self.delivered = 0
        self.closed = False


class _Leader:
    """The group leader's serving state (RPC loop + batch thread)."""

    def __init__(self, engine, cfg: dict, peers: list, intervals: dict):
        from dvf_tpu_torch.obs.metrics import LatencyStats
        from dvf_tpu_torch.runtime.signature import make_key

        self.engine = engine
        self.cfg = cfg
        self.peers = peers              # [(process_id, socket)]
        self.intervals = intervals      # process_id -> [(start, stop)]
        self.key_render = make_key(
            cfg["op_chain"], tuple(cfg["frame_shape"]),
            cfg["frame_dtype"]).render()
        self.latency = LatencyStats()
        self.sessions: dict = {}
        self.lock = threading.Lock()
        self.draining = False
        self.error: str | None = None
        self.submit_errors = 0
        self.batches = 0
        self.frames = 0
        self.seq = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._batch_loop, name="dvf-mh-batch", daemon=True)
        self._thread.start()

    # -- client ops (RPC loop thread) -------------------------------------

    def open_stream(self, sid, slo_ms=None, frame_shape=None,
                    frame_dtype=None, op_chain=None, tier=None):
        from dvf_tpu_torch.runtime.signature import make_key
        from dvf_tpu_torch.serve.session import AdmissionError

        del slo_ms, tier  # lean tier: FIFO over one signature
        with self.lock:
            if self.draining:
                raise AdmissionError("multihost replica is draining")
            if self.error is not None:
                raise AdmissionError(
                    f"multihost replica failed: {self.error}")
            if frame_shape is not None or op_chain is not None:
                want = make_key(
                    op_chain if op_chain is not None
                    else self.cfg["op_chain"],
                    tuple(frame_shape) if frame_shape is not None
                    else tuple(self.cfg["frame_shape"]),
                    frame_dtype if frame_dtype is not None
                    else self.cfg["frame_dtype"]).render()
                if want != self.key_render:
                    raise AdmissionError(
                        f"multihost replica serves ONE signature "
                        f"{self.key_render}; declared {want}")
            if sid in self.sessions:
                raise AdmissionError(f"session id {sid!r} already exists")
            self.sessions[sid] = _MhSession(
                sid, int(self.cfg.get("queue_size") or 64),
                int(self.cfg.get("out_queue_size") or 1024))
        return sid

    def submit(self, sid, frame, ts=None, tag=None) -> None:
        with self.lock:
            s = self.sessions.get(sid)
            if s is None or s.closed:
                raise KeyError(f"unknown session {sid!r}")
            s.queue.append((frame, ts if ts is not None else time.time(),
                            tag))
            s.submitted += 1

    def poll(self, sid, max_items=None, meta_only=False) -> list:
        with self.lock:
            s = self.sessions.get(sid)
            if s is None:
                raise KeyError(f"unknown session {sid!r}")
            n = len(s.out) if max_items is None else min(max_items,
                                                         len(s.out))
            got = [s.out.popleft() for _ in range(n)]
        if meta_only:
            got = [d._replace(frame=None) for d in got]
        return got

    def close(self, sid, drain=True) -> None:
        with self.lock:
            s = self.sessions.get(sid)
            if s is None:
                raise KeyError(f"unknown session {sid!r}")
            s.closed = True
            if not drain:
                s.queue.clear()

    def release(self, sid) -> None:
        with self.lock:
            self.sessions.pop(sid, None)

    def audit_probe(self, signature=None) -> dict:
        """Cross-replica divergence probe (obs.audit): the deterministic
        probe frame through the GROUP's own data plane — an internal
        one-frame session, so the digest covers exactly what a tenant
        would receive from this replica (shards shipped to peers, the
        collective, global-row reassembly and all). The probe tag is
        the canonical op_chain, matching the single-host flavor's
        ``engine_probe_row`` tag, so digests compare across flavors."""
        import numpy as np

        from dvf_tpu_torch.obs.audit import frame_digest, probe_frame
        from dvf_tpu_torch.serve.session import ServeError

        if signature is not None and signature != self.key_render:
            raise ServeError(
                f"multihost replica serves ONE signature "
                f"{self.key_render}; asked to probe {signature!r}")
        shape = tuple(self.cfg["frame_shape"])
        dtype = np.dtype(self.cfg["frame_dtype"])
        frame = probe_frame(shape, dtype, tag=self.cfg["op_chain"])
        sid = f"__audit_probe_{self.seq}_{time.monotonic_ns()}__"
        self.open_stream(sid)
        try:
            self.submit(sid, frame)
            deadline = time.time() + 15.0
            got: list = []
            while not got and time.time() < deadline:
                got = self.poll(sid, max_items=1)
                if not got:
                    time.sleep(0.01)
            if not got:
                raise ServeError("multihost audit probe timed out "
                                 "(group data plane not serving)")
            return {"signature": self.key_render,
                    "digest": frame_digest(
                        np.ascontiguousarray(got[0].frame)).hex()}
        finally:
            try:
                self.close(sid, drain=False)
                self.release(sid)
            except Exception:  # noqa: BLE001 — probe cleanup best-effort
                pass

    def begin_drain(self) -> None:
        with self.lock:
            self.draining = True

    def drain(self, timeout: float = 30.0) -> bool:
        self.begin_drain()
        with self.lock:
            for s in self.sessions.values():
                s.closed = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self.lock:
                if not any(s.queue for s in self.sessions.values()):
                    return True
            if self.error is not None:
                return False
            time.sleep(0.01)
        return False

    # -- exports ----------------------------------------------------------

    def health(self) -> dict:
        with self.lock:
            open_n = sum(1 for s in self.sessions.values() if not s.closed)
            qd = float(sum(len(s.queue) for s in self.sessions.values()))
        p = self.latency.percentiles((99,))
        p99 = p.get("p99_ms")
        return {
            "ok": self.error is None,
            "error": self.error,
            "draining": self.draining,
            "open_sessions": open_n,
            "recoveries": 0,
            "fault_total": self.submit_errors,
            "stalls": 0,
            "warm_signatures": [self.key_render],
            "submit_errors": self.submit_errors,
            "wall_time_s": time.time(),
            "load": {
                "open_sessions": float(open_n),
                "queue_depth": qd,
                "p99_ms": p99 if p99 == p99 else None,
                "delivered_total": float(sum(
                    s.delivered for s in self.sessions.values())),
                "shed_total": 0.0,
                "slo_miss_total": 0.0,
                "admission_rejections_total": 0.0,
            },
        }

    def stats(self) -> dict:
        h = self.health()
        with self.lock:
            sessions = {
                sid: {"submitted": s.submitted, "delivered": s.delivered,
                      "queued": len(s.queue),
                      "state": "closed" if s.closed else "open"}
                for sid, s in self.sessions.items()
            }
        return {
            "stats": {
                "flavor": "multihost",
                "hosts": int(self.cfg["hosts"]),
                "engine_batches": self.batches,
                "engine_frames": self.frames,
                "open_sessions": h["open_sessions"],
                "queue_depth": h["load"]["queue_depth"],
                "errors": self.submit_errors,
                "recoveries": 0,
                "faults": {"by_kind": {}},
                "sessions": sessions,
                "aggregate": self.latency.summary(),
            },
            "latency": self.latency.snapshot(),
            "signals": {
                "delivered_total": h["load"]["delivered_total"],
                "queue_depth": h["load"]["queue_depth"],
            },
            "health": h,
        }

    # -- the data plane (batch thread) ------------------------------------

    def _batch_loop(self) -> None:
        import numpy as np

        from dvf_tpu_torch.fleet.replica import recv_msg, send_msg
        from dvf_tpu_torch.serve.session import Delivery

        cfg = self.cfg
        shape = tuple(cfg["frame_shape"])
        b_global = int(cfg["batch_global"])
        dtype = np.dtype(self.engine._signature[1])
        while not self._stop.is_set():
            if self.error is not None:
                return
            slots = []   # (session, local_index, ts, tag)
            with self.lock:
                live = [s for s in self.sessions.values() if s.queue]
                while live and len(slots) < b_global:
                    nxt = []
                    for s in live:         # round-robin fairness
                        if len(slots) >= b_global:
                            break
                        frame, ts, tag = s.queue.popleft()
                        slots.append((s, s.next_index, frame, ts, tag))
                        s.next_index += 1
                        if s.queue:
                            nxt.append(s)
                    live = nxt
            if not slots:
                time.sleep(0.002)
                continue
            batch = np.zeros((b_global, *shape), dtype)
            for row, (_, _, frame, _, _) in enumerate(slots):
                batch[row] = frame
            self.seq += 1
            try:
                # Peers first (their shards must be in flight before the
                # collective blocks this thread), then our own share.
                for pid, sock in self.peers:
                    send_msg(sock, ("batch", self.seq,
                                    self._rows(batch, pid)))
                local_out = np.asarray(self.engine.submit_local(
                    self._rows(batch, 0)))
                outs = {0: local_out}
                for pid, sock in self.peers:
                    reply = recv_msg(sock)
                    if reply[0] != "out" or reply[1] != self.seq:
                        raise ConnectionError(
                            f"peer {pid} desynchronized: {reply[:2]!r}")
                    outs[pid] = reply[2]
            except Exception as e:  # noqa: BLE001 — peer loss or wire
                # death: the group is broken as a unit; the fleet
                # replaces the whole replica (drain → respawn).
                self.submit_errors += len(slots)
                self.error = (f"group collective failed: {e!r}"
                              + (" [peer loss]" if _peer_loss(e) else ""))
                return
            out_global = np.empty((b_global, *local_out.shape[1:]),
                                  local_out.dtype)
            for pid, rows in outs.items():
                cursor = 0
                for start, stop in self.intervals[pid]:
                    out_global[start:stop] = rows[cursor:cursor
                                                  + (stop - start)]
                    cursor += stop - start
            now = time.time()
            with self.lock:
                for row, (s, idx, _, ts, tag) in enumerate(slots):
                    lat_s = max(0.0, now - ts)
                    self.latency.record(lat_s)
                    s.out.append(Delivery(
                        index=idx,
                        frame=np.ascontiguousarray(out_global[row]),
                        capture_ts=ts, latency_ms=lat_s * 1e3, tag=tag))
                    s.delivered += 1
                self.batches += 1
                self.frames += len(slots)

    def _rows(self, batch, pid: int):
        import numpy as np

        parts = [batch[start:stop] for start, stop in self.intervals[pid]]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


def _proc_intervals(sharding, shape, n_procs: int) -> dict:
    """Per-process batch-row intervals under the compiled sharding —
    computed, never assumed (the device order is the mesh's business).
    Distinct positions holding one interval dedupe (replicated layouts);
    intervals come back sorted so slicing is in global row order."""
    from dvf_tpu_torch.parallel.distributed import process_row_intervals

    by_proc = process_row_intervals(sharding, shape)
    return {pid: by_proc.get(pid, []) for pid in range(n_procs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-port", type=int, default=0)
    ap.add_argument("--peer-port", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--replica-id", default="r?")
    args = ap.parse_args(argv)
    cfg = json.loads(os.environ["DVF_MH_CONFIG"])

    import socket

    from dvf_tpu_torch.fleet.replica import recv_msg, send_msg

    leader = args.process_id == 0
    parent = None
    peer_listener = None
    try:
        if leader:
            # Bind the data-plane listener BEFORE the distributed init:
            # peers connect right after their init returns, and init
            # itself only completes once every member (us included) has
            # joined — bind-early makes the two rendezvous independent.
            peer_listener = socket.socket()
            peer_listener.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEADDR, 1)
            peer_listener.bind((args.host, args.peer_port))
            peer_listener.listen(args.num_processes)
            peer_listener.settimeout(120.0)
            parent = socket.create_connection(
                (args.host, args.parent_port), timeout=30)
            parent.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            send_msg(parent, ("hello", os.getpid()))
            op = recv_msg(parent)
            if op[0] != "config":
                send_msg(parent, ("err", "ServeError",
                                  f"expected config, got {op[0]!r}"))
                return 2

        try:
            import numpy as np

            from dvf_tpu_torch.fleet.multiproc import MultiHostEngine
            from dvf_tpu_torch.parallel.distributed import init_distributed
            from dvf_tpu_torch.parallel.mesh import MeshConfig
            from dvf_tpu_torch.runtime.signature import build_filter

            device = cfg.get("device") or "cuda"
            if not init_distributed(
                    args.coordinator, args.num_processes, args.process_id,
                    device="cpu" if device == "cpu" else "cuda"):
                raise RuntimeError("init_distributed returned False "
                                   "(no coordinator address)")
            engine = MultiHostEngine(
                build_filter(cfg["op_chain"]),
                MeshConfig(data=args.num_processes))
            shape = (int(cfg["batch_global"]), *cfg["frame_shape"])
            engine.compile(shape, dtype=np.dtype(cfg["frame_dtype"]))
        except Exception as e:  # noqa: BLE001 — bring-up failure: the
            # leader reports it to the parent; peers just exit (the
            # leader's init fails with them, or times out)
            if leader and parent is not None:
                try:
                    send_msg(parent, ("err", type(e).__name__, str(e)))
                except Exception:  # noqa: BLE001
                    pass
            return 2

        if not leader:
            sock = socket.create_connection(
                (args.host, args.peer_port), timeout=120)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            send_msg(sock, ("join", args.process_id))
            # The lockstep loop: one shard in, one collective, one
            # shard out. A closed leader socket is the exit signal.
            while True:
                try:
                    msg = recv_msg(sock)
                except (ConnectionError, OSError):
                    return 0
                if msg[0] == "stop":
                    return 0
                _, seq, rows = msg
                out = engine.submit_local(rows)
                send_msg(sock, ("out", seq, np.asarray(out)))

        # -- leader: accept peers, then serve the replica RPC ------------
        peers = []
        for _ in range(args.num_processes - 1):
            psock, _ = peer_listener.accept()
            psock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            join = recv_msg(psock)
            if join[0] != "join":
                raise RuntimeError(f"bad peer join {join!r}")
            peers.append((join[1], psock))
        peers.sort()
        intervals = _proc_intervals(engine._sharding, shape,
                                    args.num_processes)
        srv = _Leader(engine, cfg, peers, intervals)
        send_msg(parent, ("ready", os.getpid()))

        while True:
            try:
                op = recv_msg(parent)
            except (ConnectionError, OSError):
                break  # parent went away: shut down with it
            kind = op[0]
            if kind == "submit1":
                _, sid, frame, ts, tag = op
                try:
                    srv.submit(sid, frame, ts=ts, tag=tag)
                except Exception as e:  # noqa: BLE001 — freshness-first
                    srv.submit_errors += 1
                    print(f"[mh-worker] submit dropped: {e!r}",
                          file=sys.stderr, flush=True)
                continue
            try:
                if kind == "stop":
                    send_msg(parent, ("ok", None))
                    break
                elif kind == "open":
                    _, sid, slo_ms, frame_shape, frame_dtype = op[:5]
                    out = srv.open_stream(
                        sid, slo_ms=slo_ms, frame_shape=frame_shape,
                        frame_dtype=frame_dtype or None,
                        op_chain=op[5] if len(op) > 5 else None,
                        tier=op[6] if len(op) > 6 else None)
                elif kind == "poll":
                    _, sid, max_items, meta_only = op
                    out = srv.poll(sid, max_items, meta_only=meta_only)
                elif kind == "close":
                    out = srv.close(op[1], drain=op[2])
                elif kind == "release":
                    out = srv.release(op[1])
                elif kind == "drain":
                    out = srv.drain(timeout=op[1])
                elif kind == "begin_drain":
                    out = srv.begin_drain()
                elif kind == "health":
                    out = srv.health()
                elif kind == "stats":
                    out = srv.stats()
                elif kind == "audit_probe":
                    out = srv.audit_probe(op[1] if len(op) > 1 else None)
                elif kind == "trace":
                    out = {"events": []}  # lean tier: no tracer lanes
                else:
                    raise ValueError(f"unknown replica op {kind!r}")
            except Exception as e:  # noqa: BLE001 — op errors cross the
                send_msg(parent, ("err", type(e).__name__, str(e)))
                continue
            send_msg(parent, ("ok", out))
        srv.stop()
        for _, psock in peers:
            try:
                send_msg(psock, ("stop",))
                psock.close()
            except OSError:
                pass
    finally:
        for s in (parent, peer_listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
