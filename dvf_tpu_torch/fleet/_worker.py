"""Replica worker process: one ServeFrontend behind a pickle RPC (port
of ``dvf_tpu.fleet._worker``).

Spawned by ``fleet.replica.ProcessReplica`` as

    python -m dvf_tpu_torch.fleet._worker --port P --replica-id rN

The child connects back to the parent's listener (no open ports of its
own), receives the wire config (filter spec + ServeConfig fields + chaos
spec + device — specs, not objects; see ProcessReplica), builds and
starts the frontend, and then serves RPCs single-threaded: the
frontend's own dispatch/collect threads do the concurrent work, so one
request loop is enough, and it makes replica-side op ordering trivially
serial.

The frontend runs on the wire config's ``"device"`` (``cuda:0`` unless
the fleet was asked for the CPU). A child asked for a card on a machine
without CUDA answers ``("err", ...)``, so the parent's ``start()``
raises: it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys


def _serve_config(fields: dict, chaos_spec, chaos_seed: int,
                  replica_id: str):
    from dvf_tpu_torch.serve import ServeConfig

    chaos = None
    if chaos_spec:
        from dvf_tpu_torch.resilience import FaultPlan

        chaos = FaultPlan.parse(chaos_spec, seed=chaos_seed)
    return ServeConfig(**fields, chaos=chaos, replica_label=replica_id)


def _await_adoption(reattach, grace_s: float, replica_id: str):
    """Parent lost mid-serve: wait up to ``grace_s`` on the reattach
    listener for a restarted front door to adopt this worker
    (continuity plane). The worker keeps its frontend — and
    every open session's queued deliveries — warm for the whole grace
    window. Returns the adopted RPC socket, or None (grace unarmed /
    expired / bad handshake): the caller shuts down."""
    if reattach is None or grace_s <= 0:
        return None
    import socket

    from dvf_tpu_torch.fleet.replica import recv_msg, send_msg

    reattach.settimeout(grace_s)
    try:
        sock, _ = reattach.accept()
    except OSError:   # timeout included: orphaned for good
        return None
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(10)
        hello = recv_msg(sock)
        if not (isinstance(hello, tuple) and len(hello) >= 2
                and hello[0] == "adopt" and hello[1] == replica_id):
            send_msg(sock, ("err", "ServeError",
                            f"adoption refused: {hello!r}"))
            sock.close()
            return None
        send_msg(sock, ("adopted", os.getpid()))
        sock.settimeout(None)
        return sock
    except Exception:  # noqa: BLE001 — a bad suitor, not a shutdown
        try:
            sock.close()
        except OSError:
            pass
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--replica-id", default="r?")
    args = ap.parse_args(argv)

    import socket

    from dvf_tpu_torch.fleet.replica import recv_msg, send_msg

    sock = socket.create_connection((args.host, args.port), timeout=30)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    frontend = None
    reattach = None
    try:
        send_msg(sock, ("hello", os.getpid()))
        op = recv_msg(sock)
        if op[0] != "config":
            send_msg(sock, ("err", "ServeError", f"expected config, got {op[0]!r}"))
            return 2
        cfg = op[1]
        # cfg["cpu_affinity"] is already this process's mask: the parent
        # spawned it from a thread pinned to those cores, before torch
        # (imported with this package) sized its thread pools.
        try:
            from dvf_tpu_torch.ops import get_filter
            from dvf_tpu_torch.serve import ServeFrontend

            name, kwargs = cfg["filter"]
            device = cfg.get("device") or "cuda:0"
            frontend = ServeFrontend(
                get_filter(name, **(kwargs or {})),
                _serve_config(cfg.get("serve", {}), cfg.get("chaos_spec"),
                              cfg.get("chaos_seed", 0),
                              cfg.get("replica_id", args.replica_id)),
                device=device,
            ).start()
            if cfg.get("precompile"):
                # AOT warm-start before taking traffic (also runs on a
                # RESPAWN — wire_config persists, so a replaced replica
                # comes back warm through the persistent cache).
                frontend.precompile(cfg["precompile"])
        except Exception as e:  # noqa: BLE001 — startup failure → parent
            send_msg(sock, ("err", type(e).__name__, str(e)))
            return 2
        # Continuity plane: with a reattach grace armed (the fleet sets
        # it when its snapshot plane is on), bind our OWN listener so a
        # restarted front door can adopt this worker instead of losing
        # every session with the old one. The port rides the ready
        # tuple's trailing extras dict (older parents only read
        # ready[0]).
        grace_s = float(cfg.get("reattach_grace_s") or 0.0)
        replica_id = cfg.get("replica_id", args.replica_id)
        extras = {}
        if grace_s > 0:
            reattach = socket.socket()
            reattach.bind((args.host, 0))
            reattach.listen(1)
            extras["reattach_port"] = reattach.getsockname()[1]
            # Parent loss must surface as EOF/RST (the kernel closes a
            # killed front door's sockets promptly), never as an idle-
            # timeout false positive that abandons a live parent.
            sock.settimeout(None)
        send_msg(sock, ("ready", os.getpid(), extras))
        submit_errors = 0

        while True:
            try:
                op = recv_msg(sock)
            except (ConnectionError, OSError):
                try:
                    sock.close()
                except OSError:
                    pass
                sock = _await_adoption(reattach, grace_s, replica_id)
                if sock is None:
                    break  # parent went away for good: shut down with it
                continue
            kind = op[0]
            if kind == "submit1":
                # One-way hot path: NO reply (the fleet index is parent-
                # assigned; an ack would serialize every frame on this
                # loop's GIL latency). Errors are counted and exported
                # via health/stats — the frames themselves are covered
                # by at-most-once accounting.
                _, sid, frame, ts, tag = op
                try:
                    frontend.submit(sid, frame, ts=ts, tag=tag)
                except Exception as e:  # noqa: BLE001 — freshness-first
                    submit_errors += 1
                    print(f"[fleet-worker] submit dropped: {e!r}",
                          file=sys.stderr, flush=True)
                continue
            try:
                if kind == "stop":
                    send_msg(sock, ("ok", None))
                    break
                elif kind == "open":
                    # 6-tuple since the multi-signature frontend (the
                    # trailing op_chain), 7-tuple since the control
                    # plane (trailing tier); shorter tuples from an
                    # older parent still open on the default bucket at
                    # the default tier.
                    _, sid, slo_ms, frame_shape, frame_dtype = op[:5]
                    op_chain = op[5] if len(op) > 5 else None
                    tier = op[6] if len(op) > 6 else None
                    # The dtype crosses the wire as its original
                    # SPELLING; the frontend canonicalizes (np.dtype
                    # here would read "u8" as uint64).
                    out = frontend.open_stream(
                        session_id=sid, slo_ms=slo_ms,
                        frame_shape=frame_shape,
                        frame_dtype=frame_dtype or None,
                        op_chain=op_chain, tier=tier)
                elif kind == "poll":
                    _, sid, max_items, meta_only = op
                    got = frontend.poll(sid, max_items)
                    out = ([d._replace(frame=None) for d in got]
                           if meta_only else got)
                elif kind == "close":
                    _, sid, drain = op
                    out = frontend.close(sid, drain=drain)
                elif kind == "release":
                    out = frontend.release(op[1])
                elif kind == "drain":
                    out = frontend.drain(timeout=op[1])
                elif kind == "begin_drain":
                    out = frontend.begin_drain()
                elif kind == "session_drained":
                    out = frontend.session_drained(op[1])
                elif kind == "health":
                    import time as _time

                    # wall_time_s: the parent's clock-offset probe for
                    # per-frame lineage re-basing (ProcessReplica.health
                    # estimates offset from the RPC midpoint). load: the
                    # cheap per-replica load row the fleet monitor
                    # caches for its elastic view.
                    out = dict(frontend.health(),
                               submit_errors=submit_errors,
                               wall_time_s=_time.time(),
                               load=frontend.load_row())
                elif kind == "stats":
                    out = {"stats": frontend.stats(),
                           "latency": frontend.latency_snapshot(),
                           "signals": frontend.signals(),
                           "health": dict(frontend.health(),
                                          submit_errors=submit_errors)}
                elif kind == "audit_probe":
                    # Cross-replica divergence probe (obs.audit): the
                    # deterministic probe frame through this replica's
                    # compiled program — the digest the fleet compares.
                    out = frontend.audit_probe(op[1] if len(op) > 1
                                               else None)
                elif kind == "trace":
                    # The frontend tracer's bounded event window + epoch
                    # (plain values): the fleet's cross-process trace
                    # aggregation rides the same RPC as every other
                    # export. Capped to the most recent 20k events: the
                    # reply is pickled while the parent holds the serial
                    # channel lock, and a full 100k-event ring (tens of
                    # MB) would stall that replica's submit hot path for
                    # the whole transfer — mid-incident, when dumps fire.
                    out = frontend.tracer.snapshot(max_events=20_000)
                else:
                    raise ValueError(f"unknown replica op {kind!r}")
            except Exception as e:  # noqa: BLE001 — op errors cross the
                # wire by name; the loop itself keeps serving
                send_msg(sock, ("err", type(e).__name__, str(e)))
                continue
            send_msg(sock, ("ok", out))
    finally:
        if frontend is not None:
            try:
                frontend.stop(timeout=5.0)
            except Exception:  # noqa: BLE001 — exit-path best effort
                pass
        for s in (sock, reattach):
            try:
                if s is not None:
                    s.close()
            except OSError:
                pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
