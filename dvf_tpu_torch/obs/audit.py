"""The audit plane: end-to-end frame integrity, proven continuously
(port of ``dvf_tpu.obs.audit``).

The wire envelope, the digests, the probe frames, the sampler and every
document are the reference's byte for byte. What differs is the golden:
:func:`golden_execute` re-runs the bucket's filter EAGERLY in torch on a
batch of one on the engine's device, so on a card its hand kernels (the
separable blur, the Sobel→bilateral chain) launch once per replay; on
the CPU the same code runs their plain versions. The replay worker and
the swap guard launch on a stream of the plane's own per device, never
on the legacy default stream (which every engine stream would
synchronize with).

The reference's account of the plane follows.

The fourth observability plane. The stage metrics answer "how fast",
the frame lineage "where did one frame's latency go", the
reconfiguration ledger "what did every program change cost" — and every one of them measures *time and memory*. None of them
verifies that the delivered pixels are CORRECT. This module does: a
serving fleet that composites deltas onto cached references, adopts and
kills replicas mid-stream, and substitutes freshly compiled programs on
the live path (resize / quality rebind / recovery rebuild — and the
hot swap multiplies that rate) needs online silent-corruption
detection the way it needed latency attribution. Four detectors, each
overhead-gated in the reference (its benchmarks/AUDIT_BENCH.json) and
chaos-proven (the ``corrupt_wire`` / ``corrupt_device`` injection
sites):

1. **Wire integrity** — an 8-byte blake2b content digest stamped into
   a tiny framed envelope at every encode hop and verified at every
   decode hop (ring queue, ZMQ worker, serve bridge; the envelope wraps
   the complete wire payload, so delta-codec inner/tile payloads are
   covered byte-for-byte). A mismatch raises
   :class:`WireIntegrityError` — a :class:`~dvf_tpu_torch.resilience
   .faults.FaultError` of the ``integrity`` kind, so the error budget
   and degradation ladders contain it like any other fault — catching the
   bit flip that still JPEG-decodes.
2. **Sampled shadow-replay** — a deterministic, seedable sampler picks
   every Kth staged frame; its input is retained, its DELIVERED output
   captured at collect, and a golden **eager** re-execution of the
   bucket's filter runs OFF the hot threads
   (:meth:`AuditPlane.submit_replay`). Bit-exact comparison for uint8
   chains, a pinned tolerance for float/learned ops. A mismatch is a
   CONFIRMED silent-corruption event carrying the frame's lineage and
   the ledger events that preceded it, and trips a flight dump.
3. **Cross-replica divergence** — the fleet periodically runs an
   identical deterministic probe frame through every replica warm on a
   signature and compares output digests
   (:class:`DivergenceDetector`); a diverging replica is flagged (and
   optionally quarantined through the existing ``retire_replica``
   seam).
4. **Program-swap equivalence guard** — every recompile adopted by a
   batch resize, quality rebind, or recovery rebuild runs the probe
   frame through the substituted program and compares against the
   golden path (and, where geometry allows, against the OLD program's
   output), ledgering the verdict (:meth:`AuditPlane.swap_guard`) —
   the acceptance instrument the atomic hot swap is judged against:
   zero unaudited program substitutions.

Export surfaces follow the established pattern: ``stats()["audit"]``,
``audit_*`` signals, ``dvf_audit_*`` registry samples
(:func:`attach_audit_provider`), the ``/audit`` endpoint
(`obs.export.MetricsExporter`), a dedicated Perfetto lane
(``TRACK_AUDIT``), and flight dumps gain ``audit.json``.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from dvf_tpu_torch.resilience.faults import FaultError, FaultKind

# The dedicated trace lane audit verdicts land on (serve stage lanes are
# 0..4, the reconfiguration ledger owns 6; 7 keeps clear of all).
TRACK_AUDIT = 7

# Wire envelope: magic(2) ver(1) flags(1) digest(8) | payload. The magic
# collides with neither the delta wire's b"\xd6W" nor a JPEG SOI.
AUDIT_WIRE_MAGIC = b"\xa8I"
AUDIT_WIRE_VERSION = 1
DIGEST_BYTES = 8
WIRE_HEADER_LEN = 4 + DIGEST_BYTES

# Swap-guard / replay verdicts (data, not an enum — they ride JSON).
VERDICT_MATCH = "match"
VERDICT_MISMATCH = "mismatch"
VERDICT_SKIPPED = "skipped"        # nothing compiled to probe
VERDICT_PROBE_FAILED = "probe_failed"  # the probe itself raised


class WireIntegrityError(FaultError):
    """A framed payload failed its content-digest check (or audit mode
    required an envelope and none was present). Kind ``integrity``, so
    every existing containment site classifies, counts, and
    budget-bounds it without new plumbing; ``hop`` names the decode hop
    that caught it — the attribution the acceptance test pins."""

    def __init__(self, hop: str, message: str):
        super().__init__(FaultKind.INTEGRITY, message)
        self.hop = hop


def frame_digest(data) -> bytes:
    """8-byte blake2b content digest of ``bytes`` or an ``ndarray``
    (C-order bytes; non-contiguous arrays are copied once)."""
    h = hashlib.blake2b(digest_size=DIGEST_BYTES)
    if isinstance(data, np.ndarray):
        h.update(np.ascontiguousarray(data))
    else:
        h.update(data)
    return h.digest()


def _digest_parts(*parts) -> bytes:
    """Piecewise digest (buffer-protocol parts, memoryviews welcome):
    the wire paths hash header+payload WITHOUT concatenating them —
    stamp/verify must not add payload-sized copies to a per-frame
    transport hot path."""
    h = hashlib.blake2b(digest_size=DIGEST_BYTES)
    for p in parts:
        h.update(p)
    return h.digest()


def stamp_wire(payload: bytes, chaos=None) -> bytes:
    """Wrap one wire payload in the audit envelope. The digest covers
    the version/flags header bytes AND the payload, so EVERY byte of
    the envelope is protected by something: magic flips fail the
    strict framing check, version flips the version check, and
    everything else the digest — the single-byte-corruption property
    the tier-1 test sweeps. ``chaos`` (a ``resilience.chaos.FaultPlan``)
    is the POST-ENCODE bit-flip site (``corrupt_wire``): the flip lands
    after the digest is computed — exactly the on-the-wire corruption
    the decode hop must catch."""
    head = bytes((AUDIT_WIRE_VERSION, 0))
    env = (AUDIT_WIRE_MAGIC + head
           + _digest_parts(head, payload) + payload)
    if chaos is not None:
        env = chaos.flip_bit("corrupt_wire", env)
    return env


def is_stamped(data: bytes) -> bool:
    return bytes(data[:2]) == AUDIT_WIRE_MAGIC


def verify_wire(data: bytes, hop: str = "wire",
                strict: bool = True) -> bytes:
    """Verify + strip one audit envelope; returns the inner payload.

    Raises :class:`WireIntegrityError` on a digest mismatch, a
    malformed envelope, or (``strict``) a missing envelope — in audit
    mode an unstamped payload is indistinguishable from one whose
    envelope header was corrupted, so tolerating it would be the hole
    a flipped magic byte escapes through. ``strict=False`` passes
    unstamped payloads through untouched (mixed-version peers)."""
    if not is_stamped(data):
        if strict:
            raise WireIntegrityError(
                hop, f"[{hop}] payload is not audit-stamped "
                     f"({len(data)} B, head {bytes(data[:2])!r}) — "
                     f"missing envelope or corrupted header")
        return data
    if len(data) < WIRE_HEADER_LEN:
        raise WireIntegrityError(
            hop, f"[{hop}] audit envelope truncated ({len(data)} B)")
    # Memoryview slices + a piecewise digest: ONE payload-sized copy
    # (the bytes() handed back — inner codecs need a real bytes) on the
    # decode hot path, not three.
    mv = memoryview(data)
    ver = mv[2]
    if ver != AUDIT_WIRE_VERSION:
        raise WireIntegrityError(
            hop, f"[{hop}] unknown audit envelope version {ver}")
    want = bytes(mv[4:WIRE_HEADER_LEN])
    payload_mv = mv[WIRE_HEADER_LEN:]
    got = _digest_parts(mv[2:4], payload_mv)
    if got != want:
        raise WireIntegrityError(
            hop, f"[{hop}] wire digest mismatch: payload hashes to "
                 f"{got.hex()}, envelope claims {want.hex()} "
                 f"({len(payload_mv)} B) — corruption on the wire")
    return bytes(payload_mv)


class WireAudit:
    """Per-hop stamp/verify pair with counters (thread-safe): one per
    transport endpoint (ring queue, worker ingress/egress, bridge).
    ``chaos`` arms the post-encode ``corrupt_wire`` flip on the stamp
    side only — corruption is injected after the digest, never into
    the verifier."""

    def __init__(self, hop: str, chaos=None, strict: bool = True):
        self.hop = hop
        self.chaos = chaos
        self.strict = strict
        self._lock = threading.Lock()
        self.stamped = 0
        self.verified = 0
        self.mismatches = 0
        self.last_error: Optional[str] = None

    def stamp(self, payload: bytes) -> bytes:
        with self._lock:
            self.stamped += 1
        return stamp_wire(payload, chaos=self.chaos)

    def verify(self, data: bytes) -> bytes:
        try:
            payload = verify_wire(data, hop=self.hop, strict=self.strict)
        except WireIntegrityError as e:
            with self._lock:
                self.mismatches += 1
                self.last_error = str(e)
            raise
        with self._lock:
            self.verified += 1
        return payload

    def stats(self) -> dict:
        with self._lock:
            return {
                "hop": self.hop,
                "stamped_total": self.stamped,
                "verified_total": self.verified,
                "mismatches_total": self.mismatches,
                "last_error": self.last_error,
            }


# ---------------------------------------------------------------------------
# Golden execution + probe frames
# ---------------------------------------------------------------------------


def golden_execute(filt, frame: np.ndarray, out_uint8: bool = True,
                   device=None, stream=None) -> np.ndarray:
    """Reference re-execution of one frame through ``filt``: the same
    cast discipline as ``Engine``'s step (uint8 → compute dtype in,
    → uint8 out), a batch of one, the chain run EAGERLY op by op on
    ``device`` (None: the CPU). The serving program, its staging and
    copy streams, its batch padding and the whole delivery pipeline are
    out of the loop; a primitive's own kernel is below the boundary this
    detector audits, so on a card the hand kernels launch here as they
    do in serving. ``stream`` (a CUDA stream on ``device``) is where the
    work is queued; the result is read after a synchronize on it. What
    shadow replay and the swap guard compare the serving path against."""
    from dvf_tpu_torch.runtime.engine import host_array, host_tensor
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    if filt.stateful:
        raise ValueError(
            f"golden replay of stateful filter {filt.name!r}: temporal "
            f"state is batch-threaded and cannot be replayed per frame")
    dev = torch.device("cpu") if device is None else torch.device(device)
    batch = host_tensor(np.asarray(frame)[None])
    ctx = (torch.cuda.stream(stream) if stream is not None
           else contextlib.nullcontext())
    with ctx, torch.no_grad():
        x = batch.to(dev)
        if x.dtype == torch.uint8 and not filt.uint8_ok:
            x = to_float(x, filt.compute_dtype)
        y, _ = filt.fn(x, None)
        if out_uint8 and y.dtype != torch.uint8:
            y = to_uint8(y)
        if stream is not None:
            stream.synchronize()
        return host_array(y[0].cpu())


def probe_frame(shape, dtype, tag: str = "") -> np.ndarray:
    """Deterministic probe content for one frame geometry: every caller
    (swap guard here, every replica in a divergence check) derives the
    SAME pixels from (shape, dtype, tag), so digests are comparable
    across processes and across time."""
    seed = zlib.crc32(f"{tag}|{tuple(shape)}|{np.dtype(dtype)}".encode())
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.integer):
        hi = min(int(np.iinfo(dt).max), 255) + 1
        return rng.integers(0, hi, size=tuple(shape), dtype=dt)
    return rng.random(tuple(shape)).astype(dt)


def frames_match(a: np.ndarray, b: np.ndarray, tolerance: float = 0):
    """(match, max_abs_diff) under a pinned tolerance. Shape/dtype
    mismatch never matches (diff reported as None)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False, None
    if tolerance <= 0 and np.array_equal(a, b):
        return True, 0.0
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    mx = float(diff.max()) if diff.size else 0.0
    return mx <= tolerance, mx


def engine_probe_row(engine, stream=None) -> np.ndarray:
    """Run the deterministic probe frame through ``engine``'s compiled
    program (row 0 of a zero-padded batch at its compiled signature)
    and return the output row — the digestable unit every detector
    compares. Raises when the engine is freed/uncompiled/stateful.
    ``stream`` (a CUDA stream on the engine's device) is where the
    probe's work is queued; ``run_probe`` reads its result back with a
    blocking copy on that stream."""
    sig = engine.signature
    if sig is None:
        raise RuntimeError("engine has no compiled signature to probe")
    (batch_shape, dtype) = sig
    tag = getattr(engine, "op_chain", "") or ""
    frame = probe_frame(tuple(batch_shape[1:]), dtype, tag=tag)
    batch = np.zeros(tuple(batch_shape), np.dtype(dtype))
    batch[0] = frame
    ctx = (torch.cuda.stream(stream) if stream is not None
           else contextlib.nullcontext())
    with ctx:
        return np.asarray(engine.run_probe(batch))[0]


def replay_tolerance(filt, in_dtype, default: float) -> float:
    """Bit-exact for chains whose compute stays in uint8 end to end
    (``uint8_ok``); the pinned ``default`` everywhere a float compute
    (and its jit-vs-unjit rounding freedom) sits between input and
    output."""
    try:
        if bool(filt.uint8_ok) and np.dtype(in_dtype) == np.uint8:
            return 0.0
    except Exception:  # noqa: BLE001 — duck-typed filt in tests
        pass
    return float(default)


def maybe_corrupt_device(chaos, out: np.ndarray) -> np.ndarray:
    """The ``corrupt_device`` chaos site: when a rule fires, return a
    copy of ``out`` with ONE element of row 0 perturbed — the silent
    device corruption the shadow replay must catch (the perturbed
    frame still has valid geometry, still encodes, still delivers).
    Row 0 deterministically, so a test pinning "non-faulted sessions
    stay bit-identical" can arrange its victim in slot 0."""
    if chaos is None or not chaos.perturb("corrupt_device"):
        return out
    out = np.array(out)  # the fetch slab/view may be read-only
    row = out[0]
    flat = row.reshape(-1)
    if np.issubdtype(out.dtype, np.integer):
        flat[0] = np.bitwise_xor(flat[0], np.array(0x40, out.dtype))
    else:
        flat[0] = flat[0] + 1.0
    return out


# ---------------------------------------------------------------------------
# The plane
# ---------------------------------------------------------------------------


class AuditPlane:
    """Shadow-replay sampler/worker + swap guard + the audit event ring.

    One per audited frontend (and a replay-less one per fleet front
    door for divergence accounting). Thread contract: every public
    method is safe from any thread; the golden re-executions and async
    swap guards run on ONE dedicated daemon worker so they never sit on
    the dispatch/collect hot path. Bounded everywhere: the replay queue
    drops oldest (counted) and the event ring is a deque.

    ``ledger`` (optional ``obs.ledger.ReconfigLedger``) receives one
    ``swap_guard`` event per guarded substitution and one
    ``audit_corruption`` event per confirmed corruption, so the ledger
    timeline and the audit timeline reconcile; ``flight_cb`` fires ONCE
    on the first confirmed corruption (the flight recorder's own rate
    limit bounds repeats); ``fault_cb`` folds confirmed corruptions
    into the owner's FaultStats under the ``integrity`` kind.

    Device work (replays, swap-guard probes) is queued on one CUDA
    stream per device that this plane creates for itself
    (:meth:`stream`); it waits on no serving stream, because what it
    reads is a retained host copy.
    """

    def __init__(
        self,
        sample_every: int = 64,
        seed: int = 0,
        tolerance: float = 2.0,
        capacity: int = 256,
        queue_depth: int = 64,
        tracer=None,
        track: int = TRACK_AUDIT,
        ledger=None,
        flight_cb: Optional[Callable[[str], None]] = None,
        fault_cb: Optional[Callable[[BaseException], None]] = None,
        label: str = "serve",
    ):
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self.sample_every = int(sample_every)
        self.seed = int(seed)
        self.tolerance = float(tolerance)
        self.tracer = tracer
        self.track = track
        self.ledger = ledger
        self.flight_cb = flight_cb
        self.fault_cb = fault_cb
        self.label = label
        self._lock = threading.Lock()
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        self._tick = 0                 # staged-frame counter (sampler)
        self.replays_sampled = 0
        self.replays_ok = 0
        self.replays_mismatched = 0
        self.replays_dropped = 0       # queue overflow (bounded plane)
        self.replay_errors = 0         # golden path itself raised
        self.swap_guards = 0
        self.swap_guard_mismatches = 0
        self.confirmed_corruptions = 0
        self._corruption_tripped = False
        self._wire: List[WireAudit] = []   # registered transport hops
        # Replay/guard work queue (drop-oldest, counted).
        self._q: "collections.deque" = collections.deque()
        self._q_depth = int(queue_depth)
        self._cv = threading.Condition()
        self._busy = False       # worker mid-judgment (drain() must not
        #   report empty while the last popped item is still being run)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._streams: Dict[torch.device, Any] = {}  # device → own stream

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "AuditPlane":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, name="dvf-audit-replay", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=timeout)

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until the replay queue is empty (tests / the CI smoke:
        'caught within K frames' needs the worker to have judged what
        was sampled). True when fully drained."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cv:
                if not self._q and not self._busy:
                    return True
            time.sleep(0.005)
        with self._cv:
            return not self._q and not self._busy

    def register_wire(self, wire: WireAudit) -> WireAudit:
        """Adopt one transport hop's stamp/verify counters into this
        plane's export (the bridge's envelope pair, a caller-built
        ring)."""
        with self._lock:
            self._wire.append(wire)
        return wire

    def stream(self, device) -> Optional["torch.cuda.Stream"]:
        """This plane's own non-default stream on ``device`` (created on
        first use); None for the CPU or no device."""
        if device is None:
            return None
        dev = torch.device(device)
        if dev.type != "cuda":
            return None
        with self._lock:
            s = self._streams.get(dev)
            if s is None:
                s = self._streams[dev] = torch.cuda.Stream(dev)
            return s

    # -- detector 2: sampled shadow replay -------------------------------

    def want_sample(self) -> bool:
        """Deterministic sampler: one decision per staged frame, True
        every ``sample_every``-th (phase set by ``seed``). Cheap enough
        for the dispatch loop: one lock + one modulo."""
        with self._lock:
            n = self._tick
            self._tick += 1
        return (n + self.seed) % self.sample_every == 0

    def submit_replay(self, filt, in_frame: np.ndarray,
                      out_frame: np.ndarray, *,
                      session: Optional[str] = None,
                      index: Optional[int] = None,
                      bucket: Optional[str] = None,
                      lineage=None,
                      out_uint8: bool = True,
                      tolerance: Optional[float] = None,
                      device=None) -> None:
        """Queue one (input, delivered output) pair for golden
        re-execution off the hot threads. The caller passes COPIES —
        the originals belong to pooled slabs that will be rewritten.
        ``device`` is where the golden runs (the serving engine's
        device; None: the CPU)."""
        tol = (replay_tolerance(filt, in_frame.dtype, self.tolerance)
               if tolerance is None else float(tolerance))
        item = ("replay", {
            "filt": filt, "in_frame": in_frame, "out_frame": out_frame,
            "session": session, "index": index, "bucket": bucket,
            "lineage": lineage, "out_uint8": out_uint8, "tolerance": tol,
            "device": device, "t": time.time(),
        })
        self._enqueue(item)
        with self._lock:
            self.replays_sampled += 1

    def _enqueue(self, item) -> None:
        kind = item[0]
        with self._cv:
            if len(self._q) >= self._q_depth:
                # Evict the oldest REPLAY to make room — never a guard:
                # replays are samples (losing one is a counted coverage
                # gap), guards are obligations (the "zero unaudited
                # substitutions" invariant would silently break if a
                # queued guard aged out behind a burst of samples).
                # Guards arrive at reconfiguration rate, so with no
                # replay to evict the queue only transiently exceeds
                # its bound.
                idx = next((i for i, it in enumerate(self._q)
                            if it[0] == "replay"), None)
                if idx is not None:
                    del self._q[idx]
                    with self._lock:
                        self.replays_dropped += 1
                elif kind == "replay":
                    with self._lock:
                        self.replays_dropped += 1
                    return
            self._q.append(item)
            self._cv.notify()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait(timeout=0.25)
                if self._stop and not self._q:
                    return
                kind, payload = self._q.popleft()
                self._busy = True
            try:
                if kind == "replay":
                    self._judge_replay(payload)
                elif kind == "guard":
                    self._run_swap_guard(**payload)
            except Exception as e:  # noqa: BLE001 — the auditor must
                # never take down what it audits; a broken golden path
                # is counted, not raised.
                with self._lock:
                    self.replay_errors += 1
                    self._push_event_locked({
                        "t": time.time(), "kind": "audit_error",
                        "error": repr(e)})
            finally:
                with self._cv:
                    self._busy = False

    def _judge_replay(self, p: dict) -> None:
        dev = p.get("device")
        golden = golden_execute(p["filt"], p["in_frame"],
                                out_uint8=p["out_uint8"], device=dev,
                                stream=self.stream(dev))
        ok, diff = frames_match(p["out_frame"], golden, p["tolerance"])
        if ok:
            with self._lock:
                self.replays_ok += 1
            return
        # CONFIRMED silent corruption: the delivered pixels differ from
        # the golden re-execution of the same input beyond tolerance.
        lineage_doc = None
        lin = p.get("lineage")
        if lin is not None:
            try:
                lineage_doc = lin.to_dict()
            except Exception:  # noqa: BLE001 — context is best-effort
                lineage_doc = None
        ledger_tail = None
        if self.ledger is not None:
            try:
                # The ledger events that PRECEDED the corruption: was a
                # resize/rebuild/rebind the thing that broke the pixels?
                ledger_tail = self.ledger.snapshot(last=8)
            except Exception:  # noqa: BLE001
                ledger_tail = None
        ev = {
            "t": time.time(), "kind": "shadow_replay",
            "verdict": VERDICT_MISMATCH,
            "session": p["session"], "index": p["index"],
            "bucket": p["bucket"],
            "max_abs_diff": diff,
            "tolerance": p["tolerance"],
            "digest_delivered": frame_digest(p["out_frame"]).hex(),
            "digest_golden": frame_digest(golden).hex(),
        }
        if lineage_doc is not None:
            ev["lineage"] = lineage_doc
        if ledger_tail is not None:
            ev["ledger_tail"] = ledger_tail
        first = False
        with self._lock:
            self.replays_mismatched += 1
            self.confirmed_corruptions += 1
            self._push_event_locked(ev)
            if not self._corruption_tripped:
                self._corruption_tripped = True
                first = True
        self._stamp_trace("audit_corruption", session=p["session"],
                          bucket=p["bucket"],
                          index=p["index"] if p["index"] is not None
                          else -1)
        if self.ledger is not None:
            try:
                self.ledger.record(
                    "audit_corruption", cause="audit",
                    bucket=p["bucket"], session=p["session"],
                    frame_index=p["index"],
                    max_abs_diff=diff, reason="shadow replay mismatch")
            except Exception:  # noqa: BLE001
                pass
        if self.fault_cb is not None:
            try:
                self.fault_cb(FaultError(
                    FaultKind.INTEGRITY,
                    f"shadow replay mismatch: session {p['session']} "
                    f"frame {p['index']} differs from golden by "
                    f"{diff} (tol {p['tolerance']:g})"))
            except Exception:  # noqa: BLE001
                pass
        if first and self.flight_cb is not None:
            try:
                self.flight_cb(
                    f"audit: first confirmed silent corruption "
                    f"(session {p['session']} frame {p['index']}, "
                    f"bucket {p['bucket']}, max_abs_diff {diff})")
            except Exception:  # noqa: BLE001
                pass

    # -- detector 4: program-swap equivalence guard ----------------------

    def probe_row(self, engine) -> Optional[np.ndarray]:
        """Best-effort OLD-program probe output, captured by the caller
        BEFORE a recompile replaces the program (a resize recompiles in
        place; a broken engine mid-recovery may refuse). None = not
        probeable."""
        try:
            return engine_probe_row(
                engine, stream=self.stream(getattr(engine, "device", None)))
        except Exception:  # noqa: BLE001 — old program unavailable
            return None

    def swap_guard(self, *, engine, filt, kind: str, cause: str,
                   signature: Optional[str] = None,
                   bucket: Optional[str] = None,
                   old_row: Optional[np.ndarray] = None,
                   reason: Optional[str] = None,
                   asynchronous: bool = False) -> Optional[dict]:
        """Judge one adopted program substitution: run the probe frame
        through the NEW program and compare against the golden
        eager path (and against ``old_row`` where the caller could
        capture the old program's output — bit-identity across a
        same-signature swap). Records the verdict in the audit ring
        AND as a ``swap_guard`` ledger event — the "zero unaudited
        substitutions" acceptance reads the ledger.

        ``asynchronous=True`` queues the probe on the plane worker
        (quality rebinds apply on the dispatch thread, which must not
        pay a probe forward-pass); resize/recovery callers are already
        off the serving path and run inline, returning the event."""
        payload = dict(engine=engine, filt=filt, kind=kind, cause=cause,
                       signature=signature, bucket=bucket,
                       old_row=old_row, reason=reason)
        if asynchronous:
            self._enqueue(("guard", payload))
            return None
        return self._run_swap_guard(**payload)

    def _run_swap_guard(self, engine, filt, kind, cause, signature,
                        bucket, old_row, reason) -> dict:
        verdict = VERDICT_MATCH
        diff = None
        old_match = None
        digest_new = digest_golden = None
        try:
            sig = engine.signature
            if sig is None:
                verdict = VERDICT_SKIPPED
                reason = (reason or "") + " (engine uncompiled — no " \
                                          "program substituted)"
            else:
                dev = getattr(engine, "device", None)
                stream = self.stream(dev)
                new_row = engine_probe_row(engine, stream=stream)
                frame = probe_frame(tuple(sig[0][1:]), sig[1],
                                    tag=getattr(engine, "op_chain", "")
                                    or "")
                golden = golden_execute(filt, frame,
                                        out_uint8=engine.out_uint8,
                                        device=dev, stream=stream)
                tol = replay_tolerance(filt, frame.dtype, self.tolerance)
                ok, diff = frames_match(new_row, golden, tol)
                digest_new = frame_digest(new_row).hex()
                digest_golden = frame_digest(golden).hex()
                if old_row is not None:
                    old_match = bool(np.array_equal(old_row, new_row))
                if not ok:
                    verdict = VERDICT_MISMATCH
        except Exception as e:  # noqa: BLE001 — the guard must never
            verdict = VERDICT_PROBE_FAILED     # break the swap it audits
            reason = f"{reason or ''} probe raised: {e!r}".strip()
        ev = {
            "t": time.time(), "kind": "swap_guard",
            "swap_kind": kind, "cause": cause,
            "signature": signature, "bucket": bucket,
            "verdict": verdict,
        }
        if diff is not None:
            ev["max_abs_diff"] = diff
        if old_match is not None:
            ev["old_program_match"] = old_match
        if digest_new is not None:
            ev["digest_new"] = digest_new
            ev["digest_golden"] = digest_golden
        if reason:
            ev["reason"] = reason
        mismatch = verdict == VERDICT_MISMATCH
        with self._lock:
            self.swap_guards += 1
            if mismatch:
                self.swap_guard_mismatches += 1
                self.confirmed_corruptions += 1
            self._push_event_locked(ev)
        self._stamp_trace(f"audit_swap_guard:{kind}", verdict=verdict,
                          bucket=bucket or "")
        if self.ledger is not None:
            try:
                self.ledger.record(
                    "swap_guard", cause=cause, signature=signature,
                    bucket=bucket, verdict=verdict,
                    swap_kind=kind, max_abs_diff=diff,
                    digest_new=digest_new, digest_golden=digest_golden,
                    old_program_match=old_match, reason=reason)
            except Exception:  # noqa: BLE001
                pass
        if mismatch and self.fault_cb is not None:
            try:
                self.fault_cb(FaultError(
                    FaultKind.INTEGRITY,
                    f"swap guard mismatch: {kind} adopted a program for "
                    f"{signature} whose probe output diverges from "
                    f"golden by {diff}"))
            except Exception:  # noqa: BLE001
                pass
        if mismatch and self.flight_cb is not None:
            first = False
            with self._lock:
                if not self._corruption_tripped:
                    self._corruption_tripped = True
                    first = True
            if first:
                try:
                    self.flight_cb(
                        f"audit: swap guard mismatch on {kind} "
                        f"({signature})")
                except Exception:  # noqa: BLE001
                    pass
        return ev

    # -- shared internals ------------------------------------------------

    def _push_event_locked(self, ev: dict) -> None:
        self._events.append(ev)

    def _stamp_trace(self, name: str, **args) -> None:
        tracer = self.tracer
        if tracer is not None and getattr(tracer, "enabled", False):
            clean = {k: v for k, v in args.items()
                     if isinstance(v, (str, int, float, bool))}
            tracer.instant(name, track=self.track, **clean)

    # -- export ----------------------------------------------------------

    def _wire_rows(self) -> List[dict]:
        with self._lock:
            wires = list(self._wire)
        return [w.stats() for w in wires]

    def stats(self) -> dict:
        """The ``stats()["audit"]`` document: counters + recent events
        (full events, lineage/ledger context included — this is the
        post-mortem surface)."""
        with self._lock:
            events = list(self._events)
            out = {
                "sample_every": self.sample_every,
                "tolerance": self.tolerance,
                "replays_sampled_total": self.replays_sampled,
                "replays_ok_total": self.replays_ok,
                "replay_mismatches_total": self.replays_mismatched,
                "replays_dropped_total": self.replays_dropped,
                "replay_errors_total": self.replay_errors,
                "swap_guards_total": self.swap_guards,
                "swap_guard_mismatches_total": self.swap_guard_mismatches,
                "confirmed_corruptions_total": self.confirmed_corruptions,
                "queue_depth": len(self._q),
            }
        wire = self._wire_rows()
        if wire:
            out["wire_hops"] = wire
            out["wire_mismatches_total"] = sum(
                w["mismatches_total"] for w in wire)
        out["events"] = events[-16:]
        return out

    def signals(self) -> Dict[str, float]:
        """Flat ``audit_*`` counters for an owner's ``signals()``
        export (→ the telemetry ring and the tier-prefixed scrape)."""
        with self._lock:
            out = {
                "audit_replays_total": float(self.replays_sampled),
                "audit_replay_mismatches_total": float(
                    self.replays_mismatched),
                "audit_replays_dropped_total": float(self.replays_dropped),
                "audit_swap_guards_total": float(self.swap_guards),
                "audit_swap_guard_mismatches_total": float(
                    self.swap_guard_mismatches),
                "audit_confirmed_corruptions_total": float(
                    self.confirmed_corruptions),
            }
        wire = self._wire_rows()
        if wire:
            out["audit_wire_mismatches_total"] = float(sum(
                w["mismatches_total"] for w in wire))
        return out

    def document(self) -> dict:
        """The ``/audit`` endpoint / flight-dump ``audit.json`` body:
        the whole retained event window plus the counters."""
        doc = self.stats()
        with self._lock:
            doc["events"] = list(self._events)
        doc["label"] = self.label
        return doc


# ---------------------------------------------------------------------------
# Detector 3: cross-replica divergence
# ---------------------------------------------------------------------------


class DivergenceDetector:
    """Fleet-tier digest comparison over per-replica probe results.

    ``check`` takes ``{replica_id: {"signature", "digest"} | None}``
    (None = probe unreachable/refused — counted, never judged) and
    flags every replica whose digest differs from the majority. Ties
    flag nothing (two replicas disagreeing is a divergence EVENT but
    neither side is provably the bad one without a third vote — the
    event record carries both digests for the operator). The optional
    ``quarantine_cb`` receives each flagged replica id — the fleet
    wires ``retire_replica`` here.
    """

    def __init__(self, capacity: int = 128, tracer=None,
                 track: int = TRACK_AUDIT, ledger=None,
                 flight_cb: Optional[Callable[[str], None]] = None,
                 quarantine_cb: Optional[Callable[[str], None]] = None):
        self._lock = threading.Lock()
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        self.tracer = tracer
        self.track = track
        self.ledger = ledger
        self.flight_cb = flight_cb
        self.quarantine_cb = quarantine_cb
        self.checks = 0
        self.skipped = 0           # < 2 comparable probes
        self.divergences = 0       # checks that flagged ≥ 1 replica
        self.quarantined = 0
        self._diverged_seen: set = set()  # flight once per replica

    def check(self, probes: Dict[str, Optional[dict]],
              signature: Optional[str] = None,
              quarantine: bool = False) -> dict:
        """Judge one probe fan-out; returns the event record."""
        by_digest: Dict[str, List[str]] = {}
        unreachable = []
        for rid, p in probes.items():
            if not p or not p.get("digest"):
                unreachable.append(rid)
                continue
            by_digest.setdefault(p["digest"], []).append(rid)
        n_probed = sum(len(v) for v in by_digest.values())
        ev: dict = {
            "t": time.time(), "kind": "divergence_check",
            "signature": signature,
            "replicas_probed": n_probed,
            "unreachable": sorted(unreachable),
            "digests": {d: sorted(rids) for d, rids in by_digest.items()},
        }
        divergent: List[str] = []
        if n_probed < 2:
            ev["verdict"] = VERDICT_SKIPPED
            with self._lock:
                self.checks += 1
                self.skipped += 1
                self._events.append(ev)
            return ev
        if len(by_digest) == 1:
            ev["verdict"] = VERDICT_MATCH
        else:
            majority = max(by_digest.values(), key=len)
            if len(majority) * 2 > n_probed:
                divergent = sorted(
                    rid for d, rids in by_digest.items()
                    if rids is not majority for rid in rids)
            ev["verdict"] = VERDICT_MISMATCH
            ev["divergent"] = divergent  # empty on a tie: event stands,
            #   no replica is provably the wrong one
        fresh_divergent = []
        with self._lock:
            self.checks += 1
            if ev["verdict"] == VERDICT_MISMATCH:
                self.divergences += 1
                fresh_divergent = [r for r in divergent
                                   if r not in self._diverged_seen]
                self._diverged_seen.update(divergent)
            self._events.append(ev)
        if ev["verdict"] == VERDICT_MISMATCH:
            tracer = self.tracer
            if tracer is not None and getattr(tracer, "enabled", False):
                tracer.instant("audit_divergence", track=self.track,
                               signature=signature or "",
                               divergent=",".join(divergent))
            if self.ledger is not None:
                try:
                    self.ledger.record(
                        "audit_divergence", cause="audit",
                        signature=signature,
                        divergent=divergent or None,
                        replicas_probed=n_probed,
                        reason="cross-replica probe digests differ")
                except Exception:  # noqa: BLE001
                    pass
            if fresh_divergent and self.flight_cb is not None:
                try:
                    self.flight_cb(
                        f"audit: cross-replica divergence on "
                        f"{signature} (divergent: {divergent})")
                except Exception:  # noqa: BLE001
                    pass
            if quarantine and self.quarantine_cb is not None:
                for rid in divergent:
                    try:
                        if self.quarantine_cb(rid):
                            with self._lock:
                                self.quarantined += 1
                    except Exception:  # noqa: BLE001 — quarantine is
                        pass           # best-effort; the flag stands
        return ev

    def stats(self) -> dict:
        with self._lock:
            return {
                "checks_total": self.checks,
                "skipped_total": self.skipped,
                "divergences_total": self.divergences,
                "quarantined_total": self.quarantined,
                "events": list(self._events)[-16:],
            }

    def signals(self) -> Dict[str, float]:
        with self._lock:
            return {
                "audit_divergence_checks_total": float(self.checks),
                "audit_divergences_total": float(self.divergences),
                "audit_quarantined_total": float(self.quarantined),
            }

    def document(self) -> dict:
        doc = self.stats()
        with self._lock:
            doc["events"] = list(self._events)
        return doc


# ---------------------------------------------------------------------------
# Registry provider
# ---------------------------------------------------------------------------


def attach_audit_provider(registry, plane: AuditPlane,
                          detector: Optional[DivergenceDetector] = None,
                          ) -> None:
    """Register the unprefixed ``audit_*`` sample family → the scrape
    exposes ``dvf_audit_*`` (fleet-wide series names, like the
    compile-cache counters)."""
    from dvf_tpu_torch.obs.registry import COUNTER, GAUGE, MetricSample

    def provider():
        out = []
        for key, v in plane.signals().items():
            if key == "audit_wire_mismatches_total":
                continue  # exported per-hop (labeled) below — one
                #   series name must not carry two label schemas
            out.append(MetricSample(
                key, v, (),
                COUNTER if key.endswith("_total") else GAUGE))
        for row in plane._wire_rows():
            labels = (("hop", row["hop"]),)
            out.append(MetricSample("audit_wire_verified_total",
                                    float(row["verified_total"]),
                                    labels, COUNTER))
            out.append(MetricSample("audit_wire_mismatches_total",
                                    float(row["mismatches_total"]),
                                    labels, COUNTER))
        if detector is not None:
            for key, v in detector.signals().items():
                out.append(MetricSample(key, v, (), COUNTER))
        return out

    registry.register_provider(provider)
