"""Deterministic fault-injection plane (port of ``dvf_tpu.resilience.chaos``:
the same sites, spec grammar and seeded fire sequence).

The containment and supervision machinery is only trustworthy if it can
be *tested* deterministically — "unplug the card and see" is neither. A
:class:`FaultPlan` is a seedable list of rules, each bound to a named
injection **site** that the hot paths expose behind a nil check (zero
overhead unarmed — the sites do ``if chaos is not None``):

Sites wired in this package:

=============== ========================================= ==================
site            hook location                             default effect
=============== ========================================= ==================
``decode``      ``ZmqWorker.process_batch`` (per blob)    corrupt the bytes
``transport``   ``ZmqWorker._run_loop`` (per message)     truncate the
                                                          multipart
``h2d``         ``ingest.BatchBuilder._launch`` (per      raise ``h2d``, or
                chunk host→device copy)                   delay
``d2h``         ``egress.ShardedBatchFetcher.fetch``      raise ``d2h``, or
                (per batch host copy)                     delay
``compute``     ``Engine.submit``/``submit_resident``     raise ``compute``
``oom``         the same engine hook, its own site        raise ``oom``
``freeze``      the pipeline's collect loop (per          sleep ``delay`` s
                iteration)                                (wedges the
                                                          consumer for the
                                                          stall watchdog)
=============== ========================================= ==================

``SITE_KINDS`` also names the reference's serving, fleet, audit, swap and
continuity sites, so one ``--chaos`` spec parses alike in both packages;
those planes are not ported yet, so nothing fires them here.

Triggers are event-indexed (``at`` — explicit 0-based event numbers at
the site, or ``every`` — every Nth event), optionally bounded by
``count``; both are exactly reproducible across runs for the per-batch
sites (one event per blob/message/put/submit). Caveat: the ``freeze``
site counts collect-loop *iterations*, including empty queue polls, so
its event indices are machine-timing dependent — use small ``at``
indices (the loop starts polling immediately) or ``delay``-only rules
when reproducibility matters; the ``replica`` site counts health-poll
events the same way — one event per replica per monitor tick, replicas
checked in id order, so a small ``at`` index selects a victim replica
deterministically (``at=0`` = the first replica, first tick). A probabilistic
``p`` trigger exists for soak-style runs (seeded, but only deterministic
when a single thread drives the site). The reference's ``--chaos`` CLI
flag parses the same spec::

    serve --chaos "compute:at=3,h2d:every=5:count=2" --chaos-seed 7
    worker --chaos "decode:every=11,transport:p=0.01"
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from dvf_tpu_torch.resilience.faults import FaultError, FaultKind

# What kind a site's injected faults carry unless the rule says otherwise.
# The same map as the reference's, so a spec parses alike in both
# packages (FaultPlan.parse validates against it). (Geometry faults
# have no injection site: inject them for real by switching the JPEG
# stream's dimensions mid-run, as tests/test_resilience.py does.)
SITE_KINDS = {
    "decode": FaultKind.DECODE,
    "transport": FaultKind.TRANSPORT,
    "h2d": FaultKind.H2D,
    "d2h": FaultKind.D2H,
    "compute": FaultKind.COMPUTE,
    "oom": FaultKind.OOM,
    "freeze": FaultKind.STALL,
    "replica": FaultKind.REPLICA,
    # Audit-plane sites (obs.audit): corruption that PARSES — the wire
    # flip lands post-encode inside a digest-stamped envelope; the
    # device flip perturbs one element of an otherwise-valid output
    # batch. Neither raises at injection: detection (or the lack of it)
    # is exactly what the audit acceptance tests measure.
    "corrupt_wire": FaultKind.INTEGRITY,
    "corrupt_device": FaultKind.INTEGRITY,
    # Hot-swap sites (runtime.engine double-buffer): event 0 of a swap
    # is the aside-compile (prepare_swap), event 1 the mid-migrate
    # commit — a rule's ``at=`` indices pick which half fails. Either
    # failure must leave the OLD program serving untouched.
    "swap": FaultKind.COMPUTE,
    # Continuity-plane network sites (resilience.continuity): the delivery
    # path between a session's engine and its client. ``net_partition``
    # raises a ``partition`` ChaosFault at the poll/recv hop — the link
    # goes dark and the reconnect/replay machinery must recover without
    # losing or reordering a frame. The other three never raise: they
    # mutate the delivery stream itself (``dup`` repeats the head,
    # ``reorder`` rotates the window, ``delay`` sleeps), which is exactly
    # the at-least-once noise dedup-by-index must absorb.
    "net_partition": FaultKind.PARTITION,
    "net_dup": FaultKind.TRANSPORT,
    "net_reorder": FaultKind.TRANSPORT,
    "net_delay": FaultKind.TRANSPORT,
}


class ChaosFault(FaultError):
    """An injected fault (subclass so ``classify`` sees the kind)."""


@dataclasses.dataclass
class ChaosRule:
    site: str
    kind: str = ""            # defaults to SITE_KINDS[site]
    every: int = 0            # fire on every Nth event (1-based period)
    at: Tuple[int, ...] = ()  # fire on these 0-based event indices
    p: float = 0.0            # fire with this probability per event
    count: int = -1           # max fires (-1 = unlimited)
    delay_s: float = 0.0      # sleep instead of raising (h2d delay, freeze)
    fired: int = 0

    def __post_init__(self):
        if not self.kind:
            self.kind = SITE_KINDS.get(self.site, FaultKind.INTERNAL)
        if not (self.every or self.at or self.p):
            # A rule with no trigger means "every event" — explicit beats
            # silently-inert.
            self.every = 1

    def wants(self, index: int, rng: random.Random) -> bool:
        if self.count >= 0 and self.fired >= self.count:
            return False
        if self.at:
            return index in self.at
        if self.every:
            return (index + 1) % self.every == 0
        return rng.random() < self.p


class FaultPlan:
    """A seeded set of :class:`ChaosRule` s; one per run, shared by every
    armed component (engine, assembler, worker, pipeline, frontend)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rules: List[ChaosRule] = []
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}

    # -- construction ----------------------------------------------------

    def add(self, site: str, **kw) -> "FaultPlan":
        self.rules.append(ChaosRule(site=site, **kw))
        return self

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse the ``--chaos`` CLI grammar: comma-separated rules, each
        ``site[:key=value]*`` with keys ``every``, ``at`` (``/``-separated
        indices), ``p``, ``count``, ``delay``, ``kind``. Example:
        ``"compute:at=3,h2d:every=5:count=2:delay=0.01"``."""
        plan = cls(seed=seed)
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            site = fields[0].strip()
            if site not in SITE_KINDS:
                raise ValueError(
                    f"unknown chaos site {site!r} (valid: "
                    f"{', '.join(sorted(SITE_KINDS))})")
            kw: dict = {}
            for f in fields[1:]:
                k, _, v = f.partition("=")
                k = k.strip()
                if k == "every":
                    kw["every"] = int(v)
                elif k == "at":
                    kw["at"] = tuple(int(x) for x in v.split("/"))
                elif k == "p":
                    kw["p"] = float(v)
                elif k == "count":
                    kw["count"] = int(v)
                elif k == "delay":
                    kw["delay_s"] = float(v)
                elif k == "kind":
                    kw["kind"] = v.strip()
                else:
                    raise ValueError(f"unknown chaos rule key {k!r} in "
                                     f"{part!r}")
            plan.add(site, **kw)
        return plan

    # -- firing ----------------------------------------------------------

    def _match(self, site: str) -> Optional[ChaosRule]:
        """Advance the site's event counter; return the rule that fires
        for this event (first match wins), if any."""
        with self._lock:
            idx = self._counters.get(site, 0)
            self._counters[site] = idx + 1
            for rule in self.rules:
                if rule.site == site and rule.wants(idx, self._rng):
                    rule.fired += 1
                    return rule
        return None

    def fire(self, site: str) -> None:
        """Raise (or delay) if a rule triggers at this site's next event.
        No-op otherwise — hot paths guard with ``if chaos is not None``."""
        rule = self._match(site)
        if rule is None:
            return
        if rule.delay_s > 0:
            time.sleep(rule.delay_s)
            return
        raise ChaosFault(rule.kind,
                         f"chaos[{site}] injected {rule.kind} fault "
                         f"(fire #{rule.fired}, seed {self.seed})")

    def corrupt(self, site: str, blob: bytes) -> bytes:
        """Deterministically mangle a payload (JPEG bytes) when a rule
        triggers: the header survives (so probes still identify a JPEG)
        but the entropy-coded body is truncated and zero-stuffed, which
        every decoder rejects."""
        rule = self._match(site)
        if rule is None:
            return blob
        keep = max(4, len(blob) // 3)
        return blob[:keep] + b"\x00" * 16

    def flip_bit(self, site: str, blob: bytes,
                 protect: int = 12) -> bytes:
        """Flip ONE bit of ``blob`` when a rule triggers — the
        post-encode wire corruption the audit envelope must catch.
        The first ``protect`` bytes (the envelope header: magic,
        version, digest — obs.audit.WIRE_HEADER_LEN) are spared so the
        corrupted payload still PARSES as a stamped frame; flipping the
        magic instead would be caught by the cheaper strict-framing
        check, which is not the failure mode under test. Position is
        deterministic per fire (seeded arithmetic, no clock/rng)."""
        rule = self._match(site)
        if rule is None or len(blob) <= protect:
            return blob
        pos = protect + ((rule.fired * 7919) % (len(blob) - protect))
        out = bytearray(blob)
        out[pos] ^= 0x01
        return bytes(out)

    def perturb(self, site: str) -> bool:
        """Fire-and-report trigger for in-place array corruption sites
        (``corrupt_device``): True when a rule fires this event — the
        caller applies the perturbation (obs.audit.
        maybe_corrupt_device), because the payload is an ndarray the
        plan should not be reshaping itself."""
        return self._match(site) is not None

    def truncate(self, site: str, parts: list) -> list:
        """Drop all but the first frame of a multipart message when a rule
        triggers — the wire-level 'peer sent garbage' fault."""
        rule = self._match(site)
        if rule is None:
            return parts
        return parts[:1]

    def dup(self, site: str, items: list) -> list:
        """Duplicate the head of a delivery list when a rule triggers —
        at-least-once wire noise (``net_dup``). The duplicate is the
        same object; dedup-by-index downstream must drop it, so sharing
        the reference is safe and copy-free."""
        rule = self._match(site)
        if rule is None or not items:
            return items
        return [items[0]] + list(items)

    def reorder(self, site: str, items: list) -> list:
        """Rotate a delivery list one position when a rule triggers
        (head moves to the tail) — deterministic out-of-order arrival
        (``net_reorder``). A single rotation is enough to violate index
        monotonicity, which is what the resequencing path must absorb."""
        rule = self._match(site)
        if rule is None or len(items) < 2:
            return items
        return list(items[1:]) + [items[0]]

    # -- observability ---------------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "events": dict(self._counters),
                "fired": {
                    f"{r.site}:{r.kind}": r.fired
                    for r in self.rules if r.fired
                },
            }
