"""The port's fault planes (``dvf_tpu_torch/resilience/``) against the JAX
package's, and the pipeline's and the worker's containment, budget,
degrade ladders, chaos sites and stall watchdog on the CPU.

The classification, budget, escalation and chaos fire sequences must equal
the reference's on the same inputs (same spec, same seed); the pipeline
and worker counterparts follow the reference's own resilience tests
(tests/test_resilience.py, test_chaos.py, test_egress_stream.py).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

import dvf_tpu_torch
from dvf_tpu.resilience import budget as jax_budget
from dvf_tpu.resilience import chaos as jax_chaos
from dvf_tpu.resilience import faults as jax_faults
from dvf_tpu.transport.codec import JpegGeometryError as JaxGeometryError
from dvf_tpu_torch import NullSink, Pipeline, PipelineConfig, SyntheticSource
from dvf_tpu_torch.resilience import (
    ALL_KINDS,
    ChaosFault,
    ErrorBudget,
    FaultError,
    FaultKind,
    FaultPlan,
    FaultStats,
    InflightWindow,
    Supervisor,
    classify,
    escalate,
)
from dvf_tpu_torch.resilience.chaos import SITE_KINDS
from dvf_tpu_torch.runtime import egress as egress_mod
from dvf_tpu_torch.runtime import ingest as ingest_mod
from dvf_tpu_torch.transport.codec import JpegGeometryError


# ---------------------------------------------------------------------------
# Taxonomy, budget and chaos against the reference
# ---------------------------------------------------------------------------


def _exceptions(fault_cls, geometry_cls):
    return [
        fault_cls(FaultKind.H2D, "x"), fault_cls(FaultKind.D2H, "y"),
        RuntimeError("RESOURCE_EXHAUSTED: oom"), MemoryError("Out of memory"),
        torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
            "capacity of 79.11 GiB of which 1.02 GiB is free."),
        TimeoutError("late"), ValueError("bad"), OSError("camera"),
        KeyError("k"), geometry_cls("geometry changed"),
    ]


def test_classify_matches_the_reference():
    sites = [None, "ingest", "dispatch", "collect", "sink", "decode",
             "transport", "h2d", "d2h", "encode", "compute", "worker", "nowhere"]
    # Each package's own FaultError and geometry error, in it.
    for ours, theirs in zip(_exceptions(FaultError, JpegGeometryError),
                            _exceptions(jax_faults.FaultError, JaxGeometryError)):
        for site in sites:
            assert classify(ours, site) == jax_faults.classify(theirs, site), \
                (ours, site)
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 20.00 MiB")
    assert classify(oom, "dispatch") == classify(oom, "collect") == FaultKind.OOM
    assert classify(JpegGeometryError("x"), "worker") == FaultKind.GEOMETRY
    assert ALL_KINDS == jax_faults.ALL_KINDS
    assert SITE_KINDS == jax_chaos.SITE_KINDS


def test_fault_stats_match_the_reference():
    ours, ref = FaultStats(), jax_faults.FaultStats()
    for kind, exc in [(FaultKind.DECODE, ValueError("a")),
                      (FaultKind.DECODE, ValueError("b")),
                      (FaultKind.H2D, RuntimeError("c"))]:
        ours.record(kind, exc)
        ref.record(kind, exc)
    a, b = ours.summary(), ref.summary()
    assert a["by_kind"] == b["by_kind"] == {"decode": 2, "h2d": 1}
    assert a["total"] == b["total"] == 3
    assert {k: v["error"] for k, v in a["last"].items()} == \
        {k: v["error"] for k, v in b["last"].items()}
    merged = FaultStats()
    merged.absorb_summary(a, replica="r0")
    assert merged.summary()["by_replica"] == {"r0": {"decode": 2, "h2d": 1}}


def test_error_budget_and_escalate_follow_the_reference():
    rng = np.random.default_rng(5)
    ours = ErrorBudget(limit=3, window_s=1.0, limits={"stall": 1})
    ref = jax_budget.ErrorBudget(limit=3, window_s=1.0, limits={"stall": 1})
    now = 100.0
    for _ in range(200):
        kind = ["h2d", "d2h", "stall", "compute"][int(rng.integers(0, 4))]
        now += float(rng.exponential(0.2))
        assert ours.record(kind, now=now) == ref.record(kind, now=now)
        assert ours.level(kind) == ref.level(kind)
    assert ours.summary() == ref.summary()
    for degrade_ok in (True, False, None):
        a = ErrorBudget(limit=2, window_s=60.0)
        b = jax_budget.ErrorBudget(limit=2, window_s=60.0)
        cb = None if degrade_ok is None else (lambda _k, ok=degrade_ok: ok)
        seq_a = [escalate(a, "h2d", cb) for _ in range(7)]
        seq_b = [jax_budget.escalate(b, "h2d", cb) for _ in range(7)]
        assert seq_a == seq_b
        assert seq_a[:3] == ["contain", "contain",
                             "contain" if degrade_ok else "fail"]


@pytest.mark.parametrize("spec,seed", [
    ("compute:at=1/3,h2d:every=4:count=2", 9),
    ("d2h:p=0.3,oom:every=3,decode:p=0.5:count=4", 7),
    ("transport:at=0/2,freeze:every=2:delay=0", 1),
])
def test_fault_plan_fires_as_the_reference(spec, seed):
    ours, ref = FaultPlan.parse(spec, seed=seed), jax_chaos.FaultPlan.parse(spec, seed=seed)
    rng = np.random.default_rng(seed)
    sites = sorted({p.split(":")[0] for p in spec.split(",")})
    blob = bytes(range(200))
    for _ in range(120):
        site = sites[int(rng.integers(0, len(sites)))]
        got = []
        for plan, err in ((ours, ChaosFault), (ref, jax_chaos.ChaosFault)):
            try:
                plan.fire(site)
                got.append(None)
            except err as e:
                got.append((e.kind, str(e)))
        assert got[0] == got[1], site
        assert ours.corrupt(site, blob) == ref.corrupt(site, blob)
        assert ours.truncate(site, [b"0", b"1"]) == ref.truncate(site, [b"0", b"1"])
        assert ours.flip_bit(site, blob) == ref.flip_bit(site, blob)
        assert ours.dup(site, [1, 2]) == ref.dup(site, [1, 2])
        assert ours.reorder(site, [1, 2, 3]) == ref.reorder(site, [1, 2, 3])
        assert ours.perturb(site) == ref.perturb(site)
    assert ours.summary() == ref.summary()


def test_fault_plan_rejects_what_the_reference_rejects():
    for bad, match in [("warp:every=1", "unknown chaos site"),
                       ("compute:when=now", "unknown chaos rule key")]:
        with pytest.raises(ValueError, match=match):
            FaultPlan.parse(bad)
        with pytest.raises(ValueError, match=match):
            jax_chaos.FaultPlan.parse(bad)
    t0 = time.perf_counter()
    FaultPlan().add("freeze", at=(0,), delay_s=0.05).fire("freeze")  # no raise
    assert time.perf_counter() - t0 >= 0.05


def test_watchdog_trips_once_per_stall():
    window = InflightWindow()
    trips = []
    sup = Supervisor(0.1, on_stall=lambda r: (trips.append(r), window.drain()),
                     window=window, poll_s=0.02).start()
    try:
        window.add(0)
        window.add(1)
        assert len(window) == 2
        deadline = time.time() + 5.0
        while not trips and time.time() < deadline:
            time.sleep(0.01)
        assert len(trips) == 1 and "stalled" in trips[0] and len(window) == 0
        sup.beat("collect")
        assert set(sup.heartbeat_ages()) == {"collect"}
    finally:
        sup.stop()
    with pytest.raises(ValueError):
        Supervisor(0.0, on_stall=lambda r: None)


# ---------------------------------------------------------------------------
# Pipeline containment, budget, chaos and the watchdog
# ---------------------------------------------------------------------------


def _pipe(n=32, resilient=True, **cfg):
    cfg.setdefault("batch_size", 4)
    return Pipeline(SyntheticSource(16, 16, n_frames=n, **cfg.pop("src", {})),
                    dvf_tpu_torch.get_filter("invert"), NullSink(),
                    PipelineConfig(frame_delay=0, queue_size=1000,
                                   resilient=resilient, **cfg), device="cpu")


def test_resilient_pipeline_survives_engine_errors():
    """resilient=True: a failing submission drops that batch and the
    stream continues; fail-fast (the default) re-raises."""
    def build(resilient):
        pipe = _pipe(resilient=resilient)
        real = pipe.engine.submit   # CPU default: monolithic ingest
        calls = {"n": 0}

        def flaky(batch, out=None, fetch=True):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected device error")
            return real(batch, out=out, fetch=fetch)

        pipe.engine.submit = flaky
        return pipe

    stats = build(True).run()
    assert stats["errors"] == 1 and stats["delivered"] == 32 - 4
    assert stats["faults"]["by_kind"] == {"compute": 1}
    with pytest.raises(RuntimeError, match="injected"):
        build(False).run()


def test_resilient_pipeline_survives_bad_source_frames():
    class FlakySource:
        def __init__(self):
            self.i = 0

        def __iter__(self):
            return self

        def __next__(self):
            i = self.i
            if i >= 20:
                raise StopIteration
            self.i += 1
            if i % 5 == 3:
                raise OSError(f"camera glitch at {i}")
            return np.full((16, 16, 3), i, np.uint8), time.time()

    pipe = Pipeline(FlakySource(), dvf_tpu_torch.get_filter("invert"), NullSink(),
                    PipelineConfig(batch_size=4, frame_delay=0, queue_size=64,
                                   resilient=True), device="cpu")
    stats = pipe.run()
    assert stats["errors"] == 4 and stats["delivered"] == 16
    assert stats["faults"]["by_kind"] == {"decode": 4}
    assert pipe.health()["ok"] and pipe.signals()["fault_decode_total"] == 4.0


def test_chaos_compute_fault_exact_counts_and_fail_fast_abort():
    chaos = FaultPlan().add("compute", at=(1,))
    stats = _pipe(chaos=chaos).run()
    assert stats["faults"]["by_kind"] == {"compute": 1}
    assert stats["errors"] == 1 and 32 - 4 <= stats["delivered"] < 32
    assert stats["chaos"]["fired"] == {"compute:compute": 1}
    pipe = _pipe(n=8, resilient=False, chaos=FaultPlan().add("oom", at=(0,)))
    with pytest.raises(ChaosFault):
        pipe.run()
    assert pipe.faults.summary()["by_kind"] == {"oom": 1}
    assert not pipe.health()["ok"]


@pytest.mark.parametrize("site", ["h2d", "d2h"])
def test_transfer_budget_degrades_streamed_to_monolithic(site, monkeypatch):
    """Chaos raises at every host→device chunk copy (or device→host fetch);
    the budget (2) overflows at the third fault and degrades that side to
    monolithic, reason recorded; the stream then finishes healthy."""
    monkeypatch.setattr(ingest_mod, "MIN_STREAM_H2D_MS", 0.0)
    monkeypatch.setattr(egress_mod, "MIN_STREAM_D2H_MS", 0.0)
    monkeypatch.setattr(egress_mod, "STREAM_ON_CPU", True)
    chaos = FaultPlan().add(site, every=1, count=64)
    # 12 batches: a d2h fault is met on the collect thread, and with at
    # most 4 batches in flight when the third one trips the budget, at
    # least 5 batches are submitted after it, through the degraded path.
    stats = _pipe(n=96, batch_size=8, chaos=chaos, fault_budget=2).run()
    side = "ingest" if site == "h2d" else "egress"
    other = "egress" if site == "h2d" else "ingest"
    assert stats["faults"]["by_kind"] == {site: 3}
    assert stats[side]["mode"] == "monolithic"
    assert stats[side]["fallback_reason"] == f"{site}_fault_budget"
    assert stats[other]["mode"] == "streamed"
    assert stats["delivered"] == 96 - 3 * 8


def test_d2h_fault_classified_and_contained(monkeypatch):
    monkeypatch.setattr(egress_mod, "MIN_STREAM_D2H_MS", 0.0)
    monkeypatch.setattr(egress_mod, "STREAM_ON_CPU", True)
    stats = _pipe(chaos=FaultPlan().add("d2h", at=(1,))).run()
    assert stats["faults"]["by_kind"] == {"d2h": 1}
    assert stats["errors"] == 1 and 32 - 4 <= stats["delivered"] < 32
    assert stats["chaos"]["fired"] == {"d2h:d2h": 1}
    assert stats["egress"]["mode"] == "streamed"


def test_watchdog_recovers_with_streamed_egress(monkeypatch):
    """A frozen collect thread trips the watchdog; the engine (and the
    fetcher, against the fresh engine) are rebuilt and the stream keeps
    delivering through streamed egress."""
    monkeypatch.setattr(egress_mod, "MIN_STREAM_D2H_MS", 0.0)
    monkeypatch.setattr(egress_mod, "STREAM_ON_CPU", True)
    pipe = _pipe(n=200, src={"rate": 100.0},
                 chaos=FaultPlan().add("freeze", at=(2,), delay_s=1.2),
                 stall_timeout_s=0.3, collect_mode="thread")
    first = pipe.engine
    stats = pipe.run()
    assert stats["recoveries"] >= 1 and pipe.engine is not first
    assert stats["faults"]["by_kind"].get("stall", 0) >= 1
    assert stats["delivered"] > 0
    assert stats["egress"]["mode"] == "streamed"


def test_unrecoverable_stall_fails_fast():
    """Fail-fast mode: a stall aborts the run with a stall FaultError."""
    pipe = _pipe(n=200, resilient=False, src={"rate": 100.0},
                 chaos=FaultPlan().add("freeze", at=(2,), delay_s=1.0),
                 stall_timeout_s=0.2)
    with pytest.raises(FaultError, match="stalled"):
        pipe.run()


# ---------------------------------------------------------------------------
# The worker's budget, degrade ladders and chaos sites (socket loop)
# ---------------------------------------------------------------------------


def _serve_worker(n, size, quiet_s=1.5, **kw):
    """Serve n raw frames through the port's socket worker on localhost;
    returns (results by index, frames, stats)."""
    zmq = pytest.importorskip("zmq")
    ctx = zmq.Context()
    router = ctx.socket(zmq.ROUTER)
    dist = router.bind_to_random_port("tcp://127.0.0.1")
    pull = ctx.socket(zmq.PULL)
    coll = pull.bind_to_random_port("tcp://127.0.0.1")
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 255, (size, size, 3), np.uint8) for _ in range(n)]
    todo = list(enumerate(frames))
    results = {}
    worker = dvf_tpu_torch.ZmqWorker(
        dvf_tpu_torch.get_filter("invert"), host="127.0.0.1", distribute_port=dist,
        collect_port=coll, batch_size=4, wire="raw", raw_size=size, device="cpu",
        **kw)
    t = threading.Thread(target=worker.run, daemon=True)
    try:
        t.start()
        deadline, last = time.time() + 30.0, time.time()
        while time.time() < deadline:
            if router.poll(5):
                client, _ = router.recv_multipart()[:2]
                if todo:
                    i, f = todo.pop(0)
                    router.send_multipart([client, str(i).encode(), f.tobytes()])
            if pull.poll(5):
                idx_b, *_mid, payload = pull.recv_multipart()
                results[int(idx_b.decode())] = np.frombuffer(
                    payload, np.uint8).reshape(size, size, 3)
                last = time.time()
            if not todo and time.time() - last > quiet_s:
                break
        worker.stop()
        t.join(timeout=20)
        assert not t.is_alive()
        stats = worker.stats()
    finally:
        worker.close()
        router.close(0)
        pull.close(0)
        ctx.term()
    return results, frames, stats


@pytest.mark.parametrize("site", ["h2d", "d2h"])
def test_worker_transfer_budget_degrades(site, monkeypatch):
    monkeypatch.setattr(ingest_mod, "MIN_STREAM_H2D_MS", 0.0)
    monkeypatch.setattr(egress_mod, "MIN_STREAM_D2H_MS", 0.0)
    monkeypatch.setattr(egress_mod, "STREAM_ON_CPU", True)
    results, frames, stats = _serve_worker(
        40, 16, chaos=FaultPlan().add(site, every=1, count=64), fault_budget=2)
    side = "ingest" if site == "h2d" else "egress"
    assert stats["faults"]["by_kind"] == {site: 3}
    assert stats[side]["mode"] == "monolithic"
    assert stats[side]["fallback_reason"] == f"{site}_fault_budget"
    assert stats["chaos"]["fired"] == {f"{site}:{site}": 3}
    # Three batches of at most 4 frames dropped (the worker may close a
    # batch early on its 10 ms assembly timeout).
    assert 40 - 3 * 4 <= len(results) <= 40 - 3
    for i, got in results.items():
        np.testing.assert_array_equal(got, 255 - frames[i])


def test_worker_transport_chaos_counted_and_contained():
    results, frames, stats = _serve_worker(
        12, 16, chaos=FaultPlan().add("transport", at=(1, 5)))
    assert stats["faults"]["by_kind"] == {"transport": 2}
    assert stats["errors"] == 2 and len(results) == 10
    for i, got in results.items():
        np.testing.assert_array_equal(got, 255 - frames[i])
