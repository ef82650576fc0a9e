"""The port's multi-signature serving (``dvf_tpu_torch``) on the CPU:
counterparts of ``tests/test_multitenant.py`` — bucketed batching, the
program pool, warm start — plus parity of the signature keys and
manifests with the JAX package.

A session mix with ≥3 distinct (op_chain, geometry, dtype) signatures
runs concurrently on ONE frontend with per-session outputs bit-identical
to dedicated single-signature runs (zero cross-bucket leakage), the
program pool LRU-evicts and re-admits correctly (recompile, outputs
unchanged), the EDF/cost bucket scheduler never starves a small
tight-SLO bucket behind a big busy one, a chaos ``compute`` fault in one
bucket leaves the other buckets' sessions untouched (budgets attribute
per bucket), signature keys canonicalize (``u8`` ≡ ``uint8``, list ≡
tuple, kwarg order irrelevant), precompile manifests warm the pool, and
every pool engine frees its device state at frontend close.
"""

import time

import numpy as np
import pytest

from dvf_tpu_torch.ops import get_filter
from dvf_tpu_torch.runtime.engine import ProgramPool, live_pool_engines
from dvf_tpu_torch.runtime.signature import (
    canonical_op_chain,
    make_key,
    parse_manifest,
)
from dvf_tpu_torch.serve import AdmissionError, ServeConfig
from torch_serve_util import Engine, ServeFrontend, port_leak_guard  # noqa: F401

H, W = 16, 24


def cfg(**kw) -> ServeConfig:
    base = dict(batch_size=4, queue_size=1000, out_queue_size=1000,
                slo_ms=60_000.0)
    base.update(kw)
    return ServeConfig(**base)


def frames_for(shape, dtype, n, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype) == np.uint8:
        return [rng.integers(0, 255, shape, dtype=np.uint8)
                for _ in range(n)]
    return [rng.random(shape, dtype=np.float32).astype(dtype)
            for _ in range(n)]


def drain_session(fe, sid, want, deadline_s=60.0):
    got = []
    deadline = time.time() + deadline_s
    while len(got) < want and time.time() < deadline:
        got.extend(fe.poll(sid))
        time.sleep(0.002)
    got.extend(fe.poll(sid))
    return got


# ------------------------------------------------- signature canonicalization


class TestSignatureKey:
    """Satellite: equal signatures can't miss the pool/cache by
    spelling — dtype aliases, geometry container type, kwarg order and
    whitespace all normalize to ONE key."""

    def test_dtype_spellings_equal(self):
        ref = make_key("invert", (4, 4, 3), "uint8")
        for spelling in ("u8", "uint8", "byte", np.uint8,
                         np.dtype("uint8")):
            assert make_key("invert", (4, 4, 3), spelling) == ref
        assert make_key("invert", (4, 4, 3), "f32") == \
            make_key("invert", (4, 4, 3), np.float32)
        # "u8" is the ML spelling (8 bits), NOT numpy's 8-byte code.
        assert make_key("invert", (4, 4, 3), "u8").dtype == "uint8"
        assert make_key("invert", (4, 4, 3), "u8") != \
            make_key("invert", (4, 4, 3), "uint16")

    def test_geometry_container_types_equal(self):
        a = make_key("invert", (4, 8, 3), "u8")
        assert make_key("invert", [4, 8, 3], "u8") == a
        assert make_key("invert", np.zeros((4, 8, 3)).shape, "u8") == a
        with pytest.raises(ValueError):
            make_key("invert", (0, 8, 3), "u8")

    def test_op_chain_kwarg_order_whitespace_and_numerics(self):
        a = canonical_op_chain("gaussian_blur(ksize=9, sigma=2.0)")
        b = canonical_op_chain("gaussian_blur( sigma=2,ksize=9 )")
        assert a == b == "gaussian_blur(ksize=9,sigma=2)"
        assert canonical_op_chain(" grayscale | invert ") == \
            canonical_op_chain("grayscale|invert")
        with pytest.raises(ValueError):
            canonical_op_chain("not a name!(")

    def test_engine_signature_key_is_canonical(self):
        e = Engine(get_filter("invert"))
        assert e.signature_key is None
        e.compile((2, H, W, 3), np.uint8)
        assert e.signature_key == make_key("invert", (H, W, 3), "u8")
        assert e.signature_key.render() == f"invert|{H}x{W}x3|uint8"
        e.free()

    def test_manifest_parses_and_canonicalizes(self):
        entries = parse_manifest({"signatures": [
            {"op_chain": "grayscale |invert", "frame_shape": [H, W, 3],
             "dtype": "u8"}]})
        assert entries[0]["key"] == make_key("grayscale|invert",
                                             (H, W, 3), "uint8")
        with pytest.raises(ValueError):
            parse_manifest([{"op_chain": "invert"}])


# ------------------------------------------------------- mixed-signature runs


class TestMixedSignatures:
    def test_three_signatures_concurrent_bit_identical(self):
        """Acceptance: ≥3 distinct (op_chain, geometry, dtype)
        signatures on ONE frontend, every session's output bit-identical
        to a dedicated single-signature frontend fed the same frames —
        bucket isolation with zero cross-bucket index or pixel leakage."""
        n = 12
        specs = [
            ("invert", (H, W, 3), np.uint8),          # default bucket
            ("grayscale|invert", (H + 8, W, 3), np.uint8),
            ("invert", (H, W + 8, 3), np.uint8),      # same op, new geometry
        ]
        frames = {i: frames_for(shape, dt, n, seed=10 + i)
                  for i, (_, shape, dt) in enumerate(specs)}

        # Dedicated single-signature runs first: the golden outputs.
        golden = {}
        for i, (chain, shape, dt) in enumerate(specs):
            from dvf_tpu_torch.runtime.signature import build_filter

            fe = ServeFrontend(build_filter(chain), cfg())
            with fe:
                sid = fe.open_stream()
                for f in frames[i]:
                    fe.submit(sid, f)
                golden[i] = [d.frame for d in drain_session(fe, sid, n)]
            assert len(golden[i]) == n

        # The mixed run: all three signatures interleaved on one
        # frontend, one device.
        fe = ServeFrontend(get_filter("invert"), cfg(max_buckets=4))
        with fe:
            # Declared → pins the default bucket (opened FIRST, so the
            # later invert-at-new-geometry declaration forks a bucket
            # instead of claiming the unpinned default).
            sids = [fe.open_stream(frame_shape=specs[0][1])]
            for chain, shape, dt in specs[1:]:
                sids.append(fe.open_stream(op_chain=chain,
                                           frame_shape=shape,
                                           frame_dtype=dt))
            for j in range(n):  # round-robin interleave across buckets
                for i, sid in enumerate(sids):
                    fe.submit(sid, frames[i][j])
            got = {i: drain_session(fe, sid, n)
                   for i, sid in enumerate(sids)}
            stats = fe.stats()

        assert stats["open_buckets"] == 3
        assert len(stats["buckets"]) == 3
        for i in range(len(specs)):
            assert [d.index for d in got[i]] == list(range(n)), (
                f"signature {i}: wrong indices")
            for j, d in enumerate(got[i]):
                np.testing.assert_array_equal(
                    d.frame, golden[i][j],
                    err_msg=f"signature {i} frame {j}: differs from the "
                            f"dedicated single-signature run "
                            f"(cross-bucket leakage?)")

    def test_configured_filter_routes_new_geometry(self):
        """Regression (review finding): a CONFIGURED filter's display
        name (e.g. the measured-default gaussian resolved to its impl,
        with renamed kwargs) is not a buildable registry spec — routing
        a second geometry of the default chain must reuse the live
        Filter object, not round-trip through build_filter."""
        n = 4
        fe = ServeFrontend(get_filter("gaussian_blur", ksize=5),
                           cfg(batch_size=2))
        with fe:
            a = fe.open_stream(frame_shape=(H, W, 3))
            b = fe.open_stream(frame_shape=(H + 8, W, 3))  # same chain,
            #   new geometry → new bucket, same Filter object
            for j in range(n):
                fe.submit(a, frames_for((H, W, 3), np.uint8, 1, j)[0])
                fe.submit(b, frames_for((H + 8, W, 3), np.uint8, 1, j)[0])
            got_a = drain_session(fe, a, n)
            got_b = drain_session(fe, b, n)
            st = fe.stats()
        assert len(got_a) == n and len(got_b) == n
        assert st["open_buckets"] == 2
        labels = sorted(st["buckets"])
        assert len(labels) == 2

    def test_pool_eviction_and_readmission_recompile(self):
        """LRU eviction frees the program's device buffers; re-admitting
        the signature recompiles (a fresh pool miss) and serves
        bit-identical output."""
        n = 4
        gray_frames = frames_for((H, W, 3), np.uint8, n, seed=3)
        fe = ServeFrontend(get_filter("invert"),
                           cfg(batch_size=2, max_buckets=2,
                               pool_capacity=1))
        with fe:
            a = fe.open_stream()
            fe.submit(a, gray_frames[0])
            drain_session(fe, a, 1)  # default bucket compiled + pooled

            b = fe.open_stream(op_chain="grayscale", frame_shape=(H, W, 3))
            assert fe.stats()["pool"]["misses"] == 1
            for f in gray_frames:
                fe.submit(b, f)
            first = [d.frame for d in drain_session(fe, b, n)]
            assert len(first) == n

            # Retire the grayscale bucket (close + a new signature at
            # the bucket cap evicts the idle one); pool_capacity=1 then
            # frees the un-leased grayscale program.
            fe.close(b, drain=True)
            deadline = time.time() + 20
            while fe.open_count() > 1 and time.time() < deadline:
                time.sleep(0.005)
            c = fe.open_stream(frame_shape=(H + 8, W, 3))  # third signature
            st = fe.stats()
            assert st["pool"]["misses"] == 2
            assert st["pool"]["evictions"] >= 1
            fe.close(c, drain=False)
            deadline = time.time() + 20
            while fe.open_count() > 1 and time.time() < deadline:
                time.sleep(0.005)

            # Re-admission: the evicted signature compiles AGAIN (pool
            # miss, not a stale hit) and its output is unchanged.
            b2 = fe.open_stream(op_chain="grayscale",
                                frame_shape=(H, W, 3))
            assert fe.stats()["pool"]["misses"] == 3
            for f in gray_frames:
                fe.submit(b2, f)
            second = [d.frame for d in drain_session(fe, b2, n)]
        assert len(second) == n
        for x, y in zip(first, second):
            np.testing.assert_array_equal(x, y)

    def test_edf_cost_scheduler_never_starves_small_bucket(self):
        """A big, continuously-loaded bucket on a slowed engine vs a
        small tight-SLO bucket: the EDF-headroom ÷ tick-cost score must
        keep serving the small bucket before its deadlines blow — zero
        shed, everything delivered."""
        fe = ServeFrontend(get_filter("invert"),
                           cfg(batch_size=4, max_inflight=1))
        small_n = 15
        with fe:
            big = [fe.open_stream(frame_shape=(H, W, 3))
                   for _ in range(2)]
            small = fe.open_stream(op_chain="grayscale",
                                   frame_shape=(H, W, 3), slo_ms=2000.0)
            # Prime both buckets (compile before the clock matters).
            for sid in (*big, small):
                fe.submit(sid, np.zeros((H, W, 3), np.uint8))
            deadline = time.time() + 30
            while time.time() < deadline:
                st = fe.stats()["sessions"]
                if all(st[s]["delivered"] == 1 for s in (*big, small)):
                    break
                time.sleep(0.005)
            # Slow the BIG bucket's engine only: each of its batches now
            # costs ~10 ms, so a naive biggest-queue scheduler would sit
            # on big batches while the small bucket's deadlines expire.
            big_engine = fe._session(big[0]).bucket.engine

            def slowed(orig):
                def slow_submit(batch, **kw):
                    time.sleep(0.01)
                    return orig(batch, **kw)
                return slow_submit

            big_engine.submit_resident = slowed(big_engine.submit_resident)
            big_engine.submit = slowed(big_engine.submit)
            stop = time.time() + 3.0
            rng = np.random.default_rng(0)
            sent_small = 0
            frame = rng.integers(0, 255, (H, W, 3), np.uint8)
            while time.time() < stop:
                for sid in big:  # saturate the big bucket
                    for _ in range(4):
                        fe.submit(sid, frame)
                if sent_small < small_n:
                    fe.submit(small, frame)
                    sent_small += 1
                time.sleep(0.01)
            got = drain_session(fe, small, sent_small + 1)
            st = fe.stats()
        s = st["sessions"][small]
        assert s["shed"] == 0, (
            f"small bucket shed {s['shed']} frames behind the big one")
        assert s["delivered"] == sent_small + 1
        assert len(got) == sent_small + 1

    def test_compute_chaos_in_one_bucket_leaves_others_unharmed(self):
        """Chaos ``compute`` faults armed on ONE bucket's engine: that
        bucket's sessions absorb the (attributed, budgeted) failures;
        the other bucket's stream is bit-identical to fault-free — and
        the faulted bucket's budget, not the frontend's, absorbed it."""
        from dvf_tpu_torch.resilience import FaultPlan

        n = 10
        inv_frames = frames_for((H, W, 3), np.uint8, n, seed=4)
        fe = ServeFrontend(get_filter("invert"),
                           cfg(batch_size=2, fault_budget=16,
                               stall_timeout_s=0.0))
        with fe:
            a = fe.open_stream()                       # default: invert
            b = fe.open_stream(op_chain="grayscale",
                               frame_shape=(H, W, 3))
            # One clean frame each (compile both programs) …
            fe.submit(a, inv_frames[0])
            fe.submit(b, inv_frames[0])
            deadline = time.time() + 30
            while time.time() < deadline:
                st = fe.stats()["sessions"]
                if st[a]["delivered"] == 1 and st[b]["delivered"] == 1:
                    break
                time.sleep(0.005)
            # … then arm chaos on the GRAYSCALE bucket's engine only.
            bucket_b = fe._session(b).bucket
            bucket_b.engine.chaos = FaultPlan(seed=7).add(
                "compute", every=1, count=3)
            got_a, got_b = [], []
            for j in range(1, n):
                fe.submit(a, inv_frames[j])
                fe.submit(b, inv_frames[j])
                time.sleep(0.01)
            got_a = drain_session(fe, a, n)
            deadline = time.time() + 30
            while time.time() < deadline:
                sb = fe.stats()["sessions"][b]
                if sb["delivered"] + sb["failed"] + sb["shed"] \
                        + sb["dropped_at_ingress"] >= n:
                    break
                time.sleep(0.005)
            got_b = drain_session(fe, b, 0, deadline_s=0.1)
            stats = fe.stats()

        # The healthy bucket: complete, ordered, bit-exact.
        assert [d.index for d in got_a] == list(range(n))
        for j, d in enumerate(got_a):
            np.testing.assert_array_equal(d.frame, 255 - inv_frames[j])
        # The chaos bucket: exactly 3 injected fault EVENTS (each may
        # fail 1-2 frames when a batch carried two of b's frames), all
        # attributed to ITS sessions/bucket — not the healthy one.
        sb = stats["sessions"][b]
        assert 3 <= sb["failed"] <= 6
        assert sb["faults"] == {"compute": sb["failed"]}
        sa = stats["sessions"][a]
        assert sa["failed"] == 0 and sa["faults"] == {}
        rows = stats["buckets"]
        b_row = rows[bucket_b.label()]
        assert b_row["faults"] == {"compute": 3}
        a_label = [k for k in rows if k != bucket_b.label()][0]
        assert rows[a_label]["faults"] == {}
        # Contained within the bucket's budget: no recovery, no error.
        assert stats["recoveries"] == 0
        del got_b  # b's exact delivery count is timing-dependent; the
        # session counters reconcile exactly instead:
        assert sb["submitted"] == sb["delivered"] + sb["shed"] \
            + sb["failed"] + sb["dropped_at_ingress"]


# --------------------------------------------------- warm-start + lifecycle


class TestWarmStart:
    def test_precompile_manifest_warms_pool(self):
        fe = ServeFrontend(get_filter("invert"), cfg(batch_size=2))
        manifest = [{"op_chain": "grayscale",
                     "frame_shape": [H, W, 3], "dtype": "u8"}]
        with fe:
            warmed = fe.precompile(manifest)
            assert warmed == [f"grayscale|{H}x{W}x3|uint8"]
            st = fe.stats()
            assert st["pool"]["misses"] == 1 and st["pool"]["size"] == 1
            # The real admission is now a pool hit — and it serves.
            sid = fe.open_stream(op_chain="grayscale",
                                 frame_shape=(H, W, 3))
            assert fe.stats()["pool"]["hits"] == 1
            f = np.full((H, W, 3), 9, np.uint8)
            fe.submit(sid, f)
            got = drain_session(fe, sid, 1)
            assert len(got) == 1
        assert fe.health()["warm_signatures"]  # still enumerable

    def test_open_stream_canonicalizes_dtype_spelling(self):
        """Regression (caught driving the live surface): "u8" declared
        at open_stream must mean uint8 (the ML spelling), not numpy's
        8-byte uint64 — pre-fix the first uint8 submit was refused
        against a bogus uint64 pin."""
        fe = ServeFrontend(get_filter("invert"), cfg(batch_size=2))
        with fe:
            sid = fe.open_stream(frame_shape=(H, W, 3), frame_dtype="u8")
            f = np.full((H, W, 3), 5, np.uint8)
            fe.submit(sid, f)
            got = drain_session(fe, sid, 1)
            assert len(got) == 1
            np.testing.assert_array_equal(got[0].frame, 255 - f)

    def test_warm_signatures_in_health_and_rejection(self):
        fe = ServeFrontend(get_filter("invert"),
                           cfg(batch_size=2, max_buckets=1))
        with fe:
            fe.open_stream(frame_shape=(H, W, 3))
            assert f"invert|{H}x{W}x3|uint8" in \
                fe.health()["warm_signatures"]
            with pytest.raises(AdmissionError, match="warm signatures"):
                fe.open_stream(op_chain="grayscale",
                               frame_shape=(H, W, 3))

    def test_stop_frees_every_pool_engine(self):
        """Satellite: no pool engine may keep device buffers past
        frontend close (the conftest session-end guard's per-test
        twin)."""
        fe = ServeFrontend(get_filter("invert"), cfg(batch_size=2))
        with fe:
            a = fe.open_stream(frame_shape=(H, W, 3))
            b = fe.open_stream(op_chain="grayscale",
                               frame_shape=(H + 8, W, 3))
            fe.submit(a, np.zeros((H, W, 3), np.uint8))
            fe.submit(b, np.zeros((H + 8, W, 3), np.uint8))
            drain_session(fe, a, 1)
            drain_session(fe, b, 1)
            assert len(live_pool_engines()) >= 2
        assert live_pool_engines() == []

    def test_freed_engine_refuses_submit(self):
        e = Engine(get_filter("invert"))
        e.compile((2, H, W, 3), np.uint8)
        e.free()
        with pytest.raises(RuntimeError, match="freed"):
            e.submit(np.zeros((2, H, W, 3), np.uint8))
        e.free()  # idempotent


class TestPoolAndRetireHardening:
    """Review-pass regressions: pool.replace racing close/retire, and
    retired buckets releasing their host staging slabs."""

    def test_pool_replace_on_closed_pool_frees_and_raises(self):
        """A supervised recovery whose rebuilt engine lands after the
        owner's stop() swept the pool must not insert a live program
        nothing will ever free — replace() frees it and raises, like
        acquire()/adopt()."""
        pool = ProgramPool(capacity=2)
        key = ("invert", (H, W, 3), "uint8")
        pool.acquire(key, lambda: _compiled_engine())
        pool.close()
        assert live_pool_engines() == []
        rebuilt = _compiled_engine()
        with pytest.raises(RuntimeError, match="closed"):
            pool.replace(key, rebuilt)
        assert live_pool_engines() == []
        with pytest.raises(RuntimeError, match="freed"):
            rebuilt.submit(np.zeros((2, H, W, 3), np.uint8))

    def test_pool_replace_absent_key_enters_warm_not_leased(self):
        """A key retired (lease dropped + evicted) while its bucket was
        mid-recovery re-enters WARM: lease count 0, so capacity
        pressure can still evict it — pre-fix it re-entered with a
        lease nobody would ever release, pinning the program forever."""
        pool = ProgramPool(capacity=1)
        key_a, key_b = ("a",), ("b",)
        pool.replace(key_a, _compiled_engine())  # absent key → warm
        assert pool.warm_keys() == [key_a]
        # A later acquire of another key must be able to evict it.
        pool.acquire(key_b, lambda: _compiled_engine())
        assert pool.evictions == 1
        assert key_a not in pool.warm_keys()
        pool.close()
        assert live_pool_engines() == []

    def test_retired_bucket_releases_staging_slabs(self):
        """Bucket churn through a small max_buckets cap must not pin
        the retired buckets' assembler/fetcher host slabs: retired
        sessions keep a .bucket reference for tail drains, so the slabs
        (unlike the pool-warm program) must be dropped at retire."""
        fe = ServeFrontend(get_filter("invert"),
                           cfg(batch_size=2, max_buckets=2))
        with fe:
            a = fe.open_stream(op_chain="grayscale",
                               frame_shape=(H, W, 3))
            fe.submit(a, np.zeros((H, W, 3), np.uint8))
            assert len(drain_session(fe, a, 1)) == 1
            bucket = fe._session(a).bucket
            assert bucket.assembler is not None
            fe.close(a, drain=True)
            deadline = time.time() + 20
            while fe.open_count() > 0 and time.time() < deadline:
                time.sleep(0.005)
            # A new signature at the cap retires the idle bucket.
            b = fe.open_stream(op_chain="grayscale",
                               frame_shape=(H + 8, W, 3))
            assert fe._session(b).bucket is not bucket
            assert bucket.assembler is None and bucket.fetcher is None
            # The retired session still drains through its reference.
            assert fe.poll(a) == []


def _compiled_engine():
    e = Engine(get_filter("invert"))
    e.compile((2, H, W, 3), np.uint8)
    return e


# ---------------------------------------------------------------------------
# Parity of the signature spellings with the JAX package
# ---------------------------------------------------------------------------

# Every spelling TestSignatureKey exercises: (op_chain, geometry, dtype).
SPELLINGS = [
    ("invert", (4, 4, 3), d) for d in
    ("u8", "uint8", "byte", np.uint8, np.dtype("uint8"), "f32", np.float32,
     "uint16")
] + [
    ("invert", g, "u8") for g in ((4, 8, 3), [4, 8, 3],
                                  np.zeros((4, 8, 3)).shape)
] + [
    (c, (H, W, 3), "uint8") for c in
    ("gaussian_blur(ksize=9, sigma=2.0)", "gaussian_blur( sigma=2,ksize=9 )",
     " grayscale | invert ", "grayscale|invert", "gaussian_blur(ksize=9)",
     "box_blur(ksize=3)|upscale(scale=2)")
]


@pytest.mark.parametrize("spec", SPELLINGS, ids=lambda s: repr(s)[:60])
def test_make_key_matches_reference(spec):
    """make_key and SignatureKey.render() are equal across packages for
    every spelling (exact: they are strings and ints)."""
    from dvf_tpu.runtime.signature import make_key as ref_make_key

    chain, geom, dtype = spec
    key, ref = make_key(chain, geom, dtype), ref_make_key(chain, geom, dtype)
    assert tuple(key) == tuple(ref)
    assert key.render() == ref.render()


# Registry names whose DISPLAY name differs across packages on the CPU:
# display names encode the resolved impl, and the port resolves these to
# its hand kernel where the reference's CPU default is the plain version
# (on its TPU the reference resolves bilateral and flow_warp as the port
# does, and gaussian_blur(ksize=9) differently). Neither side's display
# name is its registry spec, so neither side's default bucket is joined
# by a declared open of the spec: the pool misses alike.
IMPL_NAMED = {
    "bilateral": ("bilateral_pallas(d=5,sc=0.1,ss=2)",
                  "bilateral(d=5,sc=0.1,ss=2)"),
    "flow_warp": ("flow_warp(levels=3,warp='pallas',win=15)",
                  "flow_warp(levels=3,warp='gather',win=15)"),
}


class _Compiled:
    """The two fields engine_signature_key reads."""

    def __init__(self, op_chain):
        self.op_chain = op_chain
        self.signature = ((2, H, W, 3), np.dtype(np.uint8))


@pytest.mark.parametrize("how", ["spec", "display"])
def test_filter_names_key_alike_across_packages(how):
    """For every registry name: the key of an engine admitted for the
    spec (the frontend's declared path) is equal across packages, and so
    is the key of an engine built from the filter object (keyed by its
    display name) — but for the impl-named filters pinned above."""
    import dvf_tpu
    import dvf_tpu_torch
    from dvf_tpu.runtime.signature import engine_signature_key as ref_key
    from dvf_tpu_torch.runtime.signature import engine_signature_key

    names = dvf_tpu.list_filters()
    assert dvf_tpu_torch.list_filters() == names
    for name in names:
        if how == "spec":
            port_chain = ref_chain = name
        else:
            port_chain = get_filter(name).name
            ref_chain = dvf_tpu.get_filter(name).name
        got = engine_signature_key(_Compiled(port_chain))
        want = ref_key(_Compiled(ref_chain))
        if how == "display" and name in IMPL_NAMED:
            assert (got.op_chain, want.op_chain) == IMPL_NAMED[name]
            assert name not in (got.op_chain, want.op_chain)
            continue
        assert tuple(got) == tuple(want), name
        assert got.render() == want.render(), name


def test_parse_manifest_matches_reference():
    from dvf_tpu.runtime.signature import parse_manifest as ref_parse

    doc = {"signatures": [
        {"op_chain": "grayscale |invert", "frame_shape": [H, W, 3],
         "dtype": "u8"},
        {"op_chain": "gaussian_blur(sigma=2.0, ksize=9)",
         "frame_shape": (H, W, 3)},
        {"op_chain": "sobel_bilateral", "frame_shape": [H * 2, W, 3],
         "dtype": "f32"}]}
    got, ref = parse_manifest(doc), ref_parse(doc)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert {k: v for k, v in g.items() if k != "key"} == \
            {k: v for k, v in r.items() if k != "key"}
        assert tuple(g["key"]) == tuple(r["key"])


def test_tick_cost_skips_the_batch_that_builds_the_slab_pools():
    """The port keeps a bucket's first batch out of its tick-cost EWMA:
    that tick built the staging and delivery slab pools (pinned host
    memory on a card, ~0.1 s per GB), so the estimate would start two
    orders of magnitude above the program's cost. Later batches on an
    empty window are sampled as in the reference."""
    fe = ServeFrontend(get_filter("invert"), cfg(batch_size=2))
    with fe:
        sid = fe.open_stream(op_chain="grayscale", frame_shape=(H, W, 3))
        bucket = fe._session(sid).bucket
        f = np.zeros((H, W, 3), np.uint8)
        fe.submit(sid, f)
        assert len(drain_session(fe, sid, 1)) == 1
        assert bucket.batches == 1 and bucket._tick_cost_ms is None
        for k in range(2, 5):   # one frame at a time: an empty window
            fe.submit(sid, f)
            assert len(drain_session(fe, sid, 1)) == 1
            assert bucket.batches == k
        assert bucket._tick_cost_ms is not None

