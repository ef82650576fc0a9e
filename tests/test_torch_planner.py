"""Auto-plan plane on the port (counterpart of ``tests/test_planner.py``
without its two PLAN_BENCH.json tests, whose bench writer belongs to the
JAX package's harness), plus the port's side of
``tests/test_elastic.py::TestFleetElasticityController``.

The reference's tests run against ``dvf_tpu_torch.control``. Where the
reference computes values the port is held to it exactly:
``candidate_grid``, ``analytic_frame_ms``, ``shortlist`` and
``plan_search`` with a scripted measurer, the plan and calibration cache
documents (but for the topology fingerprint, which names the port's
backend), and the elasticity controllers' actions over the same windows.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from dvf_tpu.control import fleet_elastic as jax_fe
from dvf_tpu.control import plan_cache as jax_pc
from dvf_tpu.control import planner as jax_pl
from dvf_tpu_torch.control import plan_cache as pc
from dvf_tpu_torch.control import planner as pl
from torch_serve_util import port_leak_guard  # noqa: F401

TOPO = "torch-cpu/cpu/n1/devices=1"
GEO = (32, 32, 3)
SIG = "invert|32x32x3|uint8"


def _measured(**kw):
    return dataclasses.replace(
        pl.Plan(**kw), source=pl.PLAN_SOURCE_MEASURED, measured_fps=100.0)


# ---------------------------------------------------------------------------
# Plan cache: keying and invalidation
# ---------------------------------------------------------------------------


def test_plan_cache_round_trip(tmp_path):
    d = str(tmp_path)
    plan = _measured(batch_size=16, tick_s=0.001, ingest_depth=2)
    assert pc.save_plan(d, SIG, GEO, TOPO, plan.to_doc()) is not None
    got = pc.load_plan(d, SIG, GEO, TOPO)
    assert got is not None and got["batch_size"] == 16
    # The typed wrapper re-stamps provenance: a hit must SAY it's a hit.
    cached = pl.plan_from_cache(d, SIG, GEO, TOPO)
    assert cached is not None
    assert cached.source == pl.PLAN_SOURCE_CACHE
    assert cached.batch_size == 16 and cached.tick_s == 0.001


def test_plan_cache_every_key_axis_misses(tmp_path):
    d = str(tmp_path)
    pc.save_plan(d, SIG, GEO, TOPO, _measured().to_doc())
    assert pc.load_plan(d, SIG, GEO, TOPO) is not None
    # Op chain / signature changed.
    assert pc.load_plan(d, "blur|32x32x3|uint8", GEO, TOPO) is None
    # Geometry changed.
    assert pc.load_plan(d, SIG, (64, 64, 3), TOPO) is None
    # Topology changed (plan searched on 1 core must not drive 8).
    assert pc.load_plan(d, SIG, GEO, "tpu/v5e/n8/data=8") is None
    # Planner version bumped: grid/scoring changed shape, re-search.
    assert pc.load_plan(d, SIG, GEO, TOPO,
                        planner_version=pc.PLANNER_VERSION + 1) is None


def test_plan_cache_corrupt_and_foreign_entries_are_misses(tmp_path):
    d = str(tmp_path)
    path = pc.save_plan(d, SIG, GEO, TOPO, _measured().to_doc())
    # Corrupt JSON: a miss, never a raise.
    with open(path, "w") as f:
        f.write("{not json")
    assert pc.load_plan(d, SIG, GEO, TOPO) is None
    # An entry whose EMBEDDED key fields disagree with the request (a
    # hash collision or a hand-copied file) degrades to a miss too.
    doc = {"schema": pc.PLAN_SCHEMA, "planner_version": pc.PLANNER_VERSION,
           "signature": "other|sig", "geometry": list(GEO),
           "topology": TOPO, "plan": _measured().to_doc()}
    with open(path, "w") as f:
        json.dump(doc, f)
    assert pc.load_plan(d, SIG, GEO, TOPO) is None
    # Foreign schema.
    with open(path, "w") as f:
        json.dump({"schema": "somebody.elses.v9"}, f)
    assert pc.load_plan(d, SIG, GEO, TOPO) is None
    # Missing cache dir / None dir: a miss, not an error.
    assert pc.load_plan(os.path.join(d, "nope"), SIG, GEO, TOPO) is None
    assert pc.load_plan(None, SIG, GEO, TOPO) is None


def test_plan_to_cache_refuses_unmeasured(tmp_path):
    d = str(tmp_path)
    analytic = dataclasses.replace(pl.Plan(), source=pl.PLAN_SOURCE_ANALYTIC)
    assert pl.plan_to_cache(d, SIG, GEO, TOPO, analytic) is None
    assert pl.plan_from_cache(d, SIG, GEO, TOPO) is None
    assert pl.plan_to_cache(d, SIG, GEO, TOPO, _measured()) is not None
    assert pl.plan_from_cache(d, SIG, GEO, TOPO) is not None


# ---------------------------------------------------------------------------
# Plan validation / envelope
# ---------------------------------------------------------------------------


def test_plan_from_doc_rejects_garbage():
    assert pl.Plan.from_doc(None) is None
    assert pl.Plan.from_doc("not a dict") is None
    assert pl.Plan.from_doc({"batch_size": 0}) is None
    assert pl.Plan.from_doc({"batch_size": "eight"}) is None
    assert pl.Plan.from_doc({"tick_s": -1.0}) is None
    assert pl.Plan.from_doc({"ingest": "psychic"}) is None
    assert pl.Plan.from_doc({"wire": "carrier-pigeon"}) is None
    good = pl.Plan.from_doc(_measured(batch_size=4).to_doc())
    assert good is not None and good.batch_size == 4
    # Unknown keys are ignored (forward compatibility), not fatal.
    assert pl.Plan.from_doc({**_measured().to_doc(),
                             "new_field": 1}) is not None


def test_envelope_caps_ladder_at_planned_batch():
    env = pl.Plan(batch_size=8, tick_s=0.001).envelope()
    assert env["batch_ladder"] == (1, 2, 4, 8)
    assert env["batch_max"] == 8
    assert env["tick_busy_s"] == 0.001
    # Non-power-of-two planned batch still tops its own ladder.
    env = pl.Plan(batch_size=6).envelope()
    assert env["batch_ladder"][-1] == 6 and env["batch_max"] == 6


# ---------------------------------------------------------------------------
# Search: grid, analytic prune, measured ranking
# ---------------------------------------------------------------------------


def test_candidate_grid_shape():
    grid = pl.candidate_grid(batch_cap=8)
    # Ladder 1,2,4,8 x 3 ticks x 3 depths, wire/codec axes collapsed.
    assert len(grid) == 36
    assert {p.batch_size for p in grid} == {1, 2, 4, 8}
    assert len({p.label() for p in grid}) == len(grid)


def test_shortlist_keeps_at_most_a_third():
    grid = pl.candidate_grid(batch_cap=8)
    cal = {"h2d_block_ms": 0.5, "d2h_block_ms": 0.2, "step_block_ms": 2.0}
    short = pl.shortlist(grid, cal, cal_batch=8)
    assert len(short) <= len(grid) // 3
    assert all(p.predicted_frame_ms is not None for p in short)
    # Deterministic: same inputs, same order.
    again = pl.shortlist(grid, cal, cal_batch=8)
    assert [p.label() for p in short] == [p.label() for p in again]
    # live_budget narrows further but never widens past the third.
    assert len(pl.shortlist(grid, cal, 8, None, live_budget=2)) == 2
    assert len(pl.shortlist(grid, cal, 8, None,
                            live_budget=999)) <= len(grid) // 3


def test_plan_search_measured_winner():
    grid = pl.candidate_grid(batch_cap=8)
    cal = {"h2d_block_ms": 0.5, "d2h_block_ms": 0.2, "step_block_ms": 2.0}

    def measure(p):
        # Scripted: throughput rewards batch, penalizes slow ticks —
        # the search must surface the scripted optimum, not the
        # analytic front-runner.
        return {"fps": p.batch_size * 100.0 - p.tick_s * 1e4}

    plan, comp = pl.plan_search(grid, measure, cal=cal, cal_batch=8)
    assert plan.source == pl.PLAN_SOURCE_MEASURED
    assert plan.batch_size == 8
    assert plan.searched <= len(grid) // 3
    assert plan.grid == len(grid)
    assert comp["winner"] == plan.label()
    assert plan.measured_fps == pytest.approx(
        8 * 100.0 - plan.tick_s * 1e4)


def test_plan_search_all_legs_error_degrades_to_analytic():
    grid = pl.candidate_grid(batch_cap=4)
    plan, comp = pl.plan_search(
        grid, lambda p: {"error": "burst stalled"},
        cal={"h2d_block_ms": 0.5, "step_block_ms": 2.0}, cal_batch=4)
    assert plan.source == pl.PLAN_SOURCE_ANALYTIC
    # And an analytic plan never persists as if measured.
    assert pl.plan_to_cache("/tmp/x", SIG, GEO, TOPO, plan) is None


def test_predicted_tick_cost_ms_feeds_forward():
    assert pl.predicted_tick_cost_ms(None) is None
    assert pl.predicted_tick_cost_ms({}) is None
    # Measured EWMA wins.
    assert pl.predicted_tick_cost_ms({"tick_cost_ms": 3.5}) == 3.5
    # Falls back to per-frame component means x batch.
    prof = {"components_ms": {"assemble_h2d": {"mean_ms": 0.5},
                              "device": {"mean_ms": 1.0},
                              "d2h": {"mean_ms": 0.5}}}
    assert pl.predicted_tick_cost_ms(prof, batch_size=4) == 8.0


# ---------------------------------------------------------------------------
# Calibrations: persistence + warm-restart seeding
# ---------------------------------------------------------------------------


def test_calibration_round_trip_and_merge(tmp_path):
    d = str(tmp_path)
    cal = {"h2d_block_ms": 0.4, "d2h_block_ms": None,
           "step_block_ms": 2.25}
    assert pc.save_calibrations(d, TOPO, "b8|" + SIG, cal) is not None
    got = pc.load_calibrations(d, TOPO, "b8|" + SIG)
    # d2h None is preserved (legitimately unmeasured above the size
    # cap) — a seed must reproduce it, not invent a number.
    assert got == {"h2d_block_ms": 0.4, "d2h_block_ms": None,
                   "step_block_ms": 2.25}
    # Second signature merges into the same topology file.
    pc.save_calibrations(d, TOPO, "b4|other",
                         {"h2d_block_ms": 0.1, "step_block_ms": 1.0})
    assert pc.load_calibrations(d, TOPO, "b8|" + SIG) is not None
    assert pc.load_calibrations(d, TOPO, "b4|other") is not None
    # Other topology: miss.
    assert pc.load_calibrations(d, "tpu/v5e/n8/data=8",
                                "b8|" + SIG) is None


def test_calibration_incomplete_or_corrupt_is_miss(tmp_path):
    d = str(tmp_path)
    # A seed without a usable step cost is not worth skipping the
    # measurement passes for.
    pc.save_calibrations(d, TOPO, "s", {"h2d_block_ms": 0.4,
                                        "step_block_ms": None})
    assert pc.load_calibrations(d, TOPO, "s") is None
    pc.save_calibrations(d, TOPO, "s2", {"h2d_block_ms": None,
                                         "step_block_ms": 1.0})
    assert pc.load_calibrations(d, TOPO, "s2") is None
    with open(pc.calibration_path(d, TOPO), "w") as f:
        f.write("garbage")
    assert pc.load_calibrations(d, TOPO, "s") is None


def test_topology_fingerprint_meshless_matches_engine_device():
    """A meshless call (a planner with no engine yet) must equal the
    fingerprint a frontend computes from its engine's device, or a warm
    restart could never hit a plan a frontend cached. The port's
    fingerprint names its backend, so no entry the JAX package wrote,
    and no CPU entry, can match a card's."""
    from torch_serve_util import ServeFrontend

    from dvf_tpu_torch.ops import get_filter
    from dvf_tpu_torch.serve import ServeConfig

    meshless = pc.topology_fingerprint()
    assert meshless != "unknown"
    fe = ServeFrontend(get_filter("invert"), ServeConfig(batch_size=2))
    try:
        assert fe._topology_fingerprint() == meshless
        assert pc.topology_fingerprint(fe.engine.device) == meshless
    finally:
        fe.pool.close()
        fe.engine.free()
    # No card here; the axes are the one-device engine's mesh shape.
    assert meshless == "torch-cpu/cpu/n1/data=1,space=1,model=1"
    assert meshless != jax_pc.topology_fingerprint()
    assert pc.topology_fingerprint("cuda:0") != meshless
    assert not pc.topology_fingerprint("cuda:0").startswith("torch-cpu")
    # Never raises: an unusable device is a cold cache, not a crash.
    assert pc.topology_fingerprint("meta") == "unknown"
    assert pc.topology_fingerprint(object()) == "unknown"


def test_engine_calibration_seed_skips_remeasure(tmp_path):
    """Warm restart: the first frontend MEASURES and persists
    the calibration triple; a second frontend on the same cache dir
    seeds its engine from disk (engine.calibration_seeded) instead of
    re-running the blocking measurement passes."""
    from torch_serve_util import ServeFrontend

    from dvf_tpu_torch.runtime.signature import build_filter
    from dvf_tpu_torch.serve import ServeConfig

    d = str(tmp_path)

    def boot():
        fe = ServeFrontend(build_filter("invert"), ServeConfig(
            batch_size=2, plan_cache_dir=d)).start()
        sid = fe.open_stream(op_chain="invert", frame_shape=(16, 16, 3))
        fe.submit(sid, np.zeros((16, 16, 3), np.uint8))
        while not fe.poll(sid):
            pass
        with fe._lock:
            eng = fe._sessions[sid].bucket.engine
        seeded = eng.calibration_seeded
        cal = {"h2d": eng.h2d_block_ms, "step": eng.step_block_ms}
        fe.stop()
        return seeded, cal

    cold_seeded, cold_cal = boot()
    assert cold_seeded is False
    assert cold_cal["step"] is not None
    warm_seeded, warm_cal = boot()
    assert warm_seeded is True
    # The adopted triple IS the one the cold boot measured.
    assert warm_cal["step"] == pytest.approx(cold_cal["step"])


# ---------------------------------------------------------------------------
# Predictive elasticity: determinism + the half-watermark guard
# ---------------------------------------------------------------------------


def _ctl(predictive):
    from dvf_tpu_torch.control.fleet_elastic import (
        ElasticConfig,
        make_elasticity_controller,
    )

    cfg = ElasticConfig(min_replicas=1, max_replicas=4, out_after=2,
                        out_cooldown=4, predictive=predictive,
                        predict_slope_window=3, predict_horizon=4)
    return make_elasticity_controller(cfg)


def _row(bound, qd=0.0, cap=10.0, refusals=0.0):
    return {"bound_sessions": bound, "capacity_sessions": cap,
            "open_sessions": bound, "fleet_queue_depth": qd,
            "admission_refusals_total": refusals,
            "fleet_shed_total": 0.0, "fleet_slo_miss_total": 0.0,
            "replicas_desired": 1, "replicas_live": 1}


def _run(ctl, rows):
    prev, out = None, []
    for i, row in enumerate(rows):
        for a in ctl.step(dict(row), prev):
            out.append((i, a.kind, a.target, a.value, a.reason))
        prev = row
    return out


def test_predictive_spawns_before_reactive_on_a_ramp():
    # Occupancy climbing 1/sample toward high = 0.85*10: reactive fires
    # at bound >= 8.5; predictive projects 4 samples ahead and fires
    # once the current value clears the half-watermark guard.
    ramp = ([_row(float(b)) for b in range(1, 10)]
            + [_row(9.0)] * 4)
    p_act = _run(_ctl(True), ramp)
    r_act = _run(_ctl(False), ramp)
    p_out = next(i for i, k, *_ in p_act if k == "scale_out")
    r_out = next(i for i, k, *_ in r_act if k == "scale_out")
    assert p_out < r_out
    assert "projected" in p_act[0][4]


def test_predictive_half_watermark_guard_blocks_idle_slope():
    # One tenant opening on a near-idle fleet: slope > 0, projection
    # can cross anything, but the CURRENT value is nowhere near the
    # watermark — prediction must not invent pressure from noise.
    idle_blip = [_row(0.0), _row(1.0), _row(2.0), _row(2.0), _row(2.0),
                 _row(2.0)]
    assert _run(_ctl(True), idle_blip) == []


def test_predictive_is_a_strict_widening_of_reactive():
    # A window the reactive controller scales on (refusals advancing):
    # predictive scales too, no later.
    rows = [_row(3.0), _row(3.0, refusals=1.0), _row(3.0, refusals=2.0),
            _row(3.0, refusals=3.0)]
    r_act = _run(_ctl(False), rows)
    p_act = _run(_ctl(True), rows)
    r_out = [i for i, k, *_ in r_act if k == "scale_out"]
    p_out = [i for i, k, *_ in p_act if k == "scale_out"]
    assert r_out and p_out and p_out[0] <= r_out[0]


def test_predictive_replay_is_deterministic():
    rows = ([_row(float(b)) for b in range(1, 8)]
            + [_row(7.0, refusals=float(r)) for r in range(5)])
    assert _run(_ctl(True), rows) == _run(_ctl(True), rows)
    assert _run(_ctl(False), rows) == _run(_ctl(False), rows)


# ---------------------------------------------------------------------------
# Fleet elasticity controller (tests/test_elastic.py's controller class)
# ---------------------------------------------------------------------------

from dvf_tpu_torch.control import ElasticConfig  # noqa: E402
from dvf_tpu_torch.control.fleet_elastic import (  # noqa: E402
    FLAVOR_DEFAULT,
    FLAVOR_MULTIHOST,
    FleetElasticityController,
    fleet_pressure,
)


def _ecfg(**kw) -> ElasticConfig:
    base = dict(min_replicas=1, max_replicas=3, out_after=2,
                out_cooldown=4, in_after=5, in_cooldown=2,
                in_occupancy_frac=0.6, saturate_after=4, interval_s=0.1)
    base.update(kw)
    return ElasticConfig(**base)


def _erow(desired=1, live=None, refusals=0.0, cap=8.0, bound=0.0,
         queue=0.0, sessions=1.0, rows=None, **extra):
    r = {
        "replicas_desired": float(desired),
        "replicas_live": float(live if live is not None else desired),
        "admission_refusals_total": float(refusals),
        "capacity_sessions": float(cap),
        "bound_sessions": float(bound),
        "open_sessions": float(sessions),
        "fleet_queue_depth": float(queue),
        "replica_rows": rows if rows is not None else [
            {"rid": f"r{i}", "sessions": bound / max(1.0, float(desired)),
             "queue_depth": 0.0}
            for i in range(int(desired))
        ],
    }
    r.update(extra)
    return r


@pytest.mark.elastic
class TestFleetElasticityController:
    def _window(self, n=60):
        """One synthetic scaling episode: calm → refusal burst →
        sustained calm. Pure data — the determinism claim is over
        exactly this kind of recorded window."""
        rows = []
        refusals = 0.0
        desired = 1
        for i in range(n):
            burst = 10 <= i < 25
            if burst:
                refusals += 3.0
            # Model the plane's desired-at-enqueue bookkeeping: the row
            # AFTER a scale decision reflects the intent (the replay
            # harness records composed rows, which include it).
            rows.append(_erow(desired=desired, refusals=refusals,
                             cap=4.0 * desired,
                             bound=3.0 * desired if burst else 1.0,
                             sessions=2.0))
            if burst and i % 4 == 3 and desired < 3:
                desired += 1
            if not burst and i > 40 and desired > 1:
                desired -= 1
        return rows

    def test_same_window_replayed_twice_identical_actions(self):
        def run_once():
            ctl = FleetElasticityController(_ecfg())
            seq, prev = [], None
            for row in self._window():
                for a in ctl.step(dict(row), prev):
                    seq.append((a.kind, a.target, a.value, a.reason))
                prev = row
            return seq

        first, second = run_once(), run_once()
        assert first == second
        kinds = [a[0] for a in first]
        assert "scale_out" in kinds and "scale_in" in kinds

    def test_scale_out_on_refusals_with_cooldown_and_max(self):
        ctl = FleetElasticityController(_ecfg(out_after=2, out_cooldown=3,
                                              max_replicas=2))
        prev = None
        outs = []
        desired = 1
        for i in range(12):
            row = _erow(desired=desired, refusals=float(i))  # advancing
            acts = ctl.step(row, prev)
            prev = row
            for a in acts:
                if a.kind == "scale_out":
                    outs.append((i, a.value))
                    desired = a.value
        # First fire needs out_after samples WITH a prev (deltas), then
        # the cooldown gates; desired==max stops it for good.
        assert outs and outs[0][1] == 2
        assert desired == 2
        assert all(v <= 2 for _, v in outs)
        gaps = [b[0] - a[0] for a, b in zip(outs, outs[1:])]
        assert all(g > 3 for g in gaps)

    def test_scale_in_needs_calm_occupancy_headroom_and_min(self):
        ctl = FleetElasticityController(_ecfg(in_after=3))
        prev = None
        # Calm but FULL: survivors could not absorb the load — no
        # scale-in, ever.
        for _ in range(10):
            row = _erow(desired=2, cap=8.0, bound=6.0)
            assert ctl.step(row, prev) == []
            prev = row
        # Calm and nearly empty: the LEAST-loaded replica retires.
        ctl2 = FleetElasticityController(_ecfg(in_after=3))
        prev = None
        got = []
        rows = [{"rid": "r0", "sessions": 2.0, "queue_depth": 0.0},
                {"rid": "r1", "sessions": 0.0, "queue_depth": 0.0}]
        for _ in range(6):
            row = _erow(desired=2, cap=8.0, bound=2.0, rows=rows)
            got += [a for a in ctl2.step(row, prev)
                    if a.kind == "scale_in"]
            prev = row
        assert got and got[0].target == "r1" and got[0].value == 1
        # At min_replicas nothing retires no matter how calm.
        ctl3 = FleetElasticityController(_ecfg(in_after=2))
        prev = None
        for _ in range(8):
            row = _erow(desired=1, cap=4.0, bound=0.0)
            assert all(a.kind != "scale_in"
                       for a in ctl3.step(row, prev))
            prev = row

    def test_saturation_flight_once_per_episode(self):
        ctl = FleetElasticityController(
            _ecfg(max_replicas=1, saturate_after=3))
        prev = None
        flights = []
        for i in range(10):
            row = _erow(desired=1, refusals=float(i))
            flights += [a for a in ctl.step(row, prev)
                        if a.kind == "flight"]
            prev = row
        assert len(flights) == 1  # one dump per episode
        # Calm closes the episode; fresh pressure reopens it.
        for i in range(4):
            row = _erow(desired=1, refusals=10.0)
            ctl.step(row, prev)
            prev = row
        for i in range(10):
            row = _erow(desired=1, refusals=20.0 + i)
            flights += [a for a in ctl.step(row, prev)
                        if a.kind == "flight"]
            prev = row
        assert len(flights) == 2

    def test_two_axis_flavor_from_measured_profile(self):
        """The more-replicas vs bigger-replica choice keys off the
        MEASURED device stage cost (stage profiles): device-bound →
        multihost flavor; otherwise (or when the multihost leg is not
        configured) → default."""
        ctl = FleetElasticityController(
            _ecfg(bigger_replica_device_ms=50.0))
        base = dict(desired=1, refusals=1.0)
        heavy = _erow(**base, multihost_available=True,
                     profile_device_ms=120.0)
        light = _erow(**base, multihost_available=True,
                     profile_device_ms=3.0)
        unavail = _erow(**base, multihost_available=False,
                       profile_device_ms=120.0)
        assert ctl._flavor(heavy) == FLAVOR_MULTIHOST
        assert ctl._flavor(light) == FLAVOR_DEFAULT
        assert ctl._flavor(unavail) == FLAVOR_DEFAULT
        # Axis disabled entirely: never multihost.
        off = FleetElasticityController(_ecfg())
        assert off._flavor(heavy) == FLAVOR_DEFAULT

    def test_pressure_predicate_and_config_validation(self):
        cfg = _ecfg()
        calm = _erow(desired=2, cap=8.0, bound=2.0)
        assert fleet_pressure(calm, None, cfg) is None
        # Refusals must ADVANCE (lifetime totals never latch pressure).
        r1 = _erow(desired=2, refusals=5.0)
        assert fleet_pressure(r1, None, cfg) is None
        assert fleet_pressure(_erow(desired=2, refusals=6.0), r1, cfg)
        assert fleet_pressure(_erow(desired=2, refusals=5.0), r1,
                              cfg) is None
        # Occupancy and queue fire without a prev.
        assert fleet_pressure(_erow(desired=2, cap=8.0, bound=7.0),
                              None, cfg)
        assert fleet_pressure(_erow(desired=2, queue=50.0, sessions=2.0),
                              None, cfg)
        # p99 over SLO fires (no miss counter present).
        assert fleet_pressure(
            _erow(desired=2, fleet_p99_ms=900.0, slo_ms=500.0), None, cfg)
        with pytest.raises(ValueError, match="in_occupancy_frac"):
            FleetElasticityController(
                _ecfg(in_occupancy_frac=0.9, sessions_high_frac=0.85))


# ---------------------------------------------------------------------------
# Parity with dvf_tpu: the planner, the cache documents, the controllers
# ---------------------------------------------------------------------------

_CALS = [
    {"h2d_block_ms": 0.5, "d2h_block_ms": 0.2, "step_block_ms": 2.0},
    {"h2d_block_ms": 3.1, "d2h_block_ms": None, "step_block_ms": 0.4},
    None,
]
_PROFILE = {"components_ms": {"queue_bucket": {"mean_ms": 1.5},
                              "assemble_h2d": {"mean_ms": 0.25},
                              "device": {"mean_ms": 0.75},
                              "d2h": {"mean_ms": 0.3}},
            "tick_cost_ms": 4.0}


def _docs(plans):
    return [p.to_doc() for p in plans]


class TestPlannerParity:
    """Exact equality with the reference planner (float results
    included: both packages run the same Python arithmetic)."""

    @pytest.mark.parametrize("cap", [1, 4, 8, 16, 12])
    def test_candidate_grid_equal(self, cap):
        assert _docs(pl.candidate_grid(batch_cap=cap)) == _docs(
            jax_pl.candidate_grid(batch_cap=cap))
        if cap == 16:   # the grid of a batch-8 frontend (cap 2 x 8)
            assert len(pl.candidate_grid(batch_cap=cap)) == 45

    @pytest.mark.parametrize("cal", _CALS)
    @pytest.mark.parametrize("profile", [None, _PROFILE])
    def test_analytic_and_shortlist_equal(self, cal, profile):
        grid = pl.candidate_grid(batch_cap=16)
        jgrid = jax_pl.candidate_grid(batch_cap=16)
        for p, q in zip(grid, jgrid):
            assert pl.analytic_frame_ms(p, cal, 8, profile) == \
                jax_pl.analytic_frame_ms(q, cal, 8, profile)
        for budget in (None, 3):
            assert _docs(pl.shortlist(grid, cal, 8, profile, budget)) == \
                _docs(jax_pl.shortlist(jgrid, cal, 8, profile, budget))

    @pytest.mark.parametrize("scripted", ["batch", "tick", "errors"])
    def test_plan_search_equal_with_scripted_measurer(self, scripted):
        def measure(p):
            if scripted == "batch":
                return {"fps": p.batch_size * 100.0 - p.tick_s * 1e4}
            if scripted == "tick":
                return {"fps": 1000.0 - p.tick_s * 1e5 - p.ingest_depth}
            if p.batch_size > 2:
                return {"error": "burst stalled"}
            return {"fps": float(p.batch_size)}

        cal = _CALS[0]
        got, comp = pl.plan_search(pl.candidate_grid(batch_cap=16),
                                   measure, cal=cal, cal_batch=8,
                                   stage_profile=_PROFILE)
        want, jcomp = jax_pl.plan_search(
            jax_pl.candidate_grid(batch_cap=16), measure, cal=cal,
            cal_batch=8, stage_profile=_PROFILE)
        assert got.to_doc() == want.to_doc()
        assert comp == jcomp
        assert got.searched <= 15 and got.grid == 45

    def test_envelope_and_tick_cost_equal(self):
        for kw in ({"batch_size": 8, "tick_s": 0.001}, {"batch_size": 6},
                   {"batch_size": 1, "ingest_depth": 1}):
            assert pl.Plan(**kw).envelope() == jax_pl.Plan(**kw).envelope()
        for prof, b in ((None, 1), ({}, 1), (_PROFILE, 4),
                        ({"components_ms": _PROFILE["components_ms"]}, 4)):
            assert pl.predicted_tick_cost_ms(prof, batch_size=b) == \
                jax_pl.predicted_tick_cost_ms(prof, batch_size=b)

    def test_cache_documents_equal_but_for_topology(self, tmp_path):
        """The same plan and calibrations written by both packages give
        the same JSON documents, but for the fingerprint (and the write
        stamp); each package reads the other's file under its own
        fingerprint as a miss."""
        plan = _measured(batch_size=4, tick_s=0.002, ingest_depth=2)
        jplan = dataclasses.replace(jax_pl.Plan(
            batch_size=4, tick_s=0.002, ingest_depth=2),
            source=jax_pl.PLAN_SOURCE_MEASURED, measured_fps=100.0)
        assert plan.to_doc() == jplan.to_doc()
        port_topo = pc.topology_fingerprint()
        jax_topo = jax_pc.topology_fingerprint()
        d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
        p1 = pl.plan_to_cache(d_port, SIG, GEO, port_topo, plan)
        p2 = jax_pl.plan_to_cache(d_jax, SIG, GEO, jax_topo, jplan)
        cal = {"h2d_block_ms": 0.4, "d2h_block_ms": None,
               "step_block_ms": 2.25}
        c1 = pc.save_calibrations(d_port, port_topo, "b4|" + SIG, cal)
        c2 = jax_pc.save_calibrations(d_jax, jax_topo, "b4|" + SIG, cal)
        for a, b in ((p1, p2), (c1, c2)):
            with open(a) as f:
                da = json.load(f)
            with open(b) as f:
                db = json.load(f)
            assert da["topology"] == port_topo
            assert db["topology"] == jax_topo
            for doc in (da, db):
                doc.pop("topology")
                doc.pop("updated")
            assert da == db
        # The JAX package's entry never drives the port, and back.
        os.replace(p2, pc.plan_path(d_port, SIG, GEO, jax_topo))
        assert pl.plan_from_cache(d_port, SIG, GEO, port_topo) is not None
        assert pc.load_plan(d_port, SIG, GEO, jax_topo) is not None
        assert pc.plan_path(d_port, SIG, GEO, port_topo) != \
            pc.plan_path(d_port, SIG, GEO, jax_topo)
        assert pc.load_calibrations(d_jax, port_topo, "b4|" + SIG) is None

    def test_cpu_entry_misses_on_a_card(self, tmp_path):
        """A plan cached by a CPU run never answers a lookup made under
        a card's fingerprint (here an H100's, spelled as the port
        spells it)."""
        d = str(tmp_path)
        cpu = pc.topology_fingerprint("cpu")
        card = ("torch-cuda/NVIDIA H100 80GB HBM3/n1/driver=12080,"
                "cuda=12.8/devices=1")
        pl.plan_to_cache(d, SIG, GEO, cpu, _measured(batch_size=4))
        assert pl.plan_from_cache(d, SIG, GEO, cpu) is not None
        assert pl.plan_from_cache(d, SIG, GEO, card) is None


class TestElasticParity:
    def test_controller_actions_equal_reference(self):
        """The same scaling episode through both packages' controllers:
        identical actions, reasons included."""
        def run(mod):
            cfg = mod.ElasticConfig(
                min_replicas=1, max_replicas=3, out_after=2,
                out_cooldown=4, in_after=5, in_cooldown=2,
                in_occupancy_frac=0.6, saturate_after=4, interval_s=0.1,
                relay_subscribers_high=100, relay_out_after=2,
                relay_in_after=3, relay_cooldown=1, max_relays=2,
                bigger_replica_device_ms=50.0)
            ctl = mod.FleetElasticityController(cfg)
            seq, prev = [], None
            window = TestFleetElasticityController()._window()
            for i, row in enumerate(window):
                row = dict(row, broadcast_subscribers=300.0 if i < 20
                           else 0.0, relays_live=0.0,
                           multihost_available=i % 2 == 0,
                           profile_device_ms=120.0)
                for a in ctl.step(dict(row), prev):
                    seq.append((a.kind, a.target, a.value, a.reason))
                prev = row
            return seq

        port, ref = run(__import__("dvf_tpu_torch.control.fleet_elastic",
                                   fromlist=["x"])), run(jax_fe)
        assert port == ref
        assert {k for k, *_ in port} >= {"scale_out", "relay_out"}

    @pytest.mark.parametrize("predictive", [False, True])
    def test_predictive_actions_equal_reference(self, predictive):
        rows = ([_row(float(b)) for b in range(1, 10)]
                + [_row(9.0, refusals=float(r)) for r in range(6)]
                + [_row(1.0)] * 8)

        def make(mod):
            return mod.make_elasticity_controller(mod.ElasticConfig(
                min_replicas=1, max_replicas=4, out_after=2,
                out_cooldown=4, predictive=predictive,
                predict_slope_window=3, predict_horizon=4))

        from dvf_tpu_torch.control import fleet_elastic as port_fe
        assert _run(make(port_fe), rows) == _run(make(jax_fe), rows)
