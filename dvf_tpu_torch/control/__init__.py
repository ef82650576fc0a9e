"""Load-adaptive control plane — the fifth tier, above supervision
(port of ``dvf_tpu.control``).

The resilience plane makes the runtime degrade gracefully on *faults*;
this package makes
it degrade gracefully on *load*: closed-loop controllers read the
serving telemetry ring (queue depth, SLO headroom, fps, p99 at a
fixed cadence) and actuate the knobs the runtime already exposes —
per-bucket batch size and the dispatch tick budget, per-session
resolution (with the ``ops/sr.py`` upscale stage restoring full
client-visible resolution), and priority-tier admission — so a traffic
burst past capacity bends p99 instead of collapsing it.

See `control.controllers` for the decision logic (deterministic,
replayable) and `control.plane` for the loop wiring.
"""

from dvf_tpu_torch.control.controllers import (
    TIER_BATCH,
    TIER_INTERACTIVE,
    TIER_NAMES,
    TIER_STANDARD,
    Action,
    BatchTickController,
    ControlConfig,
    QualityController,
    TierAdmissionController,
    is_pressure,
)
from dvf_tpu_torch.control.fleet_elastic import (
    FLAVOR_DEFAULT,
    FLAVOR_MULTIHOST,
    ElasticConfig,
    FleetElasticityController,
    PredictiveElasticityController,
    fleet_pressure,
    make_elasticity_controller,
)
from dvf_tpu_torch.control.plan_cache import (
    PLANNER_VERSION,
    load_calibrations,
    load_plan,
    save_calibrations,
    save_plan,
    topology_fingerprint,
)
from dvf_tpu_torch.control.plane import ControlPlane
from dvf_tpu_torch.control.planner import (
    DEFAULT_PLAN,
    Plan,
    analytic_frame_ms,
    candidate_grid,
    plan_from_cache,
    plan_search,
    plan_to_cache,
    predicted_tick_cost_ms,
    shortlist,
)

__all__ = [
    "Action",
    "BatchTickController",
    "ControlConfig",
    "ControlPlane",
    "DEFAULT_PLAN",
    "ElasticConfig",
    "FLAVOR_DEFAULT",
    "FLAVOR_MULTIHOST",
    "FleetElasticityController",
    "PLANNER_VERSION",
    "Plan",
    "PredictiveElasticityController",
    "QualityController",
    "TierAdmissionController",
    "TIER_BATCH",
    "TIER_INTERACTIVE",
    "TIER_NAMES",
    "TIER_STANDARD",
    "analytic_frame_ms",
    "candidate_grid",
    "fleet_pressure",
    "is_pressure",
    "load_calibrations",
    "load_plan",
    "make_elasticity_controller",
    "plan_from_cache",
    "plan_search",
    "plan_to_cache",
    "predicted_tick_cost_ms",
    "save_calibrations",
    "save_plan",
    "shortlist",
    "topology_fingerprint",
]
