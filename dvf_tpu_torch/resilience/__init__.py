"""Fault taxonomy, deterministic fault injection, error budgets, and the
stall watchdog / supervised recovery (port of ``dvf_tpu.resilience``): the
shared fault model the pipeline and the ZMQ worker classify into and
escalate through.
"""

from dvf_tpu_torch.resilience.budget import ErrorBudget, escalate
from dvf_tpu_torch.resilience.chaos import ChaosFault, ChaosRule, FaultPlan
from dvf_tpu_torch.resilience.faults import (
    ALL_KINDS,
    FaultError,
    FaultKind,
    FaultStats,
    classify,
)
from dvf_tpu_torch.resilience.supervisor import InflightWindow, Supervisor

__all__ = [
    "ALL_KINDS",
    "ChaosFault",
    "ChaosRule",
    "ErrorBudget",
    "FaultError",
    "FaultKind",
    "FaultPlan",
    "FaultStats",
    "InflightWindow",
    "Supervisor",
    "classify",
    "escalate",
]
