"""Consolidation (the reference's `controllers/disruption/`), the solver's
second consumer: candidates and budgets, the scheduling simulation that
referees a removal, the batched feasibility sweeps over candidate removal
sets (`sweep.py`, `setsweep.py`), the methods that turn their verdicts
into Commands (`consolidation.py`, `staticdrift.py`), validation and
orchestration (`queue.py`) and the controller's loop (`controller.py`)."""

from karpenter_tpu_torch.controllers.disruption.consolidation import (
    DriftConsolidation,
    EmptinessConsolidation,
    MultiNodeConsolidation,
    SingleNodeConsolidation,
)
from karpenter_tpu_torch.controllers.disruption.controller import DisruptionController
from karpenter_tpu_torch.controllers.disruption.helpers import (
    BudgetMapping,
    build_budget_mapping,
    build_candidates,
    simulate_scheduling,
)
from karpenter_tpu_torch.controllers.disruption.queue import OrchestrationQueue, Validator
from karpenter_tpu_torch.controllers.disruption.setsweep import (
    SetProposer,
    SetSweepContext,
    sweep_sets,
)
from karpenter_tpu_torch.controllers.disruption.types import (
    DECISION_DELETE,
    DECISION_NOOP,
    DECISION_REPLACE,
    Candidate,
    Command,
    command_savings,
)

__all__ = [
    "BudgetMapping",
    "Candidate",
    "Command",
    "DECISION_DELETE",
    "DECISION_NOOP",
    "DECISION_REPLACE",
    "DisruptionController",
    "DriftConsolidation",
    "EmptinessConsolidation",
    "MultiNodeConsolidation",
    "OrchestrationQueue",
    "SetProposer",
    "SetSweepContext",
    "SingleNodeConsolidation",
    "Validator",
    "build_budget_mapping",
    "build_candidates",
    "command_savings",
    "simulate_scheduling",
    "sweep_sets",
]
