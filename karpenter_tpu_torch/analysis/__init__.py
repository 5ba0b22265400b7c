"""The port's analysis: graftlint's AST, race and protocol tiers, and the
runtime budgets, aimed at the port's own tree.

The reference's `analysis` package has five tiers. Here:

- **AST** (`engine.py`, `rules_kernel.py`, `rules_data.py`,
  `rules_threads.py`, `rules_metrics.py`, `rules_wire.py`,
  `rules_docs.py`; `--ast`): the reference's rules, ids, suppression
  syntax (`# graftlint: disable=<rule>`), baseline format and exit codes,
  over karpenter_tpu_torch/, tests/test_torch_*.py, chip_smoke.py and
  tools/*_phase.py, under torch_graftlint.baseline.json. `kernel-purity`
  and `tracer-leak` take the port's meaning: no host sync on the card path
  outside the seams torch_budgets.json counts (rules_kernel.py).
- **Race** (`locks.py`, `--race`; `racert.py`, the runtime witness): the
  reference's whole-program lock analysis over the same tree, its blocking
  set widened to torch's host syncs, under
  torch_graftlint.race.baseline.json; the witness runs under the port's
  service and resilient tests and chip_smoke.py's sidecar phase.
- **Protocol** (`proto.py`, `--proto`; `protorec.py`, the recorder the
  solver boundary's hooks write to): the reference's model, checker,
  shrinker and judge, with live scenarios on the port's ResilientSolver,
  CircuitBreaker and SolverServer. The shared corpus tests/proto_corpus/
  is replayed, never written.
- **IR** and **SPMD** read jaxprs and HLO, which the port has none of.
  Their rules map onto what the port measures instead:
  - `ir-transfer`, `ir-retrace`, `ir-carry-budget` -> torch_budgets.json's
    uploads (`table_uploads`, `pod_table_uploads`, `pod_batch_uploads`),
    rebuilds (`second_solve_builds`, `second_solve_library_loads`) and
    launches (`launches_hand`, the seams' `calls_*`): the runtime budgets
    (`budgets.py`, `runtime.py`, `--budgets`);
  - `ir-callbacks` -> the port's `kernel-purity` (no host sync on the card
    path outside a counted seam);
  - `ir-dtype` -> the int32 / u32-as-int32 contract of the kernels'
    arguments, pinned by the differential tests (tests/test_torch_*.py
    hold every kernel's plain version to the JAX package bit for bit);
  - `spmd-hbm` -> `peak_device_bytes` in torch_budgets.json;
  - `spmd-collectives`, `spmd-donation` -> empty on one card;
  - `spmd-launch-lock` -> the race tier over fleet.py's locks.

Importing this package pulls in neither torch, numpy nor JAX: every tier
is stdlib-only at import; the protocol tier's live scenarios and the
budgets' measurements import the port's solver stack lazily.

    python -m karpenter_tpu_torch.analysis --ast|--race|--proto|--all [--json]
    python -m karpenter_tpu_torch.analysis --budgets [--device cpu|cuda]
"""

from karpenter_tpu_torch.analysis.engine import (
    Baseline,
    Config,
    FileContext,
    Finding,
    Rule,
    all_rules,
    analyze_files,
    discover_files,
    run_analysis,
)

__all__ = [
    "Baseline",
    "Config",
    "FileContext",
    "Finding",
    "Rule",
    "all_rules",
    "analyze_files",
    "discover_files",
    "run_analysis",
]
