"""torch_budgets.json: the port's checked-in runtime-budget manifest.

A copy of the JAX package's `analysis/budgets.py` for the port's own
measurements (`runtime.py`): every entry carries a one-line justification,
stale or orphaned entries fail the gate so the file cannot rot, and
re-baselining is an explicit `python -m karpenter_tpu_torch.analysis
--budgets --write-budgets` that keeps each entry's justification.

Metric policy, declared in `METRIC_POLICY`:

- `exact`: the measured value must EQUAL the budget. Used for absolute
  contracts: per-solve table uploads, the calls of each kernel seam,
  dispatches, the hand-written kernels' launches, zero rebuilds.
- `ceiling`: the measured value must not EXCEED the budget. Used for
  counts that may fall for good reasons (torch's own kernels, syncs and
  copies, device bytes, a kernel's registers) but must never grow unseen.

Two scopes share the file. The `cuda:`-prefixed entries are measured on
the card only; the others on either route, where they must read the same.
Each scope compares against its own `scoped()` view, so a CPU run never
reads a `cuda:` entry as orphaned, and `render(..., cuda_scope=...)`
carries the other scope over verbatim on `--write-budgets`.

Pure stdlib, importable without torch.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

DEFAULT_MANIFEST = "torch_budgets.json"

# the entries only the card measures
CUDA_PREFIX = "cuda:"

# the placeholder a new entry gets from render(); --write-budgets refuses it
TODO_JUSTIFICATION = "TODO: justify or fix"

# metric name -> enforcement policy; a manifest metric outside this table
# is reported as unknown (the manifest rotted or the tool regressed)
METRIC_POLICY: dict[str, str] = {
    # uploads per solve (TorchScheduler._tables, _upload_pod_tables,
    # _pod_xs_with_idx calls): the JAX package's names and policies
    "table_uploads": "exact",
    "pod_table_uploads": "exact",
    "pod_batch_uploads": "ceiling",
    # the device-table cache: a repeat same-epoch solve uploads only its
    # pending-pod batch
    "epoch_first_table_uploads": "exact",
    "epoch_repeat_table_uploads": "exact",
    "epoch_repeat_pod_table_uploads": "exact",
    "epoch_repeat_pod_batch_uploads": "ceiling",
    # fleet windows: the first may upload once per lane in a cache-miss
    # race, a repeat uploads nothing and is one dispatch
    "fleet_first_window_table_uploads": "ceiling",
    "fleet_repeat_window_table_uploads": "exact",
    "fleet_repeat_window_dispatches": "exact",
    # removal-set sweeps: tables once per context, 1024 sets one dispatch
    "set_table_uploads": "exact",
    "set_pod_table_uploads": "exact",
    "set_eval_dispatches": "exact",
    # calls of each kernel seam (runtime.CALLS), either route
    "calls_typeok_screen": "exact",
    "calls_run_arrays": "exact",
    "calls_solve_runs": "exact",
    "calls_solve_scan": "exact",
    "calls_dedup_columns": "exact",
    "calls_solve_scan_lanes": "exact",
    "calls_scan_lanes": "exact",
    "calls_fast_sweep": "exact",
    "calls_set_sweep": "exact",
    # cuda: one profiled window (runtime.DeviceWindow)
    "launches_hand": "exact",
    "launches_torch": "ceiling",
    "host_syncs": "ceiling",
    "h2d_copies": "ceiling",
    "d2h_copies": "ceiling",
    "second_solve_builds": "exact",
    "second_solve_library_loads": "exact",
    "same_bucket_solve_segments": "exact",
    "peak_device_bytes": "ceiling",
    # cuda:kernel:<name>, from ptxas
    "registers": "ceiling",
    "smem_bytes": "ceiling",
    "spill_store_bytes": "ceiling",
}


def canonical_json(data: dict) -> str:
    """The manifest's byte-stable serialization (a copy of the JAX
    package's `analysis.engine.canonical_json`)."""
    return json.dumps(data, indent=2, sort_keys=True, ensure_ascii=False) + "\n"


@dataclasses.dataclass
class BudgetIssue:
    """One manifest-vs-measurement discrepancy."""

    kind: str  # regression | structure-mismatch | missing-entry |
    #            orphaned-entry | unknown-metric | missing-metric |
    #            unjustified | unseen-seam | improvement
    entry: str
    metric: Optional[str]
    budget: Optional[int]
    measured: Optional[int]

    def render(self) -> str:
        if self.kind == "regression":
            return (
                f"{self.entry}: {self.metric} regressed — measured "
                f"{self.measured} exceeds the budget {self.budget} "
                "(--write-budgets to re-baseline, then justify)"
            )
        if self.kind == "structure-mismatch":
            return (
                f"{self.entry}: {self.metric} changed — measured "
                f"{self.measured}, budget pins {self.budget} (exact-match; "
                "re-baseline with justification)"
            )
        if self.kind == "missing-entry":
            return (
                f"{self.entry}: no budget entry — a new measurement; "
                "run --write-budgets and justify it"
            )
        if self.kind == "orphaned-entry":
            return (
                f"{self.entry}: budget entry matches no measured entry "
                "— remove it (the measurement moved or was renamed)"
            )
        if self.kind == "missing-metric":
            return (
                f"{self.entry}: budget has no `{self.metric}` value but the "
                "tool measures it — re-baseline"
            )
        if self.kind == "unjustified":
            return (
                f"{self.entry}: no justification — add a one-line reason "
                f"in {DEFAULT_MANIFEST}"
            )
        if self.kind == "unseen-seam":
            return (
                f"{self.entry}: the counted seam {self.metric} made no host "
                "sync in this entry's window — name the entry whose window "
                "runs it (rules_kernel.COUNTED_SEAMS)"
            )
        if self.kind == "improvement":
            return (
                f"{self.entry}: {self.metric} measured {self.measured} is "
                f"under the budget {self.budget} — consider tightening the "
                "ceiling (--write-budgets)"
            )
        return (
            f"{self.entry}: unknown metric `{self.metric}` in the manifest "
            "— remove it"
        )


@dataclasses.dataclass
class Comparison:
    issues: list[BudgetIssue]
    # measured strictly under a ceiling budget: legitimate (a warm cache, a
    # real improvement) but worth surfacing so ceilings get tightened
    improvements: list[BudgetIssue]


class ManifestError(ValueError):
    """The manifest file is not JSON of the manifest's schema."""


def _justification(e: dict) -> str:
    return str(e.get("justification", "")).strip()


def is_justified(e: dict) -> bool:
    j = _justification(e)
    return bool(j) and not j.startswith("TODO")


class BudgetManifest:
    """Load/compare/render torch_budgets.json.

    Schema:
        {"entries": {"<entry>": {
            "justification": "<one line>",
            "metrics": {"<metric>": <int>, ...}}}}
    Serialization is canonical (`canonical_json`), so a re-written
    manifest with unchanged content is byte-identical."""

    def __init__(self, entries: dict[str, dict], path: Optional[str] = None):
        self.entries = entries
        self.path = path

    @classmethod
    def load(cls, path: str) -> "BudgetManifest":
        """The manifest at `path` (empty when there is none). Raises
        ManifestError on a file that is not the manifest's schema."""
        if not os.path.exists(path):
            return cls({}, path)
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError) as e:
            raise ManifestError(f"{path}: {e}") from e
        entries = data.get("entries") if isinstance(data, dict) else None
        if not isinstance(entries, dict):
            raise ManifestError(f"{path}: no `entries` object")
        for name, e in entries.items():
            metrics = e.get("metrics") if isinstance(e, dict) else None
            if not isinstance(metrics, dict) or not all(
                isinstance(v, int) and not isinstance(v, bool) for v in metrics.values()
            ):
                raise ManifestError(f"{path}: entry {name!r} has no integer `metrics` object")
        return cls(dict(entries), path)

    def scoped(self, cuda: bool) -> "BudgetManifest":
        """One scope's slice of the manifest: the card's `cuda:` entries,
        or everything else. Each scope compares against its own slice, so
        the other scope's entries never read as orphaned."""
        return BudgetManifest(
            {name: e for name, e in self.entries.items() if name.startswith(CUDA_PREFIX) == cuda},
            self.path,
        )

    def unjustified(self) -> list[str]:
        """Entry names whose justification is empty or a TODO placeholder."""
        return sorted(name for name, e in self.entries.items() if not is_justified(e))

    def compare(self, measured: dict[str, dict[str, int]]) -> Comparison:
        issues: list[BudgetIssue] = []
        improvements: list[BudgetIssue] = []
        for name in sorted(measured):
            entry = self.entries.get(name)
            if entry is None:
                issues.append(BudgetIssue("missing-entry", name, None, None, None))
                continue
            if not is_justified(entry):
                issues.append(BudgetIssue("unjustified", name, None, None, None))
            budget_metrics = dict(entry.get("metrics", {}))
            for metric in sorted(measured[name]):
                got = int(measured[name][metric])
                if metric not in budget_metrics:
                    issues.append(BudgetIssue("missing-metric", name, metric, None, got))
                    continue
                want = int(budget_metrics.pop(metric))
                policy = METRIC_POLICY.get(metric)
                if policy == "exact":
                    if got != want:
                        issues.append(BudgetIssue("structure-mismatch", name, metric, want, got))
                elif policy == "ceiling":
                    if got > want:
                        issues.append(BudgetIssue("regression", name, metric, want, got))
                    elif got < want:
                        improvements.append(BudgetIssue("improvement", name, metric, want, got))
                else:
                    issues.append(BudgetIssue("unknown-metric", name, metric, want, got))
            for metric in sorted(budget_metrics):
                # budgeted but no longer measured: the tool dropped the
                # metric or the manifest carries a typo
                issues.append(BudgetIssue("unknown-metric", name, metric, int(budget_metrics[metric]), None))
        for name in sorted(set(self.entries) - set(measured)):
            issues.append(BudgetIssue("orphaned-entry", name, None, None, None))
        return Comparison(issues=issues, improvements=improvements)

    def check(self, cpu: dict, cuda: Optional[dict] = None) -> Comparison:
        """Each measured scope against its own slice: the CPU scope's
        entries, and the `cuda:` entries when the card measured them."""
        issues: list[BudgetIssue] = []
        improvements: list[BudgetIssue] = []
        for scope, measured in ((False, cpu), (True, cuda)):
            if measured is not None:
                cmp = self.scoped(scope).compare(measured)
                issues += cmp.issues
                improvements += cmp.improvements
        return Comparison(issues=issues, improvements=improvements)

    @staticmethod
    def render(
        measured: dict[str, dict[str, int]],
        existing: Optional["BudgetManifest"] = None,
        cuda_scope: Optional[bool] = None,
    ) -> dict:
        """Manifest dict for --write-budgets. Entries that already exist
        keep their justification; new ones get the TODO placeholder (which
        --write-budgets refuses to write).

        `cuda_scope` names the scope being written (True: the `cuda:`
        entries, False: the others, None: the whole file): the OTHER
        scope's existing entries are carried over verbatim."""
        entries = {}
        if cuda_scope is not None and existing is not None:
            for name, e in existing.entries.items():
                if name.startswith(CUDA_PREFIX) != cuda_scope:
                    entries[name] = {
                        "justification": str(e.get("justification", "")),
                        "metrics": {m: int(v) for m, v in sorted(dict(e.get("metrics", {})).items())},
                    }
        for name in sorted(measured):
            old = (existing.entries.get(name) if existing else None) or {}
            entries[name] = {
                "justification": str(old.get("justification", TODO_JUSTIFICATION)),
                "metrics": {m: int(v) for m, v in sorted(measured[name].items())},
            }
        return {"entries": entries}

    @staticmethod
    def dumps(data: dict) -> str:
        return canonical_json(data)
