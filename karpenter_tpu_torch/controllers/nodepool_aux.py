"""NodePool auxiliary controllers + node health (repair).

Reference pkg/controllers/nodepool/{hash,counter,readiness,
registrationhealth,validation} and node/health/controller.go:106-203.
"""

from __future__ import annotations

import re
from collections import deque
from typing import Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import COND_NODE_CLASS_READY, COND_NODE_REGISTRATION_HEALTHY
from karpenter_tpu_torch.controllers.kube import Conflict, NotFound, SimKube
from karpenter_tpu_torch.controllers.nodeclaim_aux import NODEPOOL_HASH_VERSION, nodepool_hash
from karpenter_tpu_torch.controllers.state import Cluster
from karpenter_tpu_torch.events import Event, Recorder
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch import metrics

NODEPOOL_USAGE = metrics.REGISTRY.gauge(
    "karpenter_nodepools_usage",
    "Resource usage per nodepool.",
    ("nodepool", "resource_type"),
)
NODEPOOL_NODE_COUNT = metrics.REGISTRY.gauge(
    "karpenter_nodepools_node_count", "Node count per nodepool.", ("nodepool",)
)
NODES_REPAIRED = metrics.REGISTRY.counter(
    "karpenter_nodes_repaired_total", "Nodes force-deleted by auto-repair.", ("condition",)
)


class NodePoolHash:
    """nodepool/hash: propagate the drift hash onto the NodePool annotations
    (hash/controller.go:55). NodeClaims pick it up at hydration/creation."""

    def __init__(self, kube: SimKube):
        self.kube = kube

    def reconcile_all(self) -> None:
        for np in self.kube.list("NodePool"):
            want = nodepool_hash(np)
            ann = np.metadata.annotations
            if (
                ann.get(well_known.NODEPOOL_HASH_ANNOTATION_KEY) == want
                and ann.get(well_known.NODEPOOL_HASH_VERSION_ANNOTATION_KEY)
                == NODEPOOL_HASH_VERSION
            ):
                continue
            ann[well_known.NODEPOOL_HASH_ANNOTATION_KEY] = want
            ann[well_known.NODEPOOL_HASH_VERSION_ANNOTATION_KEY] = NODEPOOL_HASH_VERSION
            try:
                self.kube.update("NodePool", np)
            except (Conflict, NotFound):
                pass


class NodePoolCounter:
    """nodepool/counter: aggregate owned node resources into NodePool status
    (counter/controller.go:70)."""

    def __init__(self, kube: SimKube, cluster: Cluster):
        self.kube = kube
        self.cluster = cluster

    def reconcile_all(self) -> None:
        totals: dict[str, dict] = {}
        counts: dict[str, int] = {}
        for sn in self.cluster.state_nodes():
            np_name = sn.nodepool_name
            if np_name is None:
                continue
            totals[np_name] = res.merge(totals.get(np_name, {}), sn.capacity())
            counts[np_name] = counts.get(np_name, 0) + 1
        for np in self.kube.list("NodePool"):
            want_res = totals.get(np.name, {})
            want_count = counts.get(np.name, 0)
            if np.status_resources == want_res and np.status_node_count == want_count:
                continue
            np.status_resources = want_res
            np.status_node_count = want_count
            try:
                self.kube.update("NodePool", np)
            except (Conflict, NotFound):
                continue
            NODEPOOL_NODE_COUNT.set(float(want_count), {"nodepool": np.name})
            for rname, v in want_res.items():
                NODEPOOL_USAGE.set(
                    float(v), {"nodepool": np.name, "resource_type": rname}
                )


class NodePoolReadiness:
    """nodepool/readiness: NodeClassReady condition (readiness/controller.go:53).
    In-tree providers have no external NodeClass objects, so readiness is a
    provider callback (ready unless the provider objects)."""

    def __init__(self, kube: SimKube, cloud):
        self.kube = kube
        self.cloud = cloud

    def reconcile_all(self) -> None:
        for np in self.kube.list("NodePool"):
            ready = True
            checker = getattr(self.cloud, "node_class_ready", None)
            if checker is not None:
                ready = bool(checker(np))
            want = "True" if ready else "False"
            if np.conditions.get(COND_NODE_CLASS_READY) != want:
                np.conditions[COND_NODE_CLASS_READY] = want
                try:
                    self.kube.update("NodePool", np)
                except (Conflict, NotFound):
                    pass


class RegistrationHealth:
    """nodepool/registrationhealth + pkg/state/nodepoolhealth: the
    NodeRegistrationHealthy condition driven by a fixed ring buffer of
    registration outcomes. Reference tracker semantics exactly
    (tracker.go:27-81): buffer of 4, status Unknown while empty, Unhealthy
    when falses/4 >= 0.5 (the DENOMINATOR is the buffer capacity even when
    partially filled), else Healthy. Condition flips happen at observation
    time through a dry-run of the would-be buffer (registration.go:113-123
    on success, liveness.go:128-157 on a registration timeout) — not by a
    periodic sweep. reconcile_all mirrors the nodepool controller
    (registrationhealth/controller.go:73-89): re-hydrate the buffer from
    a surviving condition after restart, and reset to Unknown when the
    NodePool spec changed (the drift hash stands in for generation)."""

    BUFFER = 4  # tracker.go:27 BufferSize
    THRESHOLD = 0.5  # tracker.go:29 ThresholdFalse

    UNKNOWN, HEALTHY, UNHEALTHY = "Unknown", "Healthy", "Unhealthy"

    def __init__(self, kube: SimKube):
        self.kube = kube
        self._buf: dict[str, deque] = {}
        self._observed_hash: dict[str, str] = {}

    # -- tracker (pkg/state/nodepoolhealth/tracker.go) --------------------

    def _buffer(self, nodepool: str) -> deque:
        return self._buf.setdefault(nodepool, deque(maxlen=self.BUFFER))

    def _status_of(self, items) -> str:
        if not items:
            return self.UNKNOWN
        falses = sum(1 for v in items if not v)
        if falses / self.BUFFER >= self.THRESHOLD:
            return self.UNHEALTHY
        return self.HEALTHY

    def status(self, nodepool: str) -> str:
        return self._status_of(self._buf.get(nodepool) or ())

    def dry_run(self, nodepool: str, ok: bool) -> str:
        """tracker.go DryRun: status if `ok` were inserted now."""
        items = list(self._buf.get(nodepool) or ())[-(self.BUFFER - 1):]
        return self._status_of(items + [ok])

    def set_status(self, nodepool: str, status: str) -> None:
        buf = self._buffer(nodepool)
        buf.clear()
        if status == self.HEALTHY:
            buf.append(True)
        elif status == self.UNHEALTHY:
            for _ in range(int(self.BUFFER * self.THRESHOLD)):
                buf.append(False)

    # -- observation entry point (lifecycle controller calls this) --------

    def record_launch(self, nodepool: str, ok: bool) -> None:
        """A registration outcome: success when the claim registered
        (registration.go:123), failure when the liveness TTL deleted it
        first (liveness.go:156). Flips the NodePool condition when the
        dry-run crosses the threshold, THEN commits the observation —
        the reference's exact order."""
        np = self.kube.try_get("NodePool", nodepool)
        if np is not None:
            cond = np.conditions.get(COND_NODE_REGISTRATION_HEALTHY)
            want = None
            if ok and cond != "True" and (
                self.dry_run(nodepool, True) == self.HEALTHY
            ):
                want = "True"
            elif not ok and cond != "False" and (
                self.dry_run(nodepool, False) == self.UNHEALTHY
            ):
                want = "False"
            if want is not None:
                np.conditions[COND_NODE_REGISTRATION_HEALTHY] = want
                try:
                    self.kube.update("NodePool", np)
                except (Conflict, NotFound):
                    pass
        self._buffer(nodepool).append(ok)

    # -- the nodepool controller sweep ------------------------------------

    def reconcile_all(self) -> None:
        for np in self.kube.list("NodePool"):
            cond = np.conditions.get(COND_NODE_REGISTRATION_HEALTHY)
            # restart hydration (registrationhealth/controller.go:73-80)
            if self.status(np.name) == self.UNKNOWN and cond in ("True", "False"):
                self.set_status(
                    np.name, self.HEALTHY if cond == "True" else self.UNHEALTHY
                )
            # spec change resets to Unknown (controller.go:83-88; the drift
            # hash is this model's generation)
            h = nodepool_hash(np)
            prev = self._observed_hash.get(np.name)
            self._observed_hash[np.name] = h
            if prev is not None and prev != h:
                self.set_status(np.name, self.UNKNOWN)
                if cond != "Unknown":
                    np.conditions[COND_NODE_REGISTRATION_HEALTHY] = "Unknown"
                    try:
                        self.kube.update("NodePool", np)
                    except (Conflict, NotFound):
                        pass


# -- CEL-equivalent validators (nodepool.go markers; helpers shared by
# NodePoolValidation.validate) ------------------------------------------------

_NAME_RE = re.compile(r"^[A-Za-z0-9]([A-Za-z0-9._-]*[A-Za-z0-9])?$")
_DNS1123_RE = re.compile(r"^[a-z0-9]([a-z0-9-]*[a-z0-9])?(\.[a-z0-9]([a-z0-9-]*[a-z0-9])?)*$")
# Budget.Nodes (nodepool.go:122): 0-100% or a non-negative integer
_BUDGET_NODES_RE = re.compile(r"^((100|[0-9]{1,2})%|[0-9]+)$")
_CRON_SPECIALS = frozenset(
    {"@annually", "@yearly", "@monthly", "@weekly", "@daily", "@midnight", "@hourly"}
)


def _qualified_name_err(key: str) -> Optional[str]:
    """k8s.io/apimachinery validation.IsQualifiedName: [prefix/]name with a
    DNS-1123-subdomain prefix <= 253 chars and a name part <= 63."""
    if not key:
        return "name part must be non-empty"
    parts = key.split("/")
    if len(parts) > 2:
        return "a qualified name must consist of alphanumeric characters"
    if len(parts) == 2:
        prefix, name = parts
        if not prefix:
            return "prefix part must be non-empty"
        if len(prefix) > 253:
            return "prefix part must be no more than 253 characters"
        if not _DNS1123_RE.match(prefix):
            return "prefix part must be a DNS-1123 subdomain"
    else:
        name = parts[0]
    if not name:
        return "name part must be non-empty"
    if len(name) > 63:
        return "name part must be no more than 63 characters"
    if not _NAME_RE.match(name):
        return (
            "name part must consist of alphanumeric characters, '-', '_' "
            "or '.', and must start and end with an alphanumeric character"
        )
    return None


def _label_value_err(value: str) -> Optional[str]:
    if value == "":
        return None
    if len(value) > 63:
        return "must be no more than 63 characters"
    if not _NAME_RE.match(value):
        return (
            "a valid label value must be an empty string or consist of "
            "alphanumeric characters, '-', '_' or '.'"
        )
    return None


def _validate_template_labels(labels: dict) -> Optional[str]:
    """nodepool_validation.go:33 validateLabels."""
    for key, value in labels.items():
        if key == well_known.NODEPOOL_LABEL_KEY:
            return f"invalid key name {key!r} in labels, restricted"
        err = _qualified_name_err(key)
        if err:
            return f"invalid key name {key!r} in labels, {err}"
        err = _label_value_err(value)
        if err:
            return f"invalid value: {value} for label[{key}], {err}"
        err = well_known.is_restricted_label(key)
        if err:
            return f"invalid key name {key!r} in labels, {err}"
    return None


def _validate_taint(taint) -> Optional[str]:
    """CEL taint rules (nodepool.go taints markers + CEL test families):
    key required + qualified, value a valid label value, effect one of the
    three kubelet effects."""
    if not taint.key:
        return "taint key is required"
    err = _qualified_name_err(taint.key)
    if err:
        return f"invalid taint key {taint.key!r}, {err}"
    err = _label_value_err(taint.value)
    if err:
        return f"invalid taint value {taint.value!r}, {err}"
    if str(getattr(taint.effect, "value", taint.effect)) not in (
        "NoSchedule", "PreferNoSchedule", "NoExecute",
    ):
        return f"invalid taint effect {taint.effect!r}"
    return None


_SUPPORTED_OPS = frozenset(
    {"In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"}
)


def validate_requirement(r) -> Optional[str]:
    """nodeclaim_validation.go:115 ValidateRequirement, shared by the
    NodePool template validator and the provisioner's per-pod selector
    validation (provisioner.go:573 validateNodeSelectorTerm): normalized
    key, supported operator, restricted-label check, qualified name, label
    values, In non-empty, minValues bounds, Gt/Lt integer shape, and
    well-known value sets."""
    key = well_known.NORMALIZED_LABELS.get(r.key, r.key)
    err = _qualified_name_err(key)
    if err:
        return f"key {key} is not a qualified name, {err}"
    err = well_known.is_restricted_label(key)
    if err:
        return err
    op = str(getattr(r.operator, "value", r.operator))
    if op not in _SUPPORTED_OPS:
        return f"key {key} has an unsupported operator {op}"
    for v in r.values:
        err = _label_value_err(v)
        if err:
            return f"invalid value {v} for key {key}, {err}"
    if op == "In" and not r.values:
        return f"key {key} with operator 'In' must have a value defined"
    if op in ("Gt", "Lt"):
        ok = len(r.values) == 1
        if ok:
            try:
                ok = int(r.values[0]) >= 0
            except ValueError:
                ok = False
        if not ok:
            return (
                f"key {key} with operator {op!r} must have a single "
                "positive integer value"
            )
    mv = getattr(r, "min_values", None)
    if mv is not None:
        if mv < 1:
            return "minValues must be at least 1"
        if mv > 50:
            return "minValues must be no more than 50"
        # raw length, no dedup (nodeclaim_validation.go:142 compares
        # len(Values) directly)
        if op == "In" and len(r.values) < mv:
            return (
                "requirements with 'minValues' must have at least that many "
                "values specified in the 'values' field"
            )
    # validateWellKnownValues (nodeclaim_validation.go:164-191): an In set
    # for a key with a known value universe must keep at least one known
    # value — and at least minValues of them when minValues is set
    known = well_known.WELL_KNOWN_VALUES_FOR_REQUIREMENTS.get(key)
    if known is not None and op == "In" and r.values:
        valid = [v for v in r.values if v in known]
        if not valid:
            return (
                f"no valid values found in {r.values} for {key}, expected "
                f"one of: {sorted(known)}"
            )
        if mv is not None and len(valid) < mv:
            return (
                f"only {len(valid)} valid values found in {r.values} for "
                f"{key}, expected at least {mv}"
            )
    return None


def _validate_requirement(r) -> Optional[str]:
    """Template-side requirement rules: ValidateRequirement plus the
    nodepool-key rejection (nodepool_validation.go:50
    validateRequirementsNodePoolKeyDoesNotExist)."""
    if r.key == well_known.NODEPOOL_LABEL_KEY:
        return f"invalid key: {r.key!r} in requirements, restricted"
    return validate_requirement(r)


def _valid_cron(expr: str) -> bool:
    """The CRD's schedule pattern (nodepool.go:129): an @special or five
    whitespace-separated fields. Deliberately permissive — name-based
    fields like \"MON-FRI\" are valid cron; full parsing happens where
    schedules are evaluated, exactly as the reference defers to
    cron.ParseStandard at use time."""
    expr = expr.strip()
    if expr.startswith("@"):
        return expr in _CRON_SPECIALS
    return len(expr.split()) == 5


def _validate_budget(budget) -> Optional[str]:
    """Budget CEL rules: nodes pattern (nodepool.go:122), schedule cron
    (nodepool.go:129), duration without seconds (nodepool.go:138), and
    'schedule must be set with duration' (nodepool.go:99)."""
    raw = budget.nodes.strip()
    if not _BUDGET_NODES_RE.match(raw):
        return f"invalid budget nodes value: {raw!r}"
    has_schedule = budget.schedule is not None
    has_duration = budget.duration_seconds is not None
    if has_schedule != has_duration:
        return "'schedule' must be set with 'duration'"
    if has_schedule and not _valid_cron(budget.schedule):
        return f"invalid budget schedule {budget.schedule!r}"
    if has_duration:
        d = budget.duration_seconds
        # the CRD pattern admits hours/minutes only — no seconds, no sign
        if d < 0 or d != int(d) or int(d) % 60 != 0:
            return "budget duration must be a non-negative h/m duration"
    return None


class NodePoolValidation:
    """nodepool/validation: runtime spec validation — the CRD's CEL surface
    absorbed (validation/controller.go:51 + nodepool_validation.go:28)."""

    def __init__(self, kube: SimKube, recorder: Optional[Recorder] = None):
        self.kube = kube
        self.recorder = recorder

    def reconcile_all(self) -> dict[str, str]:
        problems: dict[str, str] = {}
        for np in self.kube.list("NodePool"):
            err = self.validate(np)
            if err is not None:
                problems[np.name] = err
                if self.recorder:
                    self.recorder.publish(
                        Event("NodePool", np.name, "Warning", "FailedValidation", err)
                    )
        return problems

    @staticmethod
    def validate(np) -> Optional[str]:
        """The CRD's CEL rule table + RuntimeValidate, absorbed into one
        runtime check (reference nodepool.go:39-232 XValidation/Pattern
        markers + nodepool_validation.go:28 RuntimeValidate; scenario
        families mirrored from nodepool_validation_cel_test.go). Returns
        the FIRST problem found, reference-ordered: labels, taints,
        requirements, budgets, then scalar fields."""
        err = _validate_template_labels(np.template.labels)
        if err:
            return err
        for taint in list(np.template.taints) + list(np.template.startup_taints):
            err = _validate_taint(taint)
            if err:
                return err
        if len(np.template.requirements) > 100:
            return "requirements exceed the 100-item limit"
        for r in np.template.requirements:
            err = _validate_requirement(r)
            if err:
                return err
        if len(np.disruption.budgets) > 50:
            return "budgets exceed the 50-item limit"
        for budget in np.disruption.budgets:
            err = _validate_budget(budget)
            if err:
                return err
        if np.disruption.consolidate_after_seconds < 0:
            return "consolidateAfter must be >= 0"
        # weight: optional, 1..100 when set (nodepool.go:60-61; 0 = unset)
        if np.weight < 0 or np.weight > 100:
            return "weight must be in [1, 100]"
        if np.replicas is not None:
            # static-pool CEL rules (nodepool.go:39-41)
            if np.replicas < 0:
                return "replicas must be >= 0"
            if np.weight:
                return "'weight' is not supported on static NodePools"
            extra = [k for k in np.limits if k != "nodes"]
            if extra:
                return "only 'limits.nodes' is supported on static NodePools"
        return None


class NodeHealth:
    """node/health: force-delete nodes whose provider repair-policy
    conditions stayed unhealthy past the toleration window
    (health/controller.go:106). Gated by the NodeRepair feature flag."""

    def __init__(self, kube: SimKube, cluster: Cluster, cloud, clock, recorder=None):
        self.kube = kube
        self.cluster = cluster
        self.cloud = cloud
        self.clock = clock
        self.recorder = recorder
        self._unhealthy_since: dict[tuple[str, str], float] = {}

    def reconcile_all(self) -> int:
        policies = self.cloud.repair_policies()
        if not policies:
            return 0
        repaired = 0
        now = self.clock.now()
        for node in self.kube.list("Node"):
            if node.metadata.deletion_timestamp is not None:
                continue
            for policy in policies:
                key = (node.name, policy.condition_type)
                status = node.conditions.get(policy.condition_type)
                if status != policy.condition_status:
                    self._unhealthy_since.pop(key, None)
                    continue
                since = self._unhealthy_since.setdefault(key, now)
                if now - since < policy.toleration_seconds:
                    continue
                sn = self.cluster.node_by_name(node.name)
                claim = sn.node_claim if sn is not None else None
                if claim is not None:
                    try:
                        self.kube.delete("NodeClaim", claim.name)
                    except NotFound:
                        pass
                else:
                    try:
                        self.kube.delete("Node", node.name)
                    except NotFound:
                        pass
                NODES_REPAIRED.inc({"condition": policy.condition_type})
                if self.recorder:
                    self.recorder.publish(
                        Event(
                            "Node", node.name, "Warning", "NodeRepair",
                            f"condition {policy.condition_type} unhealthy for "
                            f"{now - since:.0f}s; replacing",
                        )
                    )
                repaired += 1
                break
        return repaired
