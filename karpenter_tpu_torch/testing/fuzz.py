"""Differential chaos fuzzer over the scheduling surface: the port's copy
of karpenter_tpu/testing/fuzz.py, on the port's own api, cloudprovider,
solver and wire modules. `generate_case(seed)` consumes its RNG exactly as
the reference's does, so one seed gives one problem dict in both packages
(`case.problem`, the carrier the port's tests compare). The solvers take
a `device` (None = the card; "cpu" runs the kernels' plain versions).

The reference's correctness contract is its ~46.5k LoC scenario corpus
(SURVEY.md §4); the hand-ported matrices (tests/test_reference_suite.py,
tests/test_topology_matrix.py) cover the scenarios someone thought to
write. This module covers the ones nobody did: seeded, deterministic
property-based generation of cluster states + pod mixes spanning the
full scheduling surface, consumed by three harness modes that share the
SAME case:

- **parity** (`check_parity`): kernel-supported cases must make
  bit-identical decisions on `solver/oracle.py` and `solver/tpu.py`
  (`TorchScheduler`) —
  across BOTH kernel paths (the runs result is re-checked through a
  forced scan solve), under relax on AND off (a preference-bearing case
  re-runs both sides with PreferencePolicy=Ignore), and through the
  claim-slot regrow path (an undersized slot pool must be N-invariant).
- **invariants** (`check_invariants`): oracle-independent checks on any
  `Results` from the production `TorchHybridScheduler` path (so mixed
  supported/unsupported cases are exercised too): every pod lands
  exactly once or errors; no capacity overcommit on any surviving
  instance type or existing node; integer milli-units end to end
  (utils/resources.py); taints respected on every placement; host ports
  never double-booked per claim; relax-ladder completeness (a pod whose
  only constraints are preferences never fails while an untainted,
  unlimited template fits it — scheduler.go:434 relaxes all the way).
- **chaos** (`chaos_violations`): the identical case driven through a
  live `SolverServer` under the shared fault proxy
  (karpenter_tpu_torch/testing/faults.py) — wire faults with retries, epoch
  desync storms, mid-solve server kill, admission RETRY — plus a
  fleet-window scenario with sibling lanes; every answer must be
  decision-identical to the in-process referee.

Failures shrink (`shrink`: delta-debug pod drops + per-feature strips,
monotone, bounded) and serialize into the pinned corpus at
tests/fuzz_corpus/*.json (`save_corpus_case`), which both packages'
corpus readers replay (`load_corpus`, `corpus_case`). A case that only
the port can finish (one the reference's runs walk spins on) is pinned in
a port test, never in that directory: tests/test_fuzz_differential.py
replays it through the JAX package. Cases serialize through the wire
codec (`wire.encode_problem_dict` / `_decode_problem_dict`), so a corpus
file is replayable byte-for-byte through every mode including the
sidecar.

Everything here is host-side python; the kernels under test are the
port's own.
"""

from __future__ import annotations

import hashlib
import json
import numbers
import os
import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import (
    LabelSelector,
    Node,
    NodeSelectorRequirement,
    ObjectMeta,
    Operator,
    PodAffinityTerm,
    PodPhase,
    Taint,
    TaintEffect,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
    WhenUnsatisfiable,
)
from karpenter_tpu_torch.cloudprovider import fake
from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
from karpenter_tpu_torch.cloudprovider.types import Offering
from karpenter_tpu_torch.scheduling import Requirement, Requirements, Taints
from karpenter_tpu_torch.scheduling.hostports import HostPortUsage, get_host_ports
from karpenter_tpu_torch.solver.nodes import StateNodeView
from karpenter_tpu_torch.solver.oracle import Results, Scheduler, SchedulerOptions
from karpenter_tpu_torch.solver.topology import ClusterSource, Topology
from karpenter_tpu_torch.testing import fixtures
from karpenter_tpu_torch.utils import resources as res

# every scheduling family the generator can emit; the reference's
# distribution test (tests/test_fuzz_machinery.py) asserts each one appears
# in a seeded batch, and tests/test_torch_fuzz.py that the port generates
# the same cases — a silent generator gap would fake coverage
FAMILIES = (
    "generic",
    "gt_lt",
    "zone_in",
    "zone_notin",
    "exists",
    "selector",
    "taints",
    "spread_zone",
    "spread_hostname",
    "schedule_anyway",
    "affinity",
    "anti_affinity",
    "preferences",
    "host_ports",
    "volumes",
    "daemonsets",
    "existing_nodes",
    "bound_pods",
    "limits",
    "weights",
    "min_values",
    "reserved",
    "bucket_edge",
    "tight_slots",
    "ignore_preferences",
)

_KWOK_ZONES = ["test-zone-a", "test-zone-b", "test-zone-c", "test-zone-d"]
_FAKE_ZONES = ["test-zone-1", "test-zone-2", "test-zone-3"]
_CPU_CHOICES = [100, 250, 500, 1000, 1500]
_MEM_CHOICES = [100, 256, 512, 1024, 2048]
_PORT_CHOICES = [80, 443, 8080]


@dataclass
class FuzzCase:
    """One seeded case in its canonical (corpus/wire) form. `problem` is
    a `wire.encode_problem_dict` payload; every consumer re-decodes it
    through `wire._decode_problem_dict` — the same path a sidecar
    request takes — so parity, invariant, chaos, and corpus replays all
    see byte-identical worlds by construction."""

    seed: int
    families: list[str] = field(default_factory=list)
    problem: dict = field(default_factory=dict)

    def materialize(self):
        """Fresh (pools, its_by_pool, pods, views, daemons, options,
        cluster) — new objects every call, so one case can feed several
        mutating solvers."""
        from karpenter_tpu_torch.wire import _decode_problem_dict

        pools, ibp, pods, views, daemons, options, _force, source = (
            _decode_problem_dict(self.problem)
        )
        return pools, ibp, pods, views, daemons, options, source


def encode_case_problem(
    pools, ibp, pods, views, daemons, options, cluster
) -> dict:
    """The canonical problem dict (service wire schema) for a case."""
    from karpenter_tpu_torch.wire import encode_problem_dict

    return encode_problem_dict(
        pools,
        ibp,
        pods,
        views,
        daemons,
        options,
        False,
        cluster.namespace_labels if cluster is not None else None,
        cluster,
    )


# ---------------------------------------------------------------------------
# seeded generation


def fuzz_seed_base(default: int = 7000) -> int:
    """The batch base seed; the FUZZ_SEED env var overrides it so a CI
    failure's printed repro command replays the exact batch."""
    raw = os.environ.get("FUZZ_SEED")
    return int(raw) if raw else default


def repro_command(seed: int, mode: str = "parity", device: str = "cuda") -> str:
    """What a human runs to replay one case deterministically through the
    port on `device` ("cuda": the card's kernels; "cpu": their plain
    versions). Chaos-mode failures live in the SERVICE layer, so their
    repro drives the case's scenario through a live sidecar; parity and
    invariant failures replay both in-process checks."""
    if mode.startswith("chaos"):
        scenario = mode.split(":", 1)[1] if ":" in mode else "wire"
        call = f"fuzz.chaos_violations(c, {scenario!r}, tempfile.mkdtemp(), device={device!r})"
    else:
        call = f"fuzz.check_parity(c, device={device!r}) + fuzz.check_invariants(c, device={device!r})"
    return (
        "python -c 'import tempfile; from karpenter_tpu_torch.testing import fuzz; "
        f"c = fuzz.generate_case({seed}); print({call})'"
    )


def _group_requests(rng: random.Random) -> dict:
    return {
        "cpu": f"{rng.choice(_CPU_CHOICES)}m",
        "memory": f"{rng.choice(_MEM_CHOICES)}Mi",
    }


def generate_case(seed: int) -> FuzzCase:
    """Deterministic case from one integer seed. Pods are emitted in
    class GROUPS (shared labels/requirements) so the class-dedup encode
    and the bulk/run kernel phases are exercised, with per-group family
    toggles spanning FAMILIES. Names, uids, and timestamps are pinned
    from the seed — the FFD tiebreak sorts on uid, so reproducibility
    requires owning identity end to end."""
    rng = random.Random(seed)
    used: set[str] = set()

    # -- universe ---------------------------------------------------------
    fake_universe = rng.random() < 0.25
    if fake_universe:
        its = fake.default_instance_types()
        zones = list(_FAKE_ZONES)
    else:
        sizes = rng.choice([[2], [2, 8], [2, 4], [4, 16], [2, 8, 32]])
        its = construct_instance_types(sizes=sizes)
        zones = list(_KWOK_ZONES)

    # -- reserved offerings (non-strict rides the kernel) -----------------
    options = SchedulerOptions()
    options.tpu_min_pods = 0  # fuzz always exercises the kernel route
    if rng.random() < 0.08:
        used.add("reserved")
        it0 = its[rng.randrange(len(its))]
        it0.offerings.append(
            Offering(
                requirements=Requirements(
                    [
                        Requirement(
                            well_known.TOPOLOGY_ZONE_LABEL_KEY,
                            Operator.IN,
                            [zones[0]],
                        ),
                        Requirement(
                            well_known.CAPACITY_TYPE_LABEL_KEY,
                            Operator.IN,
                            ["reserved"],
                        ),
                        Requirement(
                            well_known.RESERVATION_ID_LABEL_KEY,
                            Operator.IN,
                            [f"res-{seed % 97}"],
                        ),
                    ]
                ),
                price=0.01,
                available=True,
                reservation_capacity=rng.randint(1, 4),
            )
        )
        options.reserved_capacity_enabled = True
        if rng.random() < 0.2:
            options.reserved_offering_strict = True

    # -- node pools -------------------------------------------------------
    pool_kw: dict = {}
    if rng.random() < 0.2:
        used.add("zone_in")
        pool_kw["requirements"] = [
            NodeSelectorRequirement(
                well_known.TOPOLOGY_ZONE_LABEL_KEY,
                Operator.IN,
                sorted(rng.sample(zones, rng.randint(1, min(2, len(zones))))),
            )
        ]
    if rng.random() < 0.12:
        used.add("limits")
        pool_kw["limits"] = {"cpu": str(rng.choice([8, 16, 30]))}
    if rng.random() < 0.08:
        used.add("min_values")
        pool_kw.setdefault("requirements", []).append(
            NodeSelectorRequirement(
                well_known.INSTANCE_TYPE_LABEL_KEY,
                Operator.EXISTS,
                min_values=rng.randint(2, 6),
            )
        )
        if rng.random() < 0.5:
            options.min_values_best_effort = True
    pools = [fixtures.node_pool(name="default", **pool_kw)]
    taint = None
    if rng.random() < 0.3:
        used.update(("taints", "weights"))
        taint = Taint(
            "fuzz.io/team",
            rng.choice(
                [
                    TaintEffect.NO_SCHEDULE,
                    TaintEffect.NO_EXECUTE,
                    TaintEffect.PREFER_NO_SCHEDULE,
                ]
            ),
            "a",
        )
        pools.append(
            fixtures.node_pool(name="dedicated", weight=10, taints=[taint])
        )
    elif rng.random() < 0.15:
        used.add("weights")
        pools.append(fixtures.node_pool(name="fallback", weight=1))
    ibp = {np_.name: its for np_ in pools}

    # -- existing nodes ---------------------------------------------------
    views: Optional[list[StateNodeView]] = None
    if rng.random() < 0.3:
        used.add("existing_nodes")
        views = []
        for vi in range(rng.randint(1, 3)):
            it = its[rng.randrange(len(its))]
            zone = rng.choice(zones)
            name = f"fz-{seed}-node-{vi}"
            labels = {
                well_known.TOPOLOGY_ZONE_LABEL_KEY: zone,
                well_known.HOSTNAME_LABEL_KEY: name,
                well_known.INSTANCE_TYPE_LABEL_KEY: it.name,
                well_known.CAPACITY_TYPE_LABEL_KEY: "on-demand",
                well_known.OS_LABEL_KEY: "linux",
                well_known.ARCH_LABEL_KEY: "amd64",
                well_known.NODEPOOL_LABEL_KEY: pools[0].name,
            }
            alloc = dict(it.allocatable())
            # leave 25-100% of each resource available (integer math)
            frac = rng.choice([4, 2, 4, 1])
            avail = {k: v // frac if frac > 1 else v for k, v in alloc.items()}
            v = StateNodeView(
                name=name,
                node_labels={well_known.TOPOLOGY_ZONE_LABEL_KEY: zone},
                labels=labels,
                available=avail,
                capacity=dict(it.capacity),
                initialized=rng.random() < 0.9,
            )
            if rng.random() < 0.3:
                used.add("host_ports")
                squatter = fixtures.pod(name=f"fz-{seed}-squat-{vi}")
                squatter.metadata.uid = f"fz-{seed}-squat-{vi}"
                v.host_port_usage.add(squatter, [("0.0.0.0", "TCP", 443)])
            views.append(v)

    # -- daemonsets -------------------------------------------------------
    daemons = None
    if rng.random() < 0.2:
        used.add("daemonsets")
        daemons = []
        for di in range(rng.randint(1, 2)):
            d = fixtures.pod(
                name=f"fz-{seed}-ds-{di}", requests={"cpu": "100m"}
            )
            d.metadata.uid = f"fz-{seed}-ds-{di}"
            if rng.random() < 0.3:
                used.add("host_ports")
                d.host_ports = [("0.0.0.0", "TCP", 10250 + di)]
            daemons.append(d)

    # -- pending pods, in class groups ------------------------------------
    if rng.random() < 0.15:
        used.add("bucket_edge")
        n = rng.choice([15, 16, 17, 31, 32, 33, 63, 64, 65])
    else:
        n = rng.randint(4, 28)
    n_groups = rng.randint(1, min(4, n))
    counts = [n // n_groups] * n_groups
    counts[0] += n - sum(counts)
    pods = []
    pod_i = 0
    for gi, cnt in enumerate(counts):
        group_labels = {"fuzz-group": f"g{gi}", "app": rng.choice("xyz")}
        requests = _group_requests(rng)
        kw: dict = {}
        family = rng.choice(
            [
                "generic",
                "generic",
                "spread_zone",
                "spread_hostname",
                "affinity",
                "anti_affinity",
                "preferences",
                "selector",
                "zone_in",
                "zone_notin",
                "exists",
                "gt_lt",
                "host_ports",
                "volumes",
            ]
        )
        if family == "gt_lt" and not fake_universe:
            family = "zone_in"
        used.add(family)
        if family == "selector":
            sel_zone = rng.choice(zones + ["no-such-zone"])
            kw["node_selector"] = {well_known.TOPOLOGY_ZONE_LABEL_KEY: sel_zone}
        elif family == "zone_in":
            kw["node_requirements"] = [
                NodeSelectorRequirement(
                    well_known.TOPOLOGY_ZONE_LABEL_KEY,
                    Operator.IN,
                    sorted(rng.sample(zones, rng.randint(1, 2))),
                )
            ]
        elif family == "zone_notin":
            kw["node_requirements"] = [
                NodeSelectorRequirement(
                    well_known.TOPOLOGY_ZONE_LABEL_KEY,
                    Operator.NOT_IN,
                    sorted(rng.sample(zones, rng.randint(1, len(zones) - 1))),
                )
            ]
        elif family == "exists":
            kw["node_requirements"] = [
                NodeSelectorRequirement(
                    well_known.TOPOLOGY_ZONE_LABEL_KEY, Operator.EXISTS
                )
            ]
        elif family == "gt_lt":
            kw["node_requirements"] = [
                NodeSelectorRequirement(
                    fake.INTEGER_INSTANCE_LABEL_KEY,
                    rng.choice([Operator.GT, Operator.LT]),
                    [str(rng.choice([2, 4, 8]))],
                )
            ]
        elif family in ("spread_zone", "spread_hostname"):
            anyway = rng.random() < 0.3
            if anyway:
                used.add("schedule_anyway")
            key = (
                well_known.TOPOLOGY_ZONE_LABEL_KEY
                if family == "spread_zone"
                else well_known.HOSTNAME_LABEL_KEY
            )
            kw["topology_spread_constraints"] = [
                TopologySpreadConstraint(
                    max_skew=rng.randint(1, 2),
                    topology_key=key,
                    when_unsatisfiable=(
                        WhenUnsatisfiable.SCHEDULE_ANYWAY
                        if anyway
                        else WhenUnsatisfiable.DO_NOT_SCHEDULE
                    ),
                    label_selector=LabelSelector(
                        match_labels=dict(group_labels)
                    ),
                    min_domains=(
                        rng.randint(2, 3)
                        if family == "spread_zone" and rng.random() < 0.2
                        else None
                    ),
                )
            ]
        elif family == "affinity":
            kw["pod_requirements"] = [
                PodAffinityTerm(
                    topology_key=well_known.TOPOLOGY_ZONE_LABEL_KEY,
                    label_selector=LabelSelector(
                        match_labels=dict(group_labels)
                    ),
                )
            ]
        elif family == "anti_affinity":
            kw["pod_anti_requirements"] = [
                PodAffinityTerm(
                    topology_key=rng.choice(
                        [
                            well_known.HOSTNAME_LABEL_KEY,
                            well_known.TOPOLOGY_ZONE_LABEL_KEY,
                        ]
                    ),
                    label_selector=LabelSelector(
                        match_labels=dict(group_labels)
                    ),
                )
            ]
        elif family == "preferences":
            kw["node_preferences"] = [
                NodeSelectorRequirement(
                    well_known.TOPOLOGY_ZONE_LABEL_KEY,
                    Operator.IN,
                    [rng.choice(zones + ["no-such-zone"])],
                )
            ]
            if rng.random() < 0.5:
                kw["pod_anti_preferences"] = [
                    WeightedPodAffinityTerm(
                        weight=10,
                        term=PodAffinityTerm(
                            topology_key=well_known.TOPOLOGY_ZONE_LABEL_KEY,
                            label_selector=LabelSelector(
                                match_labels=dict(group_labels)
                            ),
                        ),
                    )
                ]
        if taint is not None and rng.random() < 0.6:
            kw["tolerations"] = [
                Toleration(
                    key=taint.key,
                    operator="Equal",
                    value=taint.value,
                    effect=taint.effect,
                )
            ]
        for i in range(cnt):
            p = fixtures.pod(
                name=f"fz-{seed}-p{pod_i}",
                labels=dict(group_labels),
                requests=dict(requests),
                creation_timestamp=float(pod_i),
                **kw,
            )
            p.metadata.uid = f"fz-{seed}-{pod_i:04d}"
            if family == "host_ports" and i % 2 == 0:
                p.host_ports = [
                    (
                        rng.choice(["", "0.0.0.0", "10.1.1.1"]),
                        "TCP",
                        rng.choice(_PORT_CHOICES),
                    )
                ]
            if family == "volumes" and i % 2 == 0:
                p.volume_claims = [f"pvc-{seed}-{gi}"]
            pods.append(p)
            pod_i += 1

    # -- bound cluster pods (existing anti-affinity/spread state) ---------
    cluster = ClusterSource()
    if views and rng.random() < 0.4:
        used.add("bound_pods")
        nodes_by_name = {
            v.name: Node(
                metadata=ObjectMeta(name=v.name, labels=dict(v.labels))
            )
            for v in views
        }
        bound = []
        for bi in range(rng.randint(1, 3)):
            b = fixtures.pod(
                name=f"fz-{seed}-bound-{bi}",
                labels={"fuzz-group": f"g{rng.randrange(n_groups)}"},
                requests={"cpu": "50m"},
            )
            b.metadata.uid = f"fz-{seed}-bound-{bi}"
            b.node_name = views[bi % len(views)].name
            b.phase = PodPhase.RUNNING
            bound.append(b)
        cluster = ClusterSource(
            pods_by_namespace={"default": bound}, nodes_by_name=nodes_by_name
        )

    # -- options tail -----------------------------------------------------
    if rng.random() < 0.1:
        used.add("tight_slots")
        options.claim_slot_div = 10_000  # floor-64 slot pool: regrow path
    if rng.random() < 0.08:
        used.add("ignore_preferences")
        options.ignore_preferences = True
    used.add("generic")

    # identity is part of the case: pool uids ride the wire codec, and a
    # random uid would make the same seed encode two different corpora
    for pi, np_ in enumerate(pools):
        np_.metadata.uid = f"fz-{seed}-pool-{pi}"

    problem = encode_case_problem(
        pools, ibp, pods, views, daemons, options, cluster
    )
    return FuzzCase(seed=seed, families=sorted(used), problem=problem)


# ---------------------------------------------------------------------------
# shared solve plumbing


def results_snapshot(r: Results, pods) -> tuple:
    """The full decision picture two solvers must agree on: the node
    partition with surviving instance types + accumulated requests, the
    existing-node placements, the failed-pod set, and the timeout flag
    (pods compared by NAME — each solve materializes its own objects)."""
    name = {p.uid: p.name for p in pods}
    claims = sorted(
        (
            tuple(sorted(name[p.uid] for p in c.pods)),
            c.template.nodepool_name,
            tuple(sorted(it.name for it in c.instance_type_options)),
            tuple(sorted(c.requests.items())),
        )
        for c in r.new_node_claims
        if c.pods
    )
    existing = sorted(
        (n.view.name, tuple(sorted(name[p.uid] for p in n.pods)))
        for n in r.existing_nodes
        if n.pods
    )
    errors = tuple(sorted(name[u] for u in r.pod_errors))
    return claims, existing, errors, bool(r.timed_out)


def _canonical(x):
    """A snapshot as plain JSON values: sequences as lists, flags as bools,
    every other number as a Python int, every name as a str (a numpy int
    and a Python int of one value give the same text)."""
    if isinstance(x, (tuple, list)):
        return [_canonical(v) for v in x]
    if isinstance(x, bool):
        return x
    if isinstance(x, str):
        return str(x)
    if isinstance(x, numbers.Number):
        if int(x) != x:
            raise ValueError(f"a snapshot holds a fraction: {x!r}")
        return int(x)
    raise TypeError(f"a snapshot holds a {type(x).__name__}: {x!r}")


def snapshot_digest(snapshot: tuple) -> str:
    """The sha256 hex of a `results_snapshot` (this package's or the JAX
    package's) as canonical JSON: two solves agree on their decisions when
    their digests are equal."""
    text = json.dumps(_canonical(snapshot), separators=(",", ":"), ensure_ascii=True)
    return hashlib.sha256(text.encode()).hexdigest()


def solve_oracle(case: FuzzCase, ignore_preferences=None):
    pools, ibp, pods, views, daemons, options, source = case.materialize()
    if ignore_preferences is not None:
        options.ignore_preferences = ignore_preferences
    topo = Topology(
        pools,
        ibp,
        pods,
        cluster=source,
        state_node_views=views,
        ignore_preferences=options.ignore_preferences,
    )
    s = Scheduler(pools, ibp, topo, views, daemons, options)
    return s.solve(pods), pods


def solve_tpu(
    case: FuzzCase,
    force_scan: bool = False,
    claim_slot_div: Optional[int] = None,
    ignore_preferences=None,
    device=None,
):
    from karpenter_tpu_torch.solver.tpu import TorchScheduler

    pools, ibp, pods, views, daemons, options, source = case.materialize()
    if claim_slot_div is not None:
        options.claim_slot_div = claim_slot_div
    if ignore_preferences is not None:
        options.ignore_preferences = ignore_preferences
    topo = Topology(
        pools,
        ibp,
        pods,
        cluster=source,
        state_node_views=views,
        ignore_preferences=options.ignore_preferences,
    )
    s = TorchScheduler(pools, ibp, topo, views, daemons, options, device=device)
    if force_scan:
        s.debug_force_scan = True
    return s.solve(pods), pods, s


def solve_hybrid(case: FuzzCase, device=None):
    """The production dispatch (kernel + oracle continuation for
    unsupported pods) — what the invariant mode checks, so mixed cases
    are exercised exactly as a control plane would run them."""
    from karpenter_tpu_torch.solver.hybrid import TorchHybridScheduler

    pools, ibp, pods, views, daemons, options, source = case.materialize()
    topo = Topology(
        pools,
        ibp,
        pods,
        cluster=source,
        state_node_views=views,
        ignore_preferences=options.ignore_preferences,
    )
    h = TorchHybridScheduler(pools, ibp, topo, views, daemons, options, device=device)
    return h.solve(pods), pods, h


def kernel_supported(case: FuzzCase) -> bool:
    """Whether the whole case can ride TorchScheduler directly (strict
    parity applies). Mixed/unsupported cases are still covered by the
    invariant and chaos modes through the hybrid dispatch."""
    from karpenter_tpu_torch.solver.tpu_problem import pod_unsupported_reason

    _pools, _ibp, pods, _views, _daemons, options, _src = case.materialize()
    if options.reserved_offering_strict:
        return False  # gated to the oracle before encode (CLAUDE.md)
    return all(
        pod_unsupported_reason(p, options.ignore_preferences) is None
        for p in pods
    )


# ---------------------------------------------------------------------------
# mode (a): differential parity


def check_parity(
    case: FuzzCase,
    tight_slots: bool = True,
    device=None,
    want_snap: Optional[tuple] = None,
    want_snap_relax_off: Optional[tuple] = None,
) -> list[str]:
    """TPU-vs-oracle bit-parity for kernel-supported cases, across both
    kernel paths, the regrow path (`tight_slots=False` skips that extra
    device solve — the smoke tier samples it every few cases to stay
    inside tier-1's budget), and relax on/off. Returns violation strings
    (empty = clean); an UnsupportedBySolver raise on a supported-looking
    case means a whole-problem encode gate fired — legal by design, but
    the production fallback (HybridScheduler -> pristine oracle) is then
    checked differentially, so a gate that CORRUPTS instead of refusing
    still surfaces. `want_snap` and `want_snap_relax_off`, when given,
    are the oracle's snapshots of the case (`oracle_snapshots`) taken
    elsewhere, e.g. by a process beside the card's."""
    from karpenter_tpu_torch.solver.tpu_problem import UnsupportedBySolver

    if not kernel_supported(case):
        return []
    violations: list[str] = []
    if want_snap is None:
        want_snap = results_snapshot(*solve_oracle(case))
    try:
        got, pods_t, sched = solve_tpu(case, device=device)
    except UnsupportedBySolver as e:
        # a WHOLE-PROBLEM gate (zone-keyed inverse anti-affinity, all
        # templates filtered out, ...): per-pod taxonomy can't see these,
        # and the production contract is HybridScheduler catching the
        # raise and falling back to a pristine oracle solve. That
        # fallback path is what must stay oracle-identical — check it
        # differentially instead of calling a designed gate a bug (the
        # seed7013 corpus pin replays exactly this shape).
        hr, hpods, _h = solve_hybrid(case, device=device)
        if results_snapshot(hr, hpods) != want_snap:
            return [
                f"hybrid fallback diverged after kernel gate ({e}): "
                f"hybrid={results_snapshot(hr, hpods)} oracle={want_snap}"
            ]
        return []
    got_snap = results_snapshot(got, pods_t)
    if got_snap != want_snap:
        violations.append(
            f"parity[{'runs' if sched.last_used_runs else 'scan'}]: "
            f"tpu={got_snap} oracle={want_snap}"
        )
    if sched.last_used_runs:
        scan_got, scan_pods, _ = solve_tpu(case, force_scan=True, device=device)
        if results_snapshot(scan_got, scan_pods) != want_snap:
            violations.append(
                f"parity[forced-scan]: "
                f"tpu={results_snapshot(scan_got, scan_pods)} "
                f"oracle={want_snap}"
            )
    # claim-slot regrow N-invariance: an undersized slot pool may only
    # change iteration structure, never decisions
    if tight_slots:
        tight_got, tight_pods, _ = solve_tpu(case, claim_slot_div=10_000, device=device)
        if results_snapshot(tight_got, tight_pods) != want_snap:
            violations.append(
                f"parity[tight-slots]: "
                f"tpu={results_snapshot(tight_got, tight_pods)} "
                f"oracle={want_snap}"
            )
    # relax off: PreferencePolicy=Ignore must agree too (the ladder
    # collapses identically on both sides)
    if has_preferences(case):
        want_ni = want_snap_relax_off
        if want_ni is None:
            want_ni = results_snapshot(*solve_oracle(case, ignore_preferences=True))
        try:
            got_ni, pods_tni, _ = solve_tpu(case, ignore_preferences=True, device=device)
        except UnsupportedBySolver:
            return violations
        if results_snapshot(got_ni, pods_tni) != want_ni:
            violations.append(
                f"parity[relax-off]: "
                f"tpu={results_snapshot(got_ni, pods_tni)} "
                f"oracle={want_ni}"
            )
    return violations


def has_preferences(case: FuzzCase) -> bool:
    """Whether any pod of the case carries a preference (check_parity
    then also solves it with PreferencePolicy=Ignore)."""
    _pools, _ibp, pods, *_rest = case.materialize()
    return any(
        (p.node_affinity is not None and p.node_affinity.preferred)
        or p.pod_affinity_preferred
        or p.pod_anti_affinity_preferred
        or any(
            t.when_unsatisfiable == WhenUnsatisfiable.SCHEDULE_ANYWAY
            for t in p.topology_spread_constraints
        )
        for p in pods
    )


def oracle_snapshots(case: FuzzCase) -> tuple:
    """(want_snap, want_snap_relax_off) for check_parity: the oracle's
    snapshots of a kernel-supported case, the second None where the case
    has no preference."""
    want = results_snapshot(*solve_oracle(case))
    if not has_preferences(case):
        return want, None
    return want, results_snapshot(*solve_oracle(case, ignore_preferences=True))


# ---------------------------------------------------------------------------
# mode (b): oracle-independent invariants


def _hard_taints(taints) -> list:
    return [
        t
        for t in taints
        if t.effect in (TaintEffect.NO_SCHEDULE, TaintEffect.NO_EXECUTE)
    ]


def invariant_violations(case: FuzzCase, r: Results, pods) -> list[str]:
    """Checks that must hold for ANY results object, with no oracle in
    the loop (the catalog docs/fuzzing.md documents)."""
    out: list[str] = []
    name = {p.uid: p.name for p in pods}

    # 1. placement accounting: every pod exactly once, or errored
    placed: dict[str, str] = {}
    for c in r.new_node_claims:
        for p in c.pods:
            if p.uid in placed:
                out.append(f"pod {name[p.uid]} placed twice")
            placed[p.uid] = "claim"
    for nd in r.existing_nodes:
        for p in nd.pods:
            if p.uid in placed:
                out.append(f"pod {name[p.uid]} placed twice (existing)")
            placed[p.uid] = "existing"
    for uid in r.pod_errors:
        if uid in placed:
            out.append(f"pod {name.get(uid, uid)} both placed and errored")
    if not r.timed_out:
        for p in pods:
            if p.uid not in placed and p.uid not in r.pod_errors:
                out.append(f"pod {p.name} vanished (neither placed nor errored)")

    # 2. integer milli-units end to end (utils/resources.py contract)
    for c in r.new_node_claims:
        for k, v in c.requests.items():
            if not isinstance(v, int):
                out.append(f"non-integer request {k}={v!r} on a claim")

    # 3. capacity: a claim's accumulated requests (incl. daemon overhead)
    # fit EVERY surviving instance type — that is what the type filter
    # guarantees — and an existing node is never overcommitted beyond its
    # declared availability
    for c in r.new_node_claims:
        if not c.pods:
            continue
        for it in c.instance_type_options:
            if not res.fits(c.requests, it.allocatable()):
                out.append(
                    f"claim {tuple(sorted(name[p.uid] for p in c.pods))} "
                    f"overcommits surviving type {it.name}: "
                    f"{c.requests} vs {it.allocatable()}"
                )
    _pools, _ibp, _pods, views, _daemons, _opts, _src = case.materialize()
    avail_by_name = {v.name: dict(v.available) for v in views or []}
    for nd in r.existing_nodes:
        if not nd.pods:
            continue
        avail = avail_by_name.get(nd.view.name)
        if avail is None:
            continue
        added = res.requests_for_pods(nd.pods)
        added.pop(res.PODS, None)  # views declare pods capacity optionally
        if not res.fits(added, res.merge(avail)):
            out.append(
                f"existing node {nd.view.name} overcommitted: +{added} "
                f"vs available {avail}"
            )

    # 4. taints: every placed pod tolerates its claim's hard taints
    for c in r.new_node_claims:
        hard = _hard_taints(c.template.taints)
        if not hard:
            continue
        for p in c.pods:
            err = Taints(hard).tolerates_pod(p)
            if err is not None:
                out.append(
                    f"pod {name[p.uid]} on tainted pool "
                    f"{c.template.nodepool_name}: {err}"
                )

    # 5. host ports: never double-booked within one claim
    for c in r.new_node_claims:
        usage = HostPortUsage()
        for p in c.pods:
            ports = get_host_ports(p)
            conflict = usage.conflicts(p, ports)
            if conflict is not None:
                out.append(
                    f"host-port clash inside one claim "
                    f"({name[p.uid]}): {conflict}"
                )
            usage.add(p, ports)

    # 6. relax-ladder completeness: a pod whose only constraints are
    # preferences must never fail while an untainted, unlimited template
    # can fit it alone (scheduler.go:434 relaxes ALL the way per attempt)
    pools, _ibp2, _p2, _v2, _d2, opts, _s2 = case.materialize()
    open_pools = [
        np_
        for np_ in pools
        if not _hard_taints(np_.template.taints)
        and not np_.limits
        # a strict minValues floor can legally error an otherwise
        # unconstrained pod once packing drops the type diversity below
        # the floor — such a pool is not "open"
        and not any(
            r_.min_values is not None for r_ in np_.template.requirements
        )
    ]
    if open_pools and not r.timed_out:
        biggest = {}
        for it in _ibp2.get(open_pools[0].name, []):
            biggest = res.max_resources(biggest, it.allocatable())
        by_uid = {p.uid: p for p in pods}
        for uid in r.pod_errors:
            p = by_uid.get(uid)
            if p is None:
                continue
            unconstrained = (
                not p.node_selector
                and (
                    p.node_affinity is None
                    or not p.node_affinity.required_terms
                )
                and not p.pod_affinity
                and not p.pod_anti_affinity
                and not p.host_ports
                and not p.volume_claims
                and not any(
                    t.when_unsatisfiable == WhenUnsatisfiable.DO_NOT_SCHEDULE
                    for t in p.topology_spread_constraints
                )
            )
            if unconstrained and res.fits(
                res.requests_for_pods([p]), biggest
            ):
                out.append(
                    f"preference-only pod {p.name} failed "
                    f"({r.pod_errors[uid]!r}) though an open template "
                    "fits it — the relax ladder did not complete"
                )
    return out


def odometer_violations(h) -> list[str]:
    """Invariant #7 (kernel odometers): a kernel-path solve must
    leave a present, self-consistent device-truth counter block. The
    inertness half of the contract is implicit and stronger: the
    odometers are CARRIED on every dispatch the parity/invariant checks
    above judge, so a counter that perturbed any decision (claims,
    placements, errors) would fail those — this catches the counters
    themselves going missing or inconsistent."""
    tpu = getattr(h, "tpu", None)
    if not getattr(h, "used_tpu", False) or tpu is None:
        return []
    odo = getattr(tpu, "last_odometer", None)
    if odo is None:
        return ["tpu-path solve left no kernel odometer"]
    out: list[str] = []
    if odo.get("dispatches", 0) < 1 or odo.get("steps", 0) < 1:
        out.append(f"odometer empty after a tpu-path solve: {odo}")
    if sum(odo.get("tier_hist", [])) != odo.get("tier_steps", 0):
        out.append(f"odometer tier histogram != tier_steps total: {odo}")
    if "claims_opened" in odo:
        if not (0 <= odo["claims_opened"] <= odo.get("claim_slots", 0)):
            out.append(f"odometer claim accounting out of range: {odo}")
        if not (0.0 <= odo.get("claim_occupancy", 0.0) <= 1.0):
            out.append(f"odometer claim occupancy out of [0,1]: {odo}")
    if odo.get("bulk_steps", 0) > odo.get("steps", 0):
        out.append(f"odometer bulk_steps exceeds steps: {odo}")
    return out


def check_invariants(case: FuzzCase, device=None) -> list[str]:
    """Invariant mode: solve through the production TorchHybridScheduler
    and run the catalog on whatever came back."""
    r, pods, h = solve_hybrid(case, device=device)
    return invariant_violations(case, r, pods) + odometer_violations(h)


# ---------------------------------------------------------------------------
# mode (c): chaos through a live sidecar


def _decoded_parts(got: dict, pods) -> tuple:
    name = {p.uid: p.name for p in pods}
    claims = sorted(
        tuple(sorted(name[u] for u in cl["pod_uids"]))
        for cl in got["new_node_claims"]
        if cl["pod_uids"]
    )
    existing = sorted(
        (node, tuple(sorted(name[u] for u in uids)))
        for node, uids in _group_existing(got).items()
    )
    errors = tuple(sorted(name.get(u, u) for u in got["pod_errors"]))
    return claims, existing, errors, bool(got["timed_out"])


def _group_existing(got: dict) -> dict:
    by_node: dict[str, list] = {}
    for uid, node in got["existing_assignments"].items():
        by_node.setdefault(node, []).append(uid)
    return by_node


def _referee_parts(case: FuzzCase) -> tuple:
    """The in-process oracle referee in the wire's own comparison shape
    (chaos asserts the sidecar never diverges from it)."""
    pools, ibp, pods, views, daemons, options, source = case.materialize()
    topo = Topology(
        pools,
        ibp,
        pods,
        cluster=source,
        state_node_views=views,
        ignore_preferences=options.ignore_preferences,
    )
    s = Scheduler(pools, ibp, topo, views, daemons, options)
    r = s.solve(pods)
    name = {p.uid: p.name for p in pods}
    claims = sorted(
        tuple(sorted(name[p.uid] for p in c.pods))
        for c in r.new_node_claims
        if c.pods
    )
    existing = sorted(
        (n.view.name, tuple(sorted(name[p.uid] for p in n.pods)))
        for n in r.existing_nodes
        if n.pods
    )
    errors = tuple(sorted(name[u] for u in r.pod_errors))
    return claims, existing, errors, bool(r.timed_out)


def chaos_violations(case: FuzzCase, scenario: str, tmp_path: str, device=None) -> list[str]:
    """Drive the case through a live SolverServer under `scenario` and
    compare every answer to the in-process oracle referee. Scenarios:

    - "wire":   truncate, corrupt, and delay faults through the shared
                FaultyProxy, with client retries funding recovery;
    - "desync": an epoch-desync storm (the server's store evicted before
                every delta) — one resync hop per solve, identical answers;
    - "kill":   the server dies between solves; its replacement (empty
                epoch store) must answer a full resync identically;
    - "retry":  an admission gate that refuses everything — the
                ResilientSolver must answer from the in-process ladder,
                decision-identically, without tripping the breaker.

    Solves run force_oracle=True (the referee is the oracle; the kernel's
    own parity has its own mode), so chaos isolates the SERVICE layer:
    codec, epochs, admission, transport recovery. The servers and the
    ResilientSolver's in-process floor run on `device`."""
    from karpenter_tpu_torch.solver.service import SolverClient, SolverServer
    from karpenter_tpu_torch.testing.faults import FaultyProxy

    want = _referee_parts(case)
    out: list[str] = []
    sock = os.path.join(tmp_path, f"fz-{case.seed}-{scenario}.sock")
    server = SolverServer(sock, device=device)
    server.start()
    proxy = None
    replacement = None
    try:
        pools, ibp, pods, views, daemons, options, source = case.materialize()

        def solve_once(c):
            got = c.solve(
                pools,
                ibp,
                pods,
                views,
                daemons,
                options,
                True,  # force_oracle: referee-identical by construction
                None,
                timeout=120.0,
                cluster=source,
            )
            return _decoded_parts(got, pods)

        if scenario == "wire":
            proxy_path = os.path.join(tmp_path, f"fz-{case.seed}-px.sock")
            proxy = FaultyProxy(proxy_path, sock)
            for mode, kw in (
                ("truncate", {"truncate_after": 12}),
                ("corrupt", {}),
                ("delay", {"delay": 0.2}),
            ):
                # a FRESH client per round: the proxy fixes its fault
                # mode per-connection at ACCEPT time, so a client kept
                # alive from the previous round's recovery would ride an
                # unfaulted relay and this round's armed fault would
                # never fire
                proxy.set_fault(mode, once=True, **kw)
                c = SolverClient(
                    proxy_path, request_timeout=120.0, max_retries=3
                )
                c.backoff_base = 0.01
                try:
                    try:
                        got = solve_once(c)
                    except Exception:
                        # corrupt poisons the connection (no silent
                        # resync — the resilience contract); the retry
                        # must land
                        got = None
                        try:
                            got = solve_once(c)
                        except Exception as e2:
                            out.append(f"wire[{mode}] never recovered: {e2}")
                            continue
                    if got != want:
                        out.append(f"wire[{mode}] diverged: {got} != {want}")
                finally:
                    c.close()
        elif scenario == "desync":
            c = SolverClient(sock, request_timeout=120.0)
            if solve_once(c) != want:
                out.append("desync[establish] diverged")
            for i in range(3):
                server.epochs.clear()
                if solve_once(c) != want:
                    out.append(f"desync[storm {i}] diverged")
            if c.resyncs != 3:
                out.append(
                    f"desync storm cost {c.resyncs} resyncs (want exactly 3 "
                    "— one hop per solve, never a loop)"
                )
            c.close()
        elif scenario == "kill":
            c = SolverClient(sock, request_timeout=120.0)
            c.backoff_base = 0.01
            if solve_once(c) != want:
                out.append("kill[before] diverged")
            server.stop()
            replacement = SolverServer(sock, device=device)
            replacement.start()
            if solve_once(c) != want:
                out.append("kill[replacement resync] diverged")
            if solve_once(c) != want:
                out.append("kill[post-resync delta] diverged")
            c.close()
        elif scenario == "retry":
            from karpenter_tpu_torch.solver import epochs as epochs_mod
            from karpenter_tpu_torch.solver.hybrid import ResilientSolver

            server.admission = epochs_mod.AdmissionGate(max_inflight=0)
            rs = ResilientSolver(sock, request_timeout_seconds=120.0, device=device)
            r = rs.solve(
                pools, ibp, pods, views, daemons, options,
                cluster=source, force_oracle=True,
            )
            if rs.last_used == "sidecar":
                out.append("retry: admission gate admitted at max_inflight=0")
            if rs.breaker.state != "closed":
                out.append(
                    f"retry: RETRY frame tripped the breaker "
                    f"({rs.breaker.state}) — backpressure is not a fault"
                )
            name = {p.uid: p.name for p in pods}
            claims = sorted(
                tuple(sorted(name[p.uid] for p in c2.pods))
                for c2 in r.new_node_claims
                if c2.pods
            )
            if claims != want[0]:
                out.append(f"retry diverged: {claims} != {want[0]}")
        else:
            raise ValueError(f"unknown chaos scenario {scenario!r}")
    finally:
        if proxy is not None:
            proxy.stop()
        server.stop()
        if replacement is not None:
            replacement.stop()
    return out


# ---------------------------------------------------------------------------
# shrinking


def case_size(case: FuzzCase) -> int:
    """The shrink objective: pods + views + daemons + pools + per-pod
    feature count. Monotonically non-increasing across shrink steps
    (tests/test_fuzz_machinery.py pins it for the reference,
    tests/test_torch_fuzz.py holds the port's shrink to it)."""
    pools, _ibp, pods, views, daemons, _opts, _src = case.materialize()
    n = len(pods) + len(views or []) + len(daemons or []) + len(pools)
    for p in pods:
        n += len(p.topology_spread_constraints)
        n += len(p.pod_affinity) + len(p.pod_anti_affinity)
        n += len(p.pod_affinity_preferred) + len(p.pod_anti_affinity_preferred)
        n += len(p.tolerations) + len(p.host_ports) + len(p.volume_claims)
        n += len(p.node_selector)
        if p.node_affinity is not None:
            n += len(p.node_affinity.required_terms)
            n += len(p.node_affinity.preferred)
    return n


def _rebuild(case: FuzzCase, pools, ibp, pods, views, daemons, options, src):
    return FuzzCase(
        seed=case.seed,
        families=list(case.families),
        problem=encode_case_problem(
            pools, ibp, pods, views, daemons, options, src
        ),
    )


# (label, has(pod), strip(pod)) — strip must be followed by a class-key
# cache drop (solver/ordering.py memoizes _ktpu_* on the pod; a stripped
# copy re-encoding through the stale key would silently keep the feature)
_POD_STRIPS: tuple[tuple[str, Callable, Callable], ...] = (
    (
        "spread",
        lambda p: bool(p.topology_spread_constraints),
        lambda p: p.topology_spread_constraints.clear(),
    ),
    ("affinity", lambda p: bool(p.pod_affinity), lambda p: p.pod_affinity.clear()),
    (
        "anti-affinity",
        lambda p: bool(p.pod_anti_affinity),
        lambda p: p.pod_anti_affinity.clear(),
    ),
    (
        "pref-affinity",
        lambda p: bool(p.pod_affinity_preferred),
        lambda p: p.pod_affinity_preferred.clear(),
    ),
    (
        "pref-anti",
        lambda p: bool(p.pod_anti_affinity_preferred),
        lambda p: p.pod_anti_affinity_preferred.clear(),
    ),
    ("tolerations", lambda p: bool(p.tolerations), lambda p: p.tolerations.clear()),
    ("host-ports", lambda p: bool(p.host_ports), lambda p: p.host_ports.clear()),
    ("volumes", lambda p: bool(p.volume_claims), lambda p: p.volume_claims.clear()),
    ("selector", lambda p: bool(p.node_selector), lambda p: p.node_selector.clear()),
    (
        "node-affinity",
        lambda p: p.node_affinity is not None,
        lambda p: setattr(p, "node_affinity", None),
    ),
)


def _strip(p, strip_fn) -> None:
    from karpenter_tpu_torch.solver.oracle import Preferences

    strip_fn(p)
    Preferences._invalidate_class_caches(p)


def shrink(
    case: FuzzCase,
    failing: Callable[[FuzzCase], bool],
    max_evals: int = 200,
) -> FuzzCase:
    """Greedy structure-dropping shrink: delta-debug chunked pod removal,
    then view/daemon/pool drops, then per-feature strips (all pods at
    once, then pod by pod), repeated to a fixpoint under an evaluation
    budget. `failing` returns True while the original violation still
    reproduces; a predicate ERROR counts as not-reproducing, so the
    shrinker can never wander onto a different bug. The result is always
    <= the input under `case_size` (monotone by construction: only
    accepted, reproducing candidates replace the incumbent)."""
    evals = [0]

    def still_fails(candidate: FuzzCase) -> bool:
        if evals[0] >= max_evals:
            return False
        evals[0] += 1
        try:
            return bool(failing(candidate))
        except Exception:
            return False

    best = case
    improved = True
    while improved and evals[0] < max_evals:
        improved = False
        pools, ibp, pods, views, daemons, options, src = best.materialize()

        # 1. delta-debug the pod list (chunks of n/2, n/4, ... 1)
        chunk = max(1, len(pods) // 2)
        while chunk >= 1 and len(pods) > 1:
            i = 0
            while i < len(pods):
                trial = pods[:i] + pods[i + chunk :]
                cand = _rebuild(
                    best, pools, ibp, trial, views, daemons, options, src
                )
                if still_fails(cand):
                    pods = trial
                    best = cand
                    improved = True
                else:
                    i += chunk
            chunk //= 2

        # 2. drop cluster structure
        for attr in ("views", "daemons"):
            seq = views if attr == "views" else daemons
            if not seq:
                continue
            kept = list(seq)
            i = 0
            while i < len(kept):
                trial = kept[:i] + kept[i + 1 :]
                v2 = trial if attr == "views" else views
                d2 = trial if attr == "daemons" else daemons
                if attr == "views" and not trial:
                    trial = None  # type: ignore[assignment]
                    v2 = None
                cand = _rebuild(best, pools, ibp, pods, v2, d2, options, src)
                if still_fails(cand):
                    kept = list(trial or [])
                    best = cand
                    improved = True
                    if attr == "views":
                        views = v2
                    else:
                        daemons = d2
                else:
                    i += 1
        if len(pools) > 1:
            for drop in list(pools[1:]):
                trial_pools = [np_ for np_ in pools if np_ is not drop]
                trial_ibp = {np_.name: ibp[np_.name] for np_ in trial_pools}
                cand = _rebuild(
                    best, trial_pools, trial_ibp, pods, views, daemons,
                    options, src,
                )
                if still_fails(cand):
                    pools, ibp = trial_pools, trial_ibp
                    best = cand
                    improved = True

        # 3. strip pod features: all pods at once, then one at a time
        import copy as copy_mod

        for _label, has, strip_fn in _POD_STRIPS:
            if not any(has(p) for p in pods):
                continue
            trial = [copy_mod.deepcopy(p) for p in pods]
            for p in trial:
                if has(p):
                    _strip(p, strip_fn)
            cand = _rebuild(
                best, pools, ibp, trial, views, daemons, options, src
            )
            if still_fails(cand):
                pods = trial
                best = cand
                improved = True
            else:
                for i in range(len(pods)):
                    if not has(pods[i]):
                        continue
                    trial = [copy_mod.deepcopy(p) for p in pods]
                    _strip(trial[i], strip_fn)
                    cand = _rebuild(
                        best, pools, ibp, trial, views, daemons, options, src
                    )
                    if still_fails(cand):
                        pods = trial
                        best = cand
                        improved = True
    return best


# ---------------------------------------------------------------------------
# the pinned corpus


CORPUS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests",
    "fuzz_corpus",
)


def save_corpus_case(
    case: FuzzCase, mode: str, violation: str, dirpath: Optional[str] = None
) -> str:
    """Serialize a (shrunk) counterexample into the pinned corpus. The
    filename carries the seed so `repro_command` is readable from `ls`."""
    dirpath = dirpath or CORPUS_DIR
    os.makedirs(dirpath, exist_ok=True)
    # chaos modes are "chaos:<scenario>" — keep filenames portable
    path = os.path.join(
        dirpath, f"seed{case.seed}-{mode.replace(':', '-')}.json"
    )
    with open(path, "w") as f:
        json.dump(
            {
                "schema": 1,
                "seed": case.seed,
                "mode": mode,
                "families": case.families,
                "violation": violation,
                "repro": repro_command(case.seed, mode),
                "problem": case.problem,
            },
            f,
            indent=1,
            sort_keys=True,
        )
        f.write("\n")
    return path


def load_corpus(dirpath: Optional[str] = None) -> list[tuple[str, dict]]:
    dirpath = dirpath or CORPUS_DIR
    if not os.path.isdir(dirpath):
        return []
    out = []
    for fn in sorted(os.listdir(dirpath)):
        if fn.endswith(".json"):
            with open(os.path.join(dirpath, fn)) as f:
                out.append((fn, json.load(f)))
    return out


def corpus_case(entry: dict) -> FuzzCase:
    return FuzzCase(
        seed=int(entry["seed"]),
        families=list(entry.get("families", [])),
        problem=entry["problem"],
    )
