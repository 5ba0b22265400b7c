#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (karpenter_tpu_torch).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the eight CUDA kernels from csrc/ and holds each against its plain
PyTorch version on the card, bit for bit:

- K1 typeok_screen on the headline's class rows, the c6 mix's tier rows,
  the full-size screens world's class rows and a 2048-type catalog's;
- K2 scan_step on three small problems and a 512-pod prefix of the
  headline round (the whole round is timed too), and with the relax tier
  loop on three small tiered problems (one overflows mid-ladder) and the
  first 128 positions of the 1000-pod preference round (the whole round
  is timed);
- K3 run_step on three small problems (one overflows its 64 claim slots)
  and on the headline's two dispatches (up to the claim-slot overflow,
  then the rest after the state grows), and with the relax tier loop on
  two small tiered problems and the c6 mix's two dispatches;
- K4 run_arrays on both rounds of the headline and of the c6 mix, and on
  seeded rounds of P in {1, 31, 32, 33, 1024, 1025, 16384, 65536}
  positions (n = 0, a middle n, n = P, one run over every position);
- K5 dedup_rows, as the decode calls it (`dedup_decode_state`, the claim
  columns read in place), on the headline's and the c6 mix's final claim
  state, on 16384 synthetic rows with many duplicates and on seeded
  column sets of n in {1, 2, 63, 8192, 8193, 2^17} rows at the
  headline's widths and 2^20 rows of 8 words, all rows equal and all
  distinct (`k5_edge_checks`);
- K6 fast_sweep (prefix and singleton lanes) and K8 set_sweep (1024
  removal sets), verdicts and per-lane leftovers, also with every table
  and lane in device memory, on a 2000-node under-utilized fleet (the
  reference's c4 shape: 100 candidates, 20 pending pods of a second
  class), where every lane places all its pods on existing nodes, on a
  2000-node leftover fleet, where every lane leaves pods for one new
  claim that some lanes' leftovers fit and others' do not, and on a
  2000-node c0 fleet, where a lane's first leftover class is a class no
  template fits or the riders' one, by lane; K7 scan_lanes (prefix and
  singleton lanes) on 64 candidates of a 2000-node fleet whose riders
  carry a zone spread;
- K7 scan_lanes as the fleet launch (each lane's pod rows its own) on the
  first 32 positions of 8 fleet lanes of 2000 pods, relax off and on;
- K3 and K2 at full size on the screens the headline bypasses (2000 pods
  beside 300 existing nodes: host ports, a pool limit, reservations,
  minValues; and existing-node windows) and on a 2048-type catalog whose
  type tables spill from shared to device memory.

It prints the device time (profiler) and the wrapper's host time a call
of K1, K4 and K5 beside an empty kernel's (the launch floor), K5's as
the whole decode call with the kernels it launches (one, up to 8192
rows) and its per-phase clock breakdown, and the
per-phase clock breakdown of K3 (the headline's and c6's two
dispatches), K2 (a 1024-pod headline prefix) and K7 at one lane beside K2
on the same fleet lane, each profiled launch held bit for bit to the same
launch without it, where each launch table lived (shared or device
memory), and the sweep kernels' cache and lane launches apart.

Then it drives the provisioning solve end to end, each path with the launch
counts set to 0 just before and read just after: the headline
(make_diverse_pods(10000) against 500 KWOK instance types on one default
NodePool) through the runs path; the scan path (`debug_force_scan`) at 1000
pods, whose decisions must equal the runs path's; the c6 realistic mix
(bench.py `pods_realistic(10000)`: 98% diverse, a 2% tail of preference
pods) through the runs path with the tier loop, whose odometer must equal
the JAX package's; and the 1000-pod preference round through the scan path
with the tier loop; then the provisioning entry point: Provisioner.reconcile()
on a SimKube cluster whose pending pods are the c6 mix plus 100 pods with a
PVC each of a zonal StorageClass (the supported pods on K1, K3, K4 and K5, the
100 continued on the oracle, each on a claim in the StorageClass's zone; no
`tpu_error`; the median of 3 reconciles in pods/s with its host phases), the
same cluster at 2000 + 40 pods against the oracle's decisions for the same
partition, and solve_in_process on requests-only batches of 16 to 4096 pods
on the card and on the oracle, whose medians give the small-batch crossover;
then the consolidation sweeps: prefix_feasibility and
singleton_feasibility on the three fleets (the fast path and the full-state
lane path) and SetSweepContext.evaluate, their verdicts held against the port's
sequential referee (helpers.simulate_scheduling on the oracle); then fleet
lanes: windows of 2, 5 and 8 concurrent scan-path solves of 2000 self-spread
pods each, a window of 4 lanes with preference ladders and a window of 4
lanes whose follower pods requeue into a second round, through
TorchScheduler(fleet=FleetCoalescer), every lane coalesced (one K7 launch
per round) and equal to its solo solve through K2, and an overflowing lane
that leaves its window; then the solver sidecar (`sidecar_phase`): the
port's SolverServer on the card behind a unix socket, with a
DeviceTableCache, an EpochStore and an AdmissionGate, at the headline's
width — a full snapshot with an epoch key equal to the in-process solve
(K1, K4, K3, K5), a same-epoch delta served from the table cache (no
upload bytes, no K1 launch), a delta that churns existing nodes equal to a
full snapshot, 4 scan-path lanes over the wire through a fleet window (one
K7 launch a round), a Provisioner(solver=ResilientSolver) reconcile of the
entry cluster answered by the sidecar with the entry phase's claims, and,
with the server stopped, a reconcile that degrades in-process to the card;
the server-side phases beside the in-process solve's give the wire's
cost; last, a solve with every free byte of the card held
must raise out of TorchHybridScheduler.solve, not be re-solved on the
oracle by the last-resort guard. Then process start and the Operator (phase
14): two fresh processes' first headline solve, one after `aot.prewarm()`
and one without (neither may run nvcc; equal decisions), the sidecar's
prewarm with a solve sent mid-prewarm (served by the oracle, equal to the
in-process solve); `Operator.run_until_settled()` on the entry cluster
(every pod bound by the lifecycle controller's nodes, the kernel route),
its probe endpoints, a headline solve under `profiling.device_trace`; and a
2040-pod cluster provisioned, half emptied and consolidated by the card's
Operator (a Command executed through the OrchestrationQueue and
NodeTermination) against the oracle's Operator in a process of its own
(equal claims, first Command and final nodes). It checks decisions against
the port's oracle on twelve problems, and prints:

- the card's name and power limit (nvidia-smi),
- one JSON line {"kernels": [...]} with each kernel's launches on its path
  (and on the consolidation, sidecar, Operator and prewarm paths), its
  agreement with the plain version, and its times,
- as the last line, {"ok": true, "device": {...}}.

Any failed phase exits non-zero without the last line. Without a CUDA
device, or outside the repository, it exits non-zero at once.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple, Optional

HEADLINE_PODS = 10000
HEADLINE_TYPES = 500
PARITY_PODS = 1000
K2_PREFIX = 512  # headline pods K2 is held against its plain version on
C6_PODS = 10000
C6_PARITY_PODS = 2000  # c6 pods solved by the oracle too
PREF_PODS = 1000  # the preference round (every pod tiered)
# positions of the preference round K2+relax is held to its plain version on
# (the plain tier loop takes about 50 ms a position)
PREF_CHECK_POSITIONS = 128
# The JAX package's kernel odometer for the c6 solve (bench.py
# build_universe(500) + make_problem(10000, its, pods_realistic), the same
# construction as c6_world): recorded with `JAX_PLATFORMS=cpu python3
# tools/reference_odometer.py` on a CPU. Structure counts, not speeds.
C6_JAX_ODOMETER = {
    "steps": 1709, "bulk_steps": 1019, "tier_steps": 1290, "tier_hist": [690, 200, 200, 200, 0, 0, 0, 0],
    "dispatches": 2, "overflow_signals": 1, "regrows": 1, "claims_opened": 1962, "claim_slots": 2048,
}
# the consolidation sweeps (the reference's c4 bench shape, sweep.py:763
# bench_sweep and setsweep.py:557 bench_set_sweep): an under-utilized
# fleet, its top candidates by (disruption cost, name), pending pods of a
# second class so the class loop runs C >= 2 classes
SWEEP_NODES = 2000
SWEEP_CANDIDATES = 100
SWEEP_PENDING = 20
SET_LANES = 1024
# the full-state lane path: riders with a zone spread fail the fast gates;
# 64 lanes x 64 union pods is the reference's 4096 limit
LANE_CANDIDATES = 64
RIDER_SPREAD = 4
# positions of the spread fleet's 64 at which K7 is held to its plain
# version (the plain version takes about half a second a position)
LANE_CHECK_POSITIONS = 16
REFEREE_SEEDED = 16  # seeded lanes of each kind held against the referee
PAST_EDGE = 4  # spread-fleet prefix lanes held past the last verdict change
# a spread fleet small enough that the referee holds every prefix lane of
# LANE_CANDIDATES (each lane's referee call grows with the fleet)
SPREAD_CHECK_NODES = 200
# the leftover fleet: riders as large as the seeds fill every node, so each
# lane's riders and the pending pods (which fit no node) are left over for
# one new claim: the largest KWOK type hosts them up to prefix lane 21
LEFTOVER_RIDER = {"cpu": "700m", "memory": "512Mi"}
LEFTOVER_PENDING = {"cpu": "12", "memory": "1Gi"}
LEFTOVER_TAG = ", leftover fleet"
# the c0 fleet: the leftover fleet's riders, and on every third node a
# bound pod asking more cpu than any type in place of its rider, so a
# lane's first leftover class is the heavy one where it removes a heavy
# node and the riders' where it does not (and only the riders' fits a
# template)
C0_EVERY = 3
C0_HEAVY = {"cpu": "1000", "memory": "1Gi"}
C0_TAG = ", c0 fleet"
C0_REFEREE_SEEDED = 4
# fleet lanes: concurrent scan-path solves of one cluster (the headline's
# types and pool), lane k with make_self_spread_pods(FLEET_PODS, "<k+1>00m")
FLEET_PODS = 2000
FLEET_WINDOWS = (2, 5, 8)  # lanes per window, relax off
FLEET_RELAX_LANES = 4  # a window whose lanes add the same preference pods
FLEET_PREF_PODS = 200
FLEET_PREF_SEED = 7
# FFD positions of each lane K7 is held to its plain version on (the plain
# version with relax on takes about half a second a position)
FLEET_CHECK_POSITIONS = 32
FLEET_CHECK_LANES = 8
FLEET_WIDE_POSITIONS = 64  # positions of the launch past K7's lane table
FLEET_ORACLE_LANES = (0, 7)  # lanes of the widest window held against the oracle
FLEET_OVERFLOW = (80, ("100m", "200m", "4100m"))  # pods per lane; the last lane needs a node per pod
FLEET_WINDOW_SECONDS = 10.0
# a window whose lanes requeue: each lane adds follower pods that fail in
# round 1 and land in round 2 (fixtures.make_follower_pods)
FLEET_FOLLOW = (4, 20)  # lanes, follower pods a lane
# the full-size problems (full_world): a pending backlog beside a few
# hundred existing nodes on the headline's 500 types
FULL_PODS = 2000
FULL_NODES = 300
# positions of the screens world's round K2 is held to its plain version on
# (of its 2048; the plain version takes about 9 ms a position)
FULL_K2_CHECK_POSITIONS = 512
# a catalog too large for the type tables' shared memory (the kernels then
# read the mask words and offerings from device memory)
LARGE_CATALOG_TYPES = 2048
LARGE_CATALOG_PODS = 512
FLEET_JOIN_SECONDS = 300.0
# the provisioning entry point (entry_point_phase): a SimKube cluster whose
# pending pods are the c6 mix plus a StatefulSet-style tail, pods with the
# mix's requests and a PVC each of a zonal StorageClass (the oracle's part)
ENTRY_PVC_PODS = 100
ENTRY_ZONE = "test-zone-b"
DECISIONS_PODS = (2000, 40)  # c6 pods, PVC pods: the card's Provisioner against the oracle
ENTRY_TIMED = 1  # timed entry-point reconciles after the warm-up (each on a fresh 10100-pod cluster)
CROSSOVER_SIZES = (16, 64, 256, 1024, 4096)  # make_generic_pods(n) through solve_in_process
# the oracle's timed solves where the card wins by more than 5x (3 elsewhere)
CROSSOVER_ORACLE_REPS = {1024: 1, 4096: 1}
# the consolidation controllers (consolidation_phase) run on the sweep
# phase's c4 fleet; each kernels-line row gains its launches on that path.
# SingleNodeConsolidation sweeps its candidates as singleton lanes only up
# to sweep.MAX_SWEEP_PREFIXES (128, the reference's rule): on the c4
# fleet's 2000 candidates it walks them one by one, so its singleton
# launch is checked on a fleet of the c4 shape with 128 nodes
SINGLE_NODES = 128
CONSOLIDATION_ROWS = {
    "typeok_screen": ("typeok_screen",), "scan_step": ("scan_step",), "run_step": ("run_step",),
    "run_arrays": ("run_arrays",), "dedup_rows": ("dedup_rows",), "scan_step+relax": ("scan_step_relax",),
    "run_step+relax": ("run_step_relax",), "fast_sweep": ("fast_sweep",),
    "fast_sweep (singleton)": ("fast_sweep_singleton",), "set_sweep": ("set_sweep",),
    "scan_lanes": ("scan_lanes", "scan_lanes_relax"),
}
# the sidecar (sidecar_phase): the port's SolverServer on the card, reached
# over its unix socket by the port's SolverClient, a ResilientSolver and a
# fleet window; each kernels-line row gains its launches on that path
SIDECAR_NODES = 20  # existing nodes of the churn epoch (check c)
SIDECAR_CHURN = (3, 2, 2)  # nodes added, removed and relabelled by its delta
SIDECAR_LANES = 4  # concurrent scan-path lanes over the wire (check d)
SIDECAR_TIMEOUT = 600.0  # the clients' wire deadline
SIDECAR_ROWS = {
    "typeok_screen": ("typeok_screen",), "run_step": ("run_step",), "run_arrays": ("run_arrays",),
    "dedup_rows": ("dedup_rows",), "fleet_lanes": ("fleet_lanes", "fleet_lanes_relax"),
}
# the device functions of K6 and K8, as the profiler names them
SWEEP_KERNELS = ("sweep_cache_kernel", "fast_sweep_lanes", "set_sweep_lanes")
# K5's edge checks (k5_edge_checks): (label, rows, widths of the nine
# claim columns in the dedup layout, which rows); the headline's widths
# are TW=36, K=16, IW=16 (C=184)
K5_HEADLINE_WIDTHS = (36, 36, 16, 16, 16, 16, 16, 16, 16)
K5_EDGES = (
    ("n=1", 1, K5_HEADLINE_WIDTHS, "pool"),
    ("n=2", 2, K5_HEADLINE_WIDTHS, "pool"),
    ("n=63", 63, K5_HEADLINE_WIDTHS, "pool"),
    ("n=1000, 40 distinct rows", 1000, K5_HEADLINE_WIDTHS, "few"),
    ("n=2048, 40 distinct rows", 2048, K5_HEADLINE_WIDTHS, "few"),
    ("n=2048, C=376", 2048, (108, 108, 16, 16, 16, 16, 16, 16, 64), "pool"),
    ("n=8192", 8192, K5_HEADLINE_WIDTHS, "pool"),
    ("n=8193", 8193, K5_HEADLINE_WIDTHS, "pool"),
    ("n=2^17", 1 << 17, K5_HEADLINE_WIDTHS, "pool"),
    ("n=2^20, C=8", 1 << 20, (2, 0, 1, 1, 0, 2, 0, 0, 2), "pool"),
    ("all equal, n=2048", 2048, K5_HEADLINE_WIDTHS, "equal"),
    ("all distinct, n=2048", 2048, K5_HEADLINE_WIDTHS, "distinct"),
    ("all equal, n=8193", 8193, K5_HEADLINE_WIDTHS, "equal"),
    ("all distinct, n=8192", 8192, K5_HEADLINE_WIDTHS, "distinct"),
)
K5_BOOL = (False, False, True, True, True, False, False, False, False)  # other, notin, defined
# phase 14 (cold_start_phase, operator_phase): fresh processes' first
# headline solve with and without the prewarm; the port's Operator on the
# entry cluster (C6_PODS + ENTRY_PVC_PODS) through provisioning and a
# consolidation round, and at DECISIONS_PODS against the oracle's Operator
COLD_START_TIMEOUT = 300.0
PREWARM_DEGRADED_PODS = 1024  # the solve sent to the sidecar mid-prewarm
OPERATOR_TICKS = 24  # the tick budget of each half of the Operator's run
# (c)'s oracle side runs in a process of its own from the end of the build
# (about 320 s of host on the card's machine: each provisioning round
# re-solves every pending pod against the in-flight nodes on the oracle);
# the seconds (c) then waits for it at most
OPERATOR_ORACLE_TIMEOUT = 600.0
OPERATOR_CLAIM_SEQ0 = 50000  # (c)'s claims are named from here on both sides
OPERATOR_FLEET_NODES = 200  # the under-utilized fleet whose consolidation runs the sweeps
OPERATOR_STILL_TICKS = 10  # ticks the node set holds still to end the run
# the main path's kernels as the profiler names them (the device trace check)
TRACE_KERNELS = ("typeok_kernel", "run_arrays_kernel", "run_step_kernel", "dedup_cluster_kernel")
# each kernels-line row's launch counters (launches_operator, launches_prewarm)
ROW_COUNTERS = {
    "typeok_screen": ("typeok_screen",), "scan_step": ("scan_step",), "run_step": ("run_step",),
    "run_arrays": ("run_arrays",), "dedup_rows": ("dedup_rows",), "scan_step+relax": ("scan_step_relax",),
    "run_step+relax": ("run_step_relax",), "relax_step": ("run_step_relax", "scan_step_relax"),
    "fast_sweep": ("fast_sweep",), "fast_sweep (singleton)": ("fast_sweep_singleton",), "set_sweep": ("set_sweep",),
    "scan_lanes": ("scan_lanes", "scan_lanes_relax"), "fleet_lanes": ("fleet_lanes", "fleet_lanes_relax"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
CORE_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (fp32 figure)


_T0 = time.monotonic()


def log(msg: str) -> None:
    """A line of the run's log, after the seconds since the script started."""
    print(f"[{time.monotonic() - _T0:7.1f}s] {msg}", flush=True)


def build_universe(n_types: int):
    """The headline's instance types: KWOK families x sizes, cut to n."""
    from karpenter_tpu_torch.cloudprovider.kwok import KWOK_FAMILIES, construct_instance_types

    per_size = len(KWOK_FAMILIES) * 2 * 2
    n_sizes = max(1, (n_types + per_size - 1) // per_size)
    sizes = sorted({1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256} | set(range(3, 3 + n_sizes * 3, 3)))[:n_sizes]
    its = construct_instance_types(sizes=sizes)
    return its[:n_types] if len(its) > n_types else its


class World(NamedTuple):
    """One problem as a caller hands it to the scheduler."""

    pools: list
    ibp: dict
    pods: list
    views: Optional[list]
    options: object
    topo: object


def headline_world(n_pods: int, its) -> World:
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.testing import fixtures

    fixtures.reset_rng(42)
    pools = [fixtures.node_pool(name="default")]
    pods = fixtures.make_diverse_pods(n_pods)
    ibp = {p.name: its for p in pools}
    return World(pools, ibp, pods, None, None, Topology(pools, ibp, pods))


def c6_pods(n_pods: int) -> list:
    """bench.py's c6 realistic mix: the headline's diverse mix for 98% of
    the pods, then a tail of preference pods (each climbs a 4-tier
    ladder)."""
    from karpenter_tpu_torch.testing import fixtures

    fixtures.reset_rng(42)
    pods = fixtures.make_diverse_pods(int(n_pods * 0.98))
    return pods + fixtures.make_preference_pods(n_pods - len(pods))


def c6_world(n_pods: int, its) -> World:
    """The c6 realistic mix against the headline's instance types."""
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.testing import fixtures

    pods = c6_pods(n_pods)
    pools = [fixtures.node_pool(name="default")]
    ibp = {p.name: its for p in pools}
    return World(pools, ibp, pods, None, None, Topology(pools, ibp, pods))


def preference_world(n_pods: int, its) -> World:
    """Preference pods only: every pod is tiered (the scan path). On small
    types (2 and 8 cpus) they need many claims, so two claim slots
    overflow mid-ladder."""
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.testing import fixtures

    fixtures.reset_rng(42)
    pools = [fixtures.node_pool(name="default")]
    pods = fixtures.make_preference_pods(n_pods)
    ibp = {p.name: its for p in pools}
    return World(pools, ibp, pods, None, None, Topology(pools, ibp, pods))


def min_values_world() -> World:
    """A tier that fails after its claim screen and verify loop ran: the
    pool wants 3 instance types per claim and tier 0 of each "narrow" pod
    prefers exactly two, so it passes a claim's screens, fails the exact
    verify and every template on minValues; tier 1 joins the claim."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.objects import NodeAffinity, NodeSelectorRequirement, NodeSelectorTerm, Operator
    from karpenter_tpu_torch.api.objects import PreferredSchedulingTerm
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.testing import fixtures

    fixtures.reset_rng(21)
    its = _small_types()
    pools = [
        fixtures.node_pool(
            name="default",
            requirements=[NodeSelectorRequirement(wk.INSTANCE_TYPE_LABEL_KEY, Operator.EXISTS, min_values=3)],
        )
    ]
    pods = [fixtures.pod(name=f"base-{i}", requests={"cpu": "300m"}) for i in range(4)]
    two = [its[0].name, its[4].name]
    for i in range(6):
        p = fixtures.pod(name=f"narrow-{i}", requests={"cpu": "100m"})
        term = NodeSelectorTerm(match_expressions=[NodeSelectorRequirement(wk.INSTANCE_TYPE_LABEL_KEY, Operator.IN, two)])
        p.node_affinity = NodeAffinity(preferred=[PreferredSchedulingTerm(weight=5, preference=term)])
        pods.append(p)
    ibp = {p.name: its for p in pools}
    return World(pools, ibp, pods, None, None, Topology(pools, ibp, pods))


def lonely_world() -> World:
    """80 pods that each need a claim of their own (required hostname
    anti-affinity) and fail their tier 0 (an unsatisfiable zone
    preference), beside a bulkable class: with 64 claim slots the runs path
    stops on a tiered pod that overflowed at tier 1."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.objects import (
        LabelSelector, NodeAffinity, NodeSelectorRequirement, NodeSelectorTerm, Operator, PodAffinityTerm,
        PreferredSchedulingTerm,
    )
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.testing import fixtures

    fixtures.reset_rng(8)
    pods = []
    for i in range(80):
        anti = PodAffinityTerm(topology_key=wk.HOSTNAME_LABEL_KEY, label_selector=LabelSelector(match_labels={"app": "lonely"}))
        p = fixtures.pod(name=f"lonely-{i}", labels={"app": "lonely"}, requests={"cpu": "1"}, pod_anti_requirements=[anti])
        term = NodeSelectorTerm(
            match_expressions=[NodeSelectorRequirement(wk.TOPOLOGY_ZONE_LABEL_KEY, Operator.IN, ["no-such-zone"])]
        )
        p.node_affinity = NodeAffinity(preferred=[PreferredSchedulingTerm(weight=1, preference=term)])
        pods.append(p)
    pods += [fixtures.pod(name=f"small-{i}", requests={"cpu": "100m"}) for i in range(40)]
    pools = [fixtures.node_pool(name="default")]
    ibp = {p.name: _small_types() for p in pools}
    return World(pools, ibp, pods, None, None, Topology(pools, ibp, pods))


def mixed_world(n_pref: int = 0) -> World:
    """Existing nodes (one holding a host port), a tainted pool, a pool
    with a cpu limit, tolerating pods and host-port pods (and `n_pref`
    preference pods after them)."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.objects import Taint, TaintEffect, Toleration
    from karpenter_tpu_torch.cloudprovider.kwok import KWOK_ZONES, construct_instance_types
    from karpenter_tpu_torch.solver.nodes import StateNodeView
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.testing import fixtures

    fixtures.reset_rng(7)
    its = construct_instance_types(sizes=[2, 8, 32])
    taint = Taint("smoke.io/team", TaintEffect.NO_SCHEDULE, "a")
    pools = [
        fixtures.node_pool(name="default", limits={"cpu": "40"}),
        fixtures.node_pool(name="dedicated", weight=10, taints=[taint]),
    ]
    ibp = {p.name: its for p in pools}
    zones = KWOK_ZONES
    views = []
    for vi in range(3):
        it = its[(vi * 7) % len(its)]
        name = f"smoke-node-{vi}"
        labels = {
            wk.TOPOLOGY_ZONE_LABEL_KEY: zones[vi % len(zones)],
            wk.HOSTNAME_LABEL_KEY: name,
            wk.INSTANCE_TYPE_LABEL_KEY: it.name,
            wk.CAPACITY_TYPE_LABEL_KEY: "on-demand",
            wk.OS_LABEL_KEY: "linux",
            wk.ARCH_LABEL_KEY: "amd64",
            wk.NODEPOOL_LABEL_KEY: "default",
        }
        v = StateNodeView(
            name=name,
            node_labels={wk.TOPOLOGY_ZONE_LABEL_KEY: labels[wk.TOPOLOGY_ZONE_LABEL_KEY]},
            labels=labels,
            available={k: q // 2 for k, q in it.allocatable().items()},
            capacity=dict(it.capacity),
            initialized=True,
        )
        if vi == 0:
            squatter = fixtures.pod(name="smoke-squat")
            v.host_port_usage.add(squatter, [("0.0.0.0", "TCP", 443)])
        views.append(v)
    pods = fixtures.make_diverse_pods(40)
    for i in range(16):
        tol = [Toleration(key="smoke.io/team", operator="Exists")] if i % 2 else None
        p = fixtures.pod(name=f"smoke-port-{i}", requests={"cpu": "900m", "memory": "512Mi"}, tolerations=tol)
        p.host_ports = [("0.0.0.0", "TCP", 443 if i % 3 == 0 else 8080)]
        pods.append(p)
    pods += fixtures.make_preference_pods(n_pref)
    return World(pools, ibp, pods, views, None, Topology(pools, ibp, pods, state_node_views=views))


def reserved_world() -> World:
    """Reserved capacity on (four reserved offerings of capacity 2) and a
    pool whose instance-type requirement carries minValues=3."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.objects import NodeSelectorRequirement, Operator
    from karpenter_tpu_torch.cloudprovider.kwok import KWOK_ZONES, construct_instance_types
    from karpenter_tpu_torch.cloudprovider.types import Offering
    from karpenter_tpu_torch.scheduling import Requirement, Requirements
    from karpenter_tpu_torch.solver.oracle import SchedulerOptions
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.testing import fixtures

    fixtures.reset_rng(9)
    its = construct_instance_types(sizes=[2, 8, 32])
    for j, it in enumerate(its[:4]):
        it.offerings.append(
            Offering(
                requirements=Requirements(
                    [
                        Requirement(wk.TOPOLOGY_ZONE_LABEL_KEY, Operator.IN, [KWOK_ZONES[j % 2]]),
                        Requirement(wk.CAPACITY_TYPE_LABEL_KEY, Operator.IN, ["reserved"]),
                        Requirement(wk.RESERVATION_ID_LABEL_KEY, Operator.IN, [f"res-{j}"]),
                    ]
                ),
                price=0.001,
                available=True,
                reservation_capacity=2,
            )
        )
    pools = [
        fixtures.node_pool(
            name="default",
            requirements=[NodeSelectorRequirement(wk.INSTANCE_TYPE_LABEL_KEY, Operator.EXISTS, min_values=3)],
        )
    ]
    options = SchedulerOptions(reserved_capacity_enabled=True)
    pods = fixtures.make_diverse_pods(48)
    ibp = {p.name: its for p in pools}
    return World(pools, ibp, pods, None, options, Topology(pools, ibp, pods))


def mixed_bulk_world(n_pref: int = 0) -> World:
    """Existing nodes (one holding a host port) and a tainted pool beside
    the headline mix, with no pool limit: the runs path with its
    existing-node windows, and host-port pods (and `n_pref` preference
    pods) on the exact step."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.objects import Taint, TaintEffect, Toleration
    from karpenter_tpu_torch.cloudprovider.kwok import KWOK_ZONES, construct_instance_types
    from karpenter_tpu_torch.solver.nodes import StateNodeView
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.testing import fixtures

    fixtures.reset_rng(13)
    its = construct_instance_types(sizes=[2, 8, 32])
    taint = Taint("smoke.io/team", TaintEffect.NO_SCHEDULE, "a")
    pools = [fixtures.node_pool(name="default"), fixtures.node_pool(name="dedicated", weight=10, taints=[taint])]
    ibp = {p.name: its for p in pools}
    views = []
    for vi in range(4):
        it = its[(vi * 5 + 3) % len(its)]
        name = f"smoke-bulk-node-{vi}"
        labels = {
            wk.TOPOLOGY_ZONE_LABEL_KEY: KWOK_ZONES[vi % len(KWOK_ZONES)],
            wk.HOSTNAME_LABEL_KEY: name,
            wk.INSTANCE_TYPE_LABEL_KEY: it.name,
            wk.CAPACITY_TYPE_LABEL_KEY: "on-demand",
            wk.OS_LABEL_KEY: "linux",
            wk.ARCH_LABEL_KEY: "amd64",
            wk.NODEPOOL_LABEL_KEY: "default",
        }
        v = StateNodeView(
            name=name,
            node_labels={wk.TOPOLOGY_ZONE_LABEL_KEY: labels[wk.TOPOLOGY_ZONE_LABEL_KEY]},
            labels=labels,
            available=dict(it.allocatable()),
            capacity=dict(it.capacity),
            initialized=True,
        )
        if vi == 0:
            v.host_port_usage.add(fixtures.pod(name="smoke-bulk-squat"), [("0.0.0.0", "TCP", 443)])
        views.append(v)
    pods = fixtures.make_diverse_pods(120)
    for i in range(8):
        tol = [Toleration(key="smoke.io/team", operator="Exists")] if i % 2 else None
        p = fixtures.pod(name=f"smoke-bulk-port-{i}", requests={"cpu": "500m", "memory": "256Mi"}, tolerations=tol)
        p.host_ports = [("0.0.0.0", "TCP", 443 if i % 3 == 0 else 8080)]
        pods.append(p)
    pods += fixtures.make_preference_pods(n_pref)
    return World(pools, ibp, pods, views, None, Topology(pools, ibp, pods, state_node_views=views))


def full_world(screens: bool, n_pods: int = FULL_PODS, n_nodes: int = FULL_NODES) -> World:
    """The screens the headline bypasses, at a realistic size (built like
    mixed_bulk_world, reserved_world and min_values_world): `n_nodes`
    existing nodes of the headline's types at half their capacity (one
    holding host port 443), a default pool beside a tainted pool, and the
    diverse mix with host-port pods (half of them tolerating the taint),
    preference pods and pods that prefer two instance types. With
    `screens`, four types carry reserved offerings (capacity 2) and the
    default pool minValues=3 on the instance type (the narrow pods' first
    tier then fails minValues) and a cpu limit of 18000 cores, of which
    its existing nodes hold 13937: about 40 claims open before it binds.
    Those fail the bulk gates, so the solve takes the scan path. Without,
    it takes the runs path with existing-node windows."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.objects import (
        NodeAffinity, NodeSelectorRequirement, NodeSelectorTerm, Operator, PreferredSchedulingTerm, Taint,
        TaintEffect, Toleration,
    )
    from karpenter_tpu_torch.cloudprovider.kwok import KWOK_ZONES
    from karpenter_tpu_torch.cloudprovider.types import Offering
    from karpenter_tpu_torch.scheduling import Requirement, Requirements
    from karpenter_tpu_torch.solver.nodes import StateNodeView
    from karpenter_tpu_torch.solver.oracle import SchedulerOptions
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.testing import fixtures

    fixtures.reset_rng(17)
    its = build_universe(HEADLINE_TYPES)
    for j, it in enumerate(its[:4] if screens else []):
        it.offerings.append(
            Offering(
                requirements=Requirements(
                    [
                        Requirement(wk.TOPOLOGY_ZONE_LABEL_KEY, Operator.IN, [KWOK_ZONES[j % 2]]),
                        Requirement(wk.CAPACITY_TYPE_LABEL_KEY, Operator.IN, ["reserved"]),
                        Requirement(wk.RESERVATION_ID_LABEL_KEY, Operator.IN, [f"res-{j}"]),
                    ]
                ),
                price=0.001,
                available=True,
                reservation_capacity=2,
            )
        )
    taint = Taint("smoke.io/team", TaintEffect.NO_SCHEDULE, "a")
    default = (
        fixtures.node_pool(
            name="default",
            limits={"cpu": "18000"},
            requirements=[NodeSelectorRequirement(wk.INSTANCE_TYPE_LABEL_KEY, Operator.EXISTS, min_values=3)],
        )
        if screens
        else fixtures.node_pool(name="default")
    )
    pools = [default, fixtures.node_pool(name="dedicated", weight=10, taints=[taint])]
    ibp = {p.name: its for p in pools}
    views = []
    for vi in range(n_nodes):
        it = its[(vi * 37 + 11) % len(its)]
        name = f"smoke-full-node-{vi}"
        labels = {
            wk.TOPOLOGY_ZONE_LABEL_KEY: KWOK_ZONES[vi % len(KWOK_ZONES)],
            wk.HOSTNAME_LABEL_KEY: name,
            wk.INSTANCE_TYPE_LABEL_KEY: it.name,
            wk.CAPACITY_TYPE_LABEL_KEY: "on-demand",
            wk.OS_LABEL_KEY: "linux",
            wk.ARCH_LABEL_KEY: "amd64",
            wk.NODEPOOL_LABEL_KEY: "default",
        }
        v = StateNodeView(
            name=name,
            node_labels={wk.TOPOLOGY_ZONE_LABEL_KEY: labels[wk.TOPOLOGY_ZONE_LABEL_KEY]},
            labels=labels,
            available={k: q // 2 for k, q in it.allocatable().items()},
            capacity=dict(it.capacity),
            initialized=True,
        )
        if vi == 0:
            v.host_port_usage.add(fixtures.pod(name="smoke-full-squat"), [("0.0.0.0", "TCP", 443)])
        views.append(v)
    n_port, n_narrow, n_pref = 60, 40, 40
    pods = fixtures.make_diverse_pods(n_pods - n_port - n_narrow - n_pref)
    for i in range(n_port):
        tol = [Toleration(key="smoke.io/team", operator="Exists")] if i % 2 else None
        p = fixtures.pod(name=f"smoke-full-port-{i}", requests={"cpu": "500m", "memory": "256Mi"}, tolerations=tol)
        p.host_ports = [("0.0.0.0", "TCP", 443 if i % 3 == 0 else 8080)]
        pods.append(p)
    two = [its[0].name, its[5].name]
    for i in range(n_narrow):
        p = fixtures.pod(name=f"smoke-full-narrow-{i}", requests={"cpu": "100m"})
        term = NodeSelectorTerm(match_expressions=[NodeSelectorRequirement(wk.INSTANCE_TYPE_LABEL_KEY, Operator.IN, two)])
        p.node_affinity = NodeAffinity(preferred=[PreferredSchedulingTerm(weight=5, preference=term)])
        pods.append(p)
    pods += fixtures.make_preference_pods(n_pref)
    options = SchedulerOptions(reserved_capacity_enabled=True) if screens else None
    return World(pools, ibp, pods, views, options, Topology(pools, ibp, pods, state_node_views=views))


def scheduler_for(world: World, dev):
    from karpenter_tpu_torch.solver.tpu import TorchScheduler

    sched = TorchScheduler(world.pools, world.ibp, world.topo, world.views, None, world.options, device=dev)
    return sched, world.pods


def step_inputs(world: World, dev, prefix=None, in_order=False, N=None):
    """(tb, st, xs) of a world's first requeue round, built by the port:
    the pods in FFD order (or as given, like `__graft_entry__._small_problem`),
    with the scan path's claim-slot count (or N slots)."""
    from karpenter_tpu_torch.solver.tpu_problem import _pow2, encode_problem

    sched, pods = scheduler_for(world, dev)
    problem = encode_problem(sched.oracle, pods)
    order = sched._order_pods(problem)
    if in_order:
        order = list(range(len(pods)))
    tb = sched._tables(problem)
    sched._upload_pod_tables(problem)
    if N is None:
        N = min(_pow2(max(64, (len(pods) + 3) // 4)), _pow2(len(pods)))
    st = sched._init_state(problem, N)
    xs = sched._pod_xs(problem, order[:prefix] if prefix else order)
    return tb, st, xs


def odometer_mismatches(got, want) -> list[str]:
    """Odometer fields where two dispatches differ."""
    import torch

    return [f for f in got._fields if not torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu())]


def scan_mismatches(got, want) -> list[str]:
    """Field names where two solve_scan results differ."""
    import torch

    bad = state_mismatches(got[0], want[0])
    for i, name in ((1, "kinds"), (2, "slots"), (3, "overflow")):
        if not torch.equal(got[i], want[i]):
            bad.append(name)
    return bad + odometer_mismatches(got[4], want[4])


def state_mismatches(a, b) -> list[str]:
    import torch

    bad = []
    for name, x, y in zip(type(a)._fields, a, b):
        if isinstance(x, tuple):
            bad += [f"{name}.{f}" for f, xx, yy in zip(x._fields, x, y) if not torch.equal(xx, yy)]
        elif not torch.equal(x, y):
            bad.append(name)
    return bad


def results_snapshot(r, pods) -> tuple:
    """The decision picture two solvers must agree on (pods by name)."""
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
    existing = sorted((n.view.name, tuple(sorted(name[p.uid] for p in n.pods))) for n in r.existing_nodes if n.pods)
    errors = tuple(sorted(name[u] for u in r.pod_errors))
    return claims, existing, errors, bool(r.timed_out)


def oracle_parity(world: World, dev) -> tuple[bool, int, bool]:
    """Solve a world with TorchScheduler on `dev` and a deep copy of it
    with the port's oracle; (equal snapshots, the oracle's claim count,
    whether the solve took the runs path)."""
    from karpenter_tpu_torch.solver.oracle import Scheduler

    twin = copy.deepcopy(world)
    sched, pods = scheduler_for(world, dev)
    got = results_snapshot(sched.solve(pods), pods)
    oracle = Scheduler(twin.pools, twin.ibp, twin.topo, twin.views, None, twin.options)
    want = results_snapshot(oracle.solve(twin.pods), twin.pods)
    return got == want, len(want[0]), sched.last_used_runs


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_split(fn, reps: int, names: tuple) -> dict:
    """Per-call device time in ms of each kernel whose name contains one of
    `names`, from a torch.profiler trace of `reps` calls ({} when the trace
    shows them no device time). Unlike cuda_ms, the host work between
    launches does not count."""
    trace = device_trace(fn, reps)
    out = {n: sum(ms for key, (ms, _) in trace.items() if n in key) for n in names}
    return {n: ms for n, ms in out.items() if ms}


def device_ms(fn, reps: int, names: tuple) -> Optional[float]:
    """device_split's times summed (None when the trace shows none)."""
    split = device_split(fn, reps, names)
    return sum(split.values()) if split else None


def device_trace(fn, reps: int) -> dict:
    """{device kernel: [ms a call, launches a call]} of every device event
    of a torch.profiler trace of `reps` calls, after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            ms, k = out.get(e.key, (0.0, 0.0))
            out[e.key] = (ms + us / 1e3 / reps, k + e.count / reps)
    return out


def host_ms(fn, reps: int, batches: int = 5) -> float:
    """The host side of a call: the wall ms of `reps` calls with no sync,
    per call, the least of `batches` such runs (the device catches up
    between them, untimed): the shared host's other work only adds."""
    import torch

    fn()
    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best * 1e3 / reps


class K1Rows(NamedTuple):
    """A K1 launch as TorchScheduler._tables makes it: the type tables,
    the distinct rows it screens and the words a row."""

    tb: object
    rows: object
    iw: int

    def launch(self):
        from karpenter_tpu_torch.solver import tpu as T

        return T.typeok_screen(self.tb.ireq, self.tb.va, self.rows, self.iw)

    def plain(self):
        from karpenter_tpu_torch.solver import tpu as T

        return T.typeok_plain(self.tb.ireq, self.tb.va, self.rows, self.iw)


def k1_rows(world: World, dev, tier: bool = False) -> K1Rows:
    """A world's class rows (`_class_rows`) or, with `tier`, its tier rows
    (`_tier_rows`), as the solve screens them."""
    from karpenter_tpu_torch.solver.tpu_problem import encode_problem

    sched, pods = scheduler_for(world, dev)
    problem = encode_problem(sched.oracle, pods)
    tb = sched._tables(problem)
    iw = max(1, (problem.num_types + 31) // 32)
    return K1Rows(tb, sched._tier_rows(problem) if tier else sched._class_rows(problem), iw)


def k1_checked(label: str, k: K1Rows) -> int:
    """K1 against its plain version on the card: the mismatched words."""
    import torch

    got, want = k.launch(), k.plain()
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    log(
        f"K1 typeok_screen {label}: [{k.rows.mask.shape[0]}, {k.iw}] words "
        f"(TW={k.tb.va.full_mask.shape[0]}, K={k.tb.va.num_keys}, I={k.tb.ireq.mask.shape[0]}): "
        f"{bad} mismatched words vs plain"
    )
    return bad


def k1_bound_of(k: K1Rows) -> tuple[float, str]:
    """K1's least time: the type fields and the B rows read once, the
    [B, IW] words written once; B x I pairs of TW mask words and 2 K
    bounds."""
    I, TW, Kk = k.tb.ireq.mask.shape[0], k.tb.ireq.mask.shape[1], k.tb.va.num_keys
    B = k.rows.mask.shape[0]
    row_bytes = TW * 4 + Kk * (3 + 2 * 4)  # mask, other/notin/defined, gt/lt
    return bound((I + B) * row_bytes + TW * 4 + B * k.iw * 4, B * I * (TW + 2 * Kk))


K4_EDGE_P = (1, 31, 32, 33, 1024, 1025, 16384, 65536, 1 << 20)
# rounds whose class flags exceed what K4 stages in shared memory
# (csrc/run_arrays.cu FLAGS_SMEM): it reads them from device memory
K4_WIDE_CLASSES, K4_WIDE_P = 40000, (33, 16384, 1 << 20)


def k4_edge_checks(dev) -> list:
    """K4 against run_arrays_plain on seeded rounds at the edges of its
    tiles and of the runs path's buckets (up to 2^20 positions, past the
    largest bucket): at each P, n = 0, a middle n (runs of a sorted class
    order, then padding) and n = P, and one run over every position; then
    with more classes than K4 stages in shared memory. Returns the
    (classes, P, n, case) that disagree."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.solver import tpu as T

    rng = np.random.default_rng(4)
    n_pods = (1 << 20) + 4096
    bad = []
    for n_cls, sizes in ((50, K4_EDGE_P), (K4_WIDE_CLASSES, K4_WIDE_P)):
        cls = torch.from_numpy(np.sort(rng.integers(0, n_cls, n_pods)).astype(np.int32)).to(dev)
        bulk_c = torch.from_numpy(rng.random(n_cls) < 0.6).to(dev)
        aff_c = torch.from_numpy(rng.random(n_cls) < 0.3).to(dev)
        for P in sizes:
            for n, case in ((0, "n=0"), (P // 2 + 1 if P > 1 else 1, "middle"), (P, "n=P"), (P, "one run")):
                idx = np.zeros(P, np.int32)
                if case == "one run":
                    idx[:] = 7
                else:
                    idx[:n] = np.sort(rng.choice(n_pods, size=n, replace=False))
                args = (cls, bulk_c, aff_c, torch.from_numpy(idx).to(dev), n)
                got, want = T.run_arrays(*args), T.run_arrays_plain(*args)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    bad.append((n_cls, P, n, case))
    torch.cuda.synchronize()
    log(f"K4 run_arrays edges (P in {list(K4_EDGE_P)}, and {list(K4_WIDE_P)} with {K4_WIDE_CLASSES} classes; "
        f"n = 0, middle, P, one run): mismatches={bad or 'none'}")
    return bad


def nbytes(*trees) -> int:
    import torch

    total = 0
    stack = list(trees)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, tuple):
            stack.extend(x)
    return total


class RunsRound(NamedTuple):
    """A world's first runs-path dispatch as the scheduler builds it."""

    sched: object
    problem: object
    order: list
    tb: object
    st: object
    seq: object
    rx: object
    relax: bool


def runs_round(world: World, dev, claim_slot_div: Optional[int] = None, exact_only: bool = False) -> RunsRound:
    """(tb, state, seq, RunX) of a world's first runs-path dispatch, built
    the way TorchScheduler.solve builds it (the run arrays through K4 on
    the card). With `exact_only` a world no class of which passes the bulk
    gates still gets a round: every pod takes K3's exact step."""
    import torch

    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver.tpu_problem import _pow2, encode_problem

    sched, pods = scheduler_for(world, dev)
    problem = encode_problem(sched.oracle, pods)
    order = sched._order_pods(problem)
    tb = sched._tables(problem)
    sched._upload_pod_tables(problem)
    sched._bulk_flags_c = T._bulk_class_flags(problem, T._bulk_gates(problem))
    if not (sched._bulk_flags_c.any() or exact_only):
        raise RuntimeError("runs_round: no pod class passes the bulk gates")
    sched._set_runflags_dev()
    div = claim_slot_div or max(1, int(sched.opts.claim_slot_div))
    N = min(_pow2(max(64, (len(pods) + div - 1) // div)), _pow2(len(pods)))
    xs, idx_d = sched._pod_xs_with_idx(problem, order)
    rx = sched._run_x(xs, idx_d, len(order))
    seq = torch.zeros(N, dtype=torch.int32, device=dev)
    relax = bool((problem.ntiers_r > 1).any())
    return RunsRound(sched, problem, order, tb, sched._init_state(problem, N), seq, rx, relax)


def runs_mismatches(got, want) -> list[str]:
    """Field names where two solve_runs results differ."""
    import torch

    bad = state_mismatches(got[0], want[0])
    for i, name in ((1, "seq"), (2, "next_seq"), (3, "kinds"), (4, "slots"), (5, "overflow"), (7, "ptr")):
        if not torch.equal(got[i], want[i]):
            bad.append(name)
    return bad + odometer_mismatches(got[6], want[6])


def dedup_mismatches(got, want) -> list[str]:
    import torch

    return [name for name, a, b in zip(("n_uniq", "inv", "compact"), got, want) if not torch.equal(a, b)]


def k5_columns(dev, n: int, widths: tuple, kind: str, seed: int) -> list:
    """Nine claim columns of n rows in the dedup layout (int32, three of
    them bool), made on the host from a seed: rows drawn from a pool of
    n // 8 (kind "pool") or of 40 ("few", as the headline's final state
    has tens), one row repeated ("equal") or every row its own
    ("distinct": the first int column holds the row's index)."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    pool = {"pool": max(2, n // 8), "few": 40, "equal": 1, "distinct": n}[kind]
    pick = torch.randint(0, pool, (n,), generator=gen) if kind in ("pool", "few") else torch.arange(n) % pool
    cols = []
    for w, is_bool in zip(widths, K5_BOOL):
        if is_bool:
            base = torch.randint(0, 2, (pool, w), generator=gen).bool()
        else:
            base = torch.randint(-(1 << 31), (1 << 31) - 1, (pool, w), generator=gen, dtype=torch.int64).to(torch.int32)
        cols.append(base[pick])
    if kind == "distinct":
        first = next(k for k, w in enumerate(widths) if w and not K5_BOOL[k])
        cols[first][:, 0] = torch.arange(n, dtype=torch.int32)
    return [c.to(dev) for c in cols]


def k5_edge_checks(dev) -> list:
    """K5 against its plain version on every K5_EDGES column set: the
    mismatched outputs."""
    import torch

    from karpenter_tpu_torch.solver import tpu as T

    bad, uniq = [], {}
    for seed, (label, n, widths, kind) in enumerate(K5_EDGES):
        cols = k5_columns(dev, n, widths, kind, seed)
        got, want = T.dedup_columns(cols, n), T.dedup_columns_plain(cols, n)
        torch.cuda.synchronize()
        bad += [f"{label}: {b}" for b in dedup_mismatches(got, want)]
        uniq[label] = int(want[0])
    log(f"K5 dedup_rows edges (uniques): {json.dumps(uniq)}; mismatches={bad or 'none'}")
    return bad


def phase_breakdown(world, dev) -> dict:
    """Host-clock seconds of each phase of one runs-path solve, re-run
    phase by phase with a device sync after each. The dispatch loop is the
    scheduler's (overflow -> grow -> go on from the overflowing pod, the
    tier loop on when the problem has tiers); it needs a solve that
    finishes in one requeue round, as the headline and c6 do."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver import tpu_runs as KR
    from karpenter_tpu_torch.solver.tpu_problem import _pow2, encode_problem

    sched, pods = scheduler_for(world, dev)
    out = {"encode": 0.0, "order": 0.0, "tables_typeok_upload": 0.0, "pod_xs_run_arrays": 0.0,
           "run_step_dispatches_regrow": 0.0, "dedup_decode": 0.0}
    t0 = time.monotonic()

    def mark(name):
        nonlocal t0
        torch.cuda.synchronize()
        now = time.monotonic()
        out[name] += now - t0
        t0 = now

    problem = encode_problem(sched.oracle, pods)
    relax = bool((problem.ntiers_r > 1).any())
    mark("encode")
    order = sched._order_pods(problem)
    mark("order")
    tb = sched._tables(problem)
    sched._upload_pod_tables(problem)
    sched._bulk_flags_c = T._bulk_class_flags(problem, T._bulk_gates(problem))
    sched._set_runflags_dev()
    div = max(1, int(sched.opts.claim_slot_div))
    N = min(_pow2(max(64, (len(pods) + div - 1) // div)), _pow2(len(pods)))
    st = sched._init_state(problem, N)
    seq = torch.zeros(N, dtype=torch.int32, device=dev)
    nseq = torch.zeros((), dtype=torch.int32, device=dev)
    mark("tables_typeok_upload")
    kinds = np.full(len(pods), K.KIND_FAIL, np.int32)
    slots = np.full(len(pods), -1, np.int32)
    offset = 0
    while True:
        batch = order[offset:]
        xs, idx_d = sched._pod_xs_with_idx(problem, batch)
        rx = sched._run_x(xs, idx_d, len(batch))
        mark("pod_xs_run_arrays")
        st, seq, nseq, got_k, got_s, over, _, ptr = KR.solve_runs(tb, st, rx, seq, nseq, len(batch), relax)
        n_done = int(ptr) if bool(over) else len(batch)
        kinds[batch[:n_done]] = got_k[:n_done].cpu().numpy()
        slots[batch[:n_done]] = got_s[:n_done].cpu().numpy()
        if bool(over):
            st, seq = sched._grow(problem, st, seq, N)
            N *= 2
            offset += n_done
        mark("run_step_dispatches_regrow")
        if not bool(over):
            break
    if (kinds == K.KIND_FAIL).any():
        raise RuntimeError("phase breakdown needs a one-round solve")
    sched._decode(problem, st, kinds, slots, False)
    mark("dedup_decode")
    return out


def clock_breakdown(kernel: str, launches, mismatches, dev) -> tuple[dict, list]:
    """The per-phase clock breakdown (csrc/step.cuh prof_mark) of a run of
    launches of `kernel`, each a function of its prof buffer (None: off),
    summed over the run. Every profiled launch is held bit for bit to the
    same launch without the breakdown. Returns ({"cycles", "ms",
    "clock_mhz", "phases": {phase: {cycles, entries, us, share}}}, the
    mismatched fields)."""
    import torch

    from karpenter_tpu_torch.solver import tpu_kernel as K

    total, bad = None, []
    for launch in launches:
        prof = K.prof_buffer(kernel, dev)
        got = launch(prof)
        want = launch(None)
        torch.cuda.synchronize()
        bad += mismatches(got, want)
        total = prof if total is None else total + prof
    b = K.breakdown(kernel, total)
    cyc_per_us = b["cycles"] / max(b["ns"], 1) * 1e3
    phases = {
        p: {"cycles": c, "entries": n, "us": round(c / cyc_per_us, 3), "share": round(c / max(b["cycles"], 1), 4)}
        for p, (c, n) in b["phases"].items()
        if n
    }
    return {"cycles": b["cycles"], "ms": b["ns"] / 1e6, "clock_mhz": round(cyc_per_us, 1), "phases": phases}, bad


def device_tables_launch(kernel: str, fn):
    """fn() with every launch table read from device memory (a shared-memory
    cap of 0), and the launch's table layout."""
    from karpenter_tpu_torch.solver import tpu_kernel as K

    K.SMEM_CAP = 0
    try:
        return fn(), K.last_layout(kernel)
    finally:
        K.SMEM_CAP = None


def runs_checked(world: World, dev, exact_only: bool = False, device_tables: bool = False) -> dict:
    """Every runs-path dispatch of a world's first round (the state grown
    on each overflow, as TorchScheduler.solve does), each K3 launch held bit
    for bit to its plain version; with `device_tables` each dispatch also
    launches with every table in device memory, held to the same plain
    result. Returns the mismatched fields, each dispatch's (steps,
    bulk_steps, tier_steps), the kernel's and the plain version's ms summed
    over the dispatches, the last launch's table layout (and the
    device-memory launch's) and the final kinds."""
    import torch

    from karpenter_tpu_torch import device as D
    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver import tpu_runs as KR

    rr = runs_round(world, dev, exact_only=exact_only)
    st, seq, N, offset = rr.st, rr.seq, rr.st.active.shape[0], 0
    nseq = torch.zeros((), dtype=torch.int32, device=dev)
    out = {"bad": [], "steps": [], "ms": 0.0, "plain_ms": 0.0, "kinds": []}
    while True:
        batch = rr.order[offset:]
        rx = rr.rx
        if offset:
            xs_b, idx_b = rr.sched._pod_xs_with_idx(rr.problem, batch)
            rx = rr.sched._run_x(xs_b, idx_b, len(batch))
        args = (rr.tb, st, rx, seq, nseq, len(batch), rr.relax)
        got = KR.solve_runs(*args)
        out["layout"] = K.last_layout("run_step")
        t0 = time.monotonic()
        want = KR.solve_runs_plain(*args)
        torch.cuda.synchronize()
        out["plain_ms"] += (time.monotonic() - t0) * 1e3
        out["bad"] += runs_mismatches(got, want)
        if device_tables:
            got0, out["layout0"] = device_tables_launch("run_step", lambda: KR.solve_runs(*args))
            out["bad"] += [f"{f} (tables in device memory)" for f in runs_mismatches(got0, want)]
        out["ms"] += cuda_ms(lambda: KR.solve_runs(*args), 2)
        out["steps"].append([int(got[6].steps), int(got[6].bulk_steps), int(got[6].tier_steps)])
        done = int(got[7]) if bool(got[5]) else len(batch)
        out["kinds"] += got[3][:done].cpu().tolist()
        if not bool(got[5]):
            out["held_bits"] = int(D.popcount(got[0].held).sum())
            break
        st, seq = rr.sched._grow(rr.problem, got[0], got[1], N)
        N, offset, nseq = 2 * N, offset + done, got[2]
    out.update(relax=rr.relax, E=rr.st.eavail.shape[0], N0=rr.st.active.shape[0], HPW=rr.st.hp_used.shape[1],
               NRES=rr.st.rescap.shape[0], I=rr.tb.ialloc.shape[0], O=rr.tb.otype.shape[0],
               TW=rr.tb.va.full_mask.shape[0])
    return out


def scan_checked(world: World, dev, n_slots: int, device_tables: bool = False, prefix: Optional[int] = None) -> dict:
    """K2 over a world's first round (its first `prefix` pods, or all) with
    `n_slots` claim slots (the tier loop on when the round has tiers), held
    bit for bit to its plain version; with `device_tables` a second launch
    reads every table from device memory and is held to the same plain
    result."""
    import torch

    from karpenter_tpu_torch.solver import tpu_kernel as K

    tb, st, xs = step_inputs(world, dev, prefix=prefix, N=n_slots)
    relax = bool((xs.ntiers > 1).any())
    got = K.solve_scan(tb, st, xs, relax=relax)
    layout = K.last_layout("scan_step")
    t0 = time.monotonic()
    want = K.solve_scan_plain(tb, st, xs, relax=relax)
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t0) * 1e3
    bad, layout0 = scan_mismatches(got, want), None
    if device_tables:
        got0, layout0 = device_tables_launch("scan_step", lambda: K.solve_scan(tb, st, xs, relax=relax))
        bad += [f"{f} (tables in device memory)" for f in scan_mismatches(got0, want)]
    return {
        "bad": bad, "layout0": layout0, "relax": relax, "P": xs.valid.shape[0], "N": n_slots,
        "over": bool(got[3]), "tier_steps": int(got[4].tier_steps), "layout": layout,
        "ms": cuda_ms(lambda: K.solve_scan(tb, st, xs, relax=relax), 2), "plain_ms": plain_ms,
    }


def full_size_phase(dev) -> Optional[dict]:
    """The screens the headline bypasses at full size, with the solves'
    decisions equal to the port's oracle: the screens world (pool limit,
    reservations, minValues; the bulk gates send its solve down the scan
    path) through K2 (the round's first FULL_K2_CHECK_POSITIONS pods) and
    K3 (every dispatch, every pod on its exact step), each held bit for
    bit to its plain version, and again
    with every launch table read from device memory; and the bulk world
    (existing-node windows) through K3 against its plain version, its
    runs-path and forced-scan solves against the oracle. Then a catalog of
    LARGE_CATALOG_TYPES types, whose type tables do not all fit the shared
    memory, through both kernels against their plain versions. K1 is held
    to its plain version on the screens world's and the catalog's class
    rows. Returns the phase's numbers (with the catalog's K1 launch), or
    None when anything disagrees."""
    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver import tpu_runs as KR
    from karpenter_tpu_torch.solver.oracle import Scheduler
    from karpenter_tpu_torch.solver.tpu_problem import _pow2

    t_phase = time.monotonic()
    # K1 on the screens world's class rows and the large catalog's
    out = {"k1_large": k1_rows(headline_world(LARGE_CATALOG_PODS, build_universe(LARGE_CATALOG_TYPES)), dev)}
    k1_bad = k1_checked(f"full-size screens world class rows ({FULL_PODS} pods)", k1_rows(full_world(True), dev))
    k1_bad += k1_checked(f"{LARGE_CATALOG_TYPES}-type catalog class rows ({LARGE_CATALOG_PODS} pods)", out["k1_large"])
    if k1_bad:
        return None
    for label, screens in (("screens", True), ("bulk", False)):
        k3 = runs_checked(full_world(screens), dev, exact_only=screens, device_tables=screens)
        kinds = k3.pop("kinds")
        log(
            f"K3 run_step full-size {label} ({FULL_PODS} pods, E={k3['E']}, HPW={k3['HPW']}, NRES={k3['NRES']}, "
            f"relax={k3['relax']}, N0={k3['N0']}, held reservations {k3['held_bits']}): dispatches "
            f"(steps, bulk, tier) {k3['steps']}, "
            f"kinds(existing/claim/new/fail)={[kinds.count(k) for k in range(4)]}, kernel {k3['ms']:.3f} ms, "
            f"plain {k3['plain_ms']:.1f} ms, tables {k3['layout']}"
            + (f", again with tables {k3['layout0']}" if screens else "")
            + f", mismatches={k3['bad'] or 'none'}"
        )
        # K2 against its plain version where it is the main path (the screens
        # world); the bulk world's forced scan solve is held to the oracle
        k2 = scan_checked(full_world(screens), dev, _pow2(FULL_PODS), device_tables=True,
                          prefix=FULL_K2_CHECK_POSITIONS) if screens else None
        if k2:
            log(
                f"K2 scan_step full-size {label} (P={k2['P']}, N={k2['N']}, relax={k2['relax']}, over={k2['over']}, "
                f"tier_steps={k2['tier_steps']}): kernel {k2['ms']:.3f} ms, plain {k2['plain_ms']:.1f} ms, "
                f"tables {k2['layout']}, again with tables {k2['layout0']}, mismatches={k2['bad'] or 'none'}"
            )
            if k2["bad"] or k2["over"] or any(k2["layout0"]["shared"].values()):
                return None
        if k3["bad"] or kinds.count(K.KIND_EXISTING) == 0 or kinds.count(K.KIND_NEW) == 0:
            return None
        if screens and any(k3["layout0"]["shared"].values()):
            return None
        ow = full_world(screens)
        oracle = Scheduler(ow.pools, ow.ibp, ow.topo, ow.views, None, ow.options)
        want = results_snapshot(oracle.solve(ow.pods), ow.pods)
        for force in (False,) if screens else (False, True):
            sched, pods = scheduler_for(full_world(screens), dev)
            sched.debug_force_scan = force
            reset_launches()
            got = results_snapshot(sched.solve(pods), pods)
            launches = {k: v for c in (K.LAUNCHES, KR.LAUNCHES) for k, v in c.items() if v}
            log(
                f"oracle parity, full-size {label}{' (forced scan)' if force else ''}: "
                f"{'equal' if got == want else 'DIFFERENT'} ({len(want[0])} claims, {len(want[1])} existing nodes "
                f"used, {len(want[2])} errors; runs path={sched.last_used_runs}, relax={sched.last_relax}, "
                f"launches {launches})"
            )
            runs = not (screens or force)
            kernel = ("run_step" if runs else "scan_step") + ("_relax" if sched.last_relax else "")
            if got != want or sched.last_used_runs != runs or not launches.get(kernel):
                return None
        out[label] = {"k3": k3, "k2": k2}
    # the large catalog: tables past the shared-memory budget
    k3l = runs_checked(headline_world(LARGE_CATALOG_PODS, build_universe(LARGE_CATALOG_TYPES)), dev)
    k3l.pop("kinds")
    k2l = scan_checked(headline_world(LARGE_CATALOG_PODS, build_universe(LARGE_CATALOG_TYPES)), dev,
                       _pow2(LARGE_CATALOG_PODS))
    log(
        f"large catalog (I={k3l['I']}, O={k3l['O']}, TW={k3l['TW']}, {LARGE_CATALOG_PODS} pods): K3 dispatches "
        f"{k3l['steps']} kernel {k3l['ms']:.3f} ms, tables {k3l['layout']}, mismatches={k3l['bad'] or 'none'}; "
        f"K2 kernel {k2l['ms']:.3f} ms, tables {k2l['layout']}, mismatches={k2l['bad'] or 'none'}"
    )
    spilled = not all(k3l["layout"]["shared"].values()) and not all(k2l["layout"]["shared"].values())
    if k3l["bad"] or k2l["bad"] or k2l["over"] or not spilled:
        return None
    out.update(large_k3=k3l, large_k2=k2l, seconds=time.monotonic() - t_phase)
    log(f"full-size phase: {out['seconds']:.1f}s")
    return out


def ptxas_lines(log_text: str) -> list[str]:
    """Each kernel's and device function's registers, stack, spills and
    shared memory from nvcc's -Xptxas -v output, one line per function."""
    out, name = [], None
    for line in log_text.splitlines():
        line = line.strip()
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and ("stack frame" in line or "registers" in line):
            out.append(f"{name}: {line.replace('ptxas info    : ', '')}")
        elif "error" in line.lower():
            out.append(line)
    return out


def row(name, source, replaces, nlaunch, mism, ms, plain_ms, bound_ms, bound_by, library_ms=None) -> dict:
    """One kernel's entry of the kernels line."""
    return {
        "name": name, "route": "cuda", "source": f"karpenter_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": nlaunch, "mismatches": mism, "max_abs_err": 0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def bound(nbytes_: int, ops: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the two least times."""
    tb_, to_ = nbytes_ / HBM_BYTES_PER_S, ops / CORE_OPS_PER_S
    return max(tb_, to_) * 1e3, "bytes" if tb_ >= to_ else "operations"


def sweep_candidates(world, n: int) -> list:
    """The fleet's top n consolidation candidates, in the reference's order
    (disruption cost, then name)."""
    from karpenter_tpu_torch.controllers.disruption.helpers import build_candidates

    cands = build_candidates(world.kube, world.cluster, world.cloud, world.clock, lambda c: c.consolidatable())
    cands.sort(key=lambda c: (c.disruption_cost, c.name))
    return cands[:n]


def referee_lanes(verdicts, seeded: int, seed: int, edges: bool = True) -> list[int]:
    """Lanes to hold against the sequential referee: every lane whose
    verdict differs from a neighbour's (with `edges`), plus `seeded` lanes
    drawn from a seeded generator."""
    import numpy as np

    v = list(verdicts)
    changes = {k for k in range(len(v)) for j in (k - 1, k + 1) if edges and 0 <= j < len(v) and v[j] != v[k]}
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(v), size=min(seeded, len(v)), replace=False)
    return sorted(changes | {int(k) for k in picks})


def referee_mismatches(world, cands, rows, verdicts) -> list[int]:
    """Lanes (indices into rows) whose verdict the port's sequential
    referee contradicts: all pods scheduled and at most one non-empty new
    claim (helpers.simulate_scheduling on the oracle)."""
    from karpenter_tpu_torch.controllers.disruption.helpers import simulate_scheduling

    bad = []
    for k, row in rows:
        subset = [c for j, c in enumerate(cands) if row[j]]
        sim = simulate_scheduling(world.kube, world.cluster, world.cloud, subset, force_oracle=True)
        ok = sim.all_pods_scheduled() and len(sim.non_empty_new_claims()) <= 1
        if ok != bool(verdicts[k]):
            bad.append(k)
    return bad


def reset_launches() -> None:
    """Set every kernel wrapper's launch count and the fleet counters to 0."""
    from karpenter_tpu_torch.controllers.disruption import setsweep as SS
    from karpenter_tpu_torch.controllers.disruption import sweep as S
    from karpenter_tpu_torch.solver import fleet as F
    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver import tpu_runs as KR

    for counts in (S.LAUNCHES, SS.LAUNCHES, T.LAUNCHES, K.LAUNCHES, KR.LAUNCHES):
        for k in counts:
            counts[k] = 0
    F.reset_counters()


def fast_fleet_checks(dev, w, cands, tag: str, seed: int, rows_out: list, profiled: list,
                      seeded: int = REFEREE_SEEDED, c0_differs: bool = False) -> bool:
    """K6 (prefix and singleton lanes) and K8 (SET_LANES first-round rows,
    smallest set first) on one fleet: each main path with its launch count
    reset just before and read just after; each kernel's verdicts, steps
    and per-lane leftovers held bit for bit against its plain version, and
    again with every table and the lanes' availability in device memory
    (a shared-memory cap of 0); the verdicts held against the sequential
    referee (`seeded` lanes of each kind and the verdict edges). With
    `c0_differs`, each kernel's lanes must leave different first leftover
    classes, and the referee takes the seeded lanes alone (there a verdict
    changes with every third node). Appends the kernels-line rows (names suffixed with `tag`) and
    the profiler's calls; False when a check failed."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.controllers.disruption import setsweep as SS
    from karpenter_tpu_torch.controllers.disruption import sweep as S
    from karpenter_tpu_torch.solver.ordering import ffd_sort_key
    from karpenter_tpu_torch.solver.tpu_problem import encode_problem

    def held(got, want, verdicts) -> int:
        """Mismatches of (feasible, steps, left) against the plain version
        and of the verdicts against the main path's."""
        mism = int((got[0] != want[0]).sum()) + int(int(got[1]) != int(want[1])) + int((got[2] != want[2]).sum())
        return mism + int(got[0].cpu().tolist()[: len(verdicts)] != list(verdicts))

    def first_left(label, left) -> bool:
        """Log the lanes' first leftover classes; False when c0_differs
        and every lane has the same one."""
        c0 = (left > 0).to(torch.int32).argmax(dim=1).tolist()
        kinds = {c: c0.count(c) for c in sorted(set(c0))}
        log(f"{label}{tag}: lanes by first leftover class {kinds}")
        return not c0_differs or len(kinds) > 1

    def ops_and_left(B, C, E, R, tb, left) -> tuple[int, int]:
        """The kernel's operations on these inputs: per lane, class and
        node a quotient and a compare per dim; the [T, C] template-fit
        table; one template filter over the I types for each lane with
        leftovers (the others take no filter). Also that lane count."""
        I, T, TWn = tb.ialloc.shape[0], tb.tdaemon.shape[0], tb.va.full_mask.shape[0]
        n_left = int((left.sum(dim=1) > 0).sum())
        return 2 * B * C * E * R + (T * C + n_left) * I * (TWn + R), n_left

    # ---- K6: main path runs, then the kernel vs plain ----
    verdicts = {}
    for singleton in (False, True):
        reset_launches()
        t0 = time.monotonic()
        verdicts[singleton] = S.prefix_feasibility(w.kube, w.cluster, w.cloud, cands, singleton=singleton, device=dev)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        key = "fast_sweep_singleton" if singleton else "fast_sweep"
        n_launch = S.LAUNCHES[key]
        log(f"{key}{tag} main path: {dt:.3f}s host, path={S.last_sweep['path']}, steps={S.last_sweep['steps']}, "
            f"launches={dict(S.LAUNCHES)}, feasible {sum(verdicts[singleton])}/{len(cands)}: "
            f"{''.join('1' if v else '0' for v in verdicts[singleton])}")
        if S.last_sweep["path"] != "sweep_fast" or n_launch != 1:
            return False
        # host phases: the union whole, then its encode, FFD order and table
        # upload again one by one, the lane inputs and the dispatch
        phases = {}
        t0 = time.monotonic()
        u = S.build_union(w.kube, w.cluster, w.cloud, cands, device=dev)
        torch.cuda.synchronize()
        phases["build_union"] = time.monotonic() - t0
        t0 = time.monotonic()
        encode_problem(u.sched.oracle, u.pods)
        phases["encode"] = time.monotonic() - t0
        t0 = time.monotonic()
        data = u.sched.oracle.cached_pod_data
        sorted(range(len(u.pods)), key=lambda i: ffd_sort_key(u.pods[i], data[u.pods[i].uid].requests))
        phases["order"] = time.monotonic() - t0
        t0 = time.monotonic()
        u.sched._tables(u.problem)
        u.sched._upload_pod_tables(u.problem)
        torch.cuda.synchronize()
        phases["upload"] = time.monotonic() - t0
        t0 = time.monotonic()
        args = S.fast_sweep_args(u.sched, u.problem, cands, u.view_slot, u.order, u.pod_prefix, singleton)
        torch.cuda.synchronize()
        phases["lane_inputs"] = time.monotonic() - t0
        xs1, avail0, cand_idx, counts, sizes = args
        t0 = time.monotonic()
        got = S.fast_sweep(u.tb, u.base, *args, singleton=singleton, with_left=True)
        got[0].cpu()
        phases["dispatch"] = time.monotonic() - t0
        want = S.fast_sweep_plain(u.tb, u.base, S._row0(xs1), avail0, cand_idx, counts, sizes, singleton, True)
        got0, _ = device_tables_launch("fast_sweep", lambda: S.fast_sweep(u.tb, u.base, *args, singleton=singleton,
                                                                          with_left=True))
        torch.cuda.synchronize()
        mism = held(got, want, verdicts[singleton]) + held(got0, want, verdicts[singleton])
        if not first_left(key, want[2][: len(cands)]):
            return False
        ms = cuda_ms(lambda: S.fast_sweep(u.tb, u.base, *args, singleton=singleton), 20)
        profiled.append((len(rows_out), lambda u=u, a=args, s=singleton: S.fast_sweep(u.tb, u.base, *a, singleton=s),
                         20, SWEEP_KERNELS))
        plain_ms = cuda_ms(lambda: S.fast_sweep_plain(u.tb, u.base, S._row0(xs1), *args[1:], singleton), 3)
        B, C = counts.shape
        E, R = avail0.shape
        nb = nbytes(u.tb, u.base.ereq, u.base.h_cnt, u.base.v_cnt, xs1, avail0, cand_idx, counts, sizes) + B
        ops, n_left = ops_and_left(B, C, E, R, u.tb, want[2])
        b_ms, b_by = bound(nb, ops)
        log(f"K6 {key}{tag} (E={E}, B={B}, C={C}, R={R}, T={u.tb.tdaemon.shape[0]}, I={u.tb.ialloc.shape[0]}, "
            f"{n_left} lanes with leftovers): {mism} mismatches vs plain (verdicts, steps, leftovers); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.6f} ms ({b_by}); host phases (s): " + json.dumps({k: round(v, 4) for k, v in phases.items()}))
        if mism:
            return False
        rows_out.append(row(("fast_sweep (singleton)" if singleton else "fast_sweep") + tag, "fast_sweep.cu",
                            "karpenter_tpu/controllers/disruption/sweep.py:158", n_launch, mism, ms, plain_ms,
                            b_ms, b_by))

    # ---- K8: the removal-set sweep ----
    t0 = time.monotonic()
    ctx = SS.SetSweepContext.build(w.kube, w.cluster, w.cloud, cands, device=dev)
    proposer = SS.SetProposer(cands, seed=7, max_lanes=SET_LANES)
    member = proposer.first_round()
    if len(member) < SET_LANES:
        member = np.concatenate([member, proposer._dedup(proposer._random(4 * SET_LANES))], axis=0)[:SET_LANES]
    # smallest set first, so a verdict that follows the set's size changes
    # between few neighbours
    member = member[np.argsort(member.sum(axis=1), kind="stable")]
    log(f"set sweep context{tag} + {len(member)} first-round rows: {time.monotonic() - t0:.2f}s host")
    reset_launches()
    t0 = time.monotonic()
    set_verdicts = ctx.evaluate(member)
    dt = time.monotonic() - t0
    n_launch = SS.LAUNCHES["set_sweep"]
    log(f"set_sweep{tag} main path: {dt:.3f}s host, steps={S.last_sweep['steps']}, launches={dict(SS.LAUNCHES)}, "
        f"feasible {int(set_verdicts.sum())}/{len(member)}")
    if n_launch != 1:
        return False
    args = ctx.kernel_args(member)
    got = SS.set_sweep(*args, with_left=True)
    want = SS.set_sweep_plain(args[0], args[1], S._row0(args[2]), *args[3:], with_left=True)
    got0, _ = device_tables_launch("set_sweep", lambda: SS.set_sweep(*args, with_left=True))
    torch.cuda.synchronize()
    mism = held(got, want, set_verdicts.tolist()) + held(got0, want, set_verdicts.tolist())
    if not first_left("set_sweep", want[2][: len(member)]):
        return False
    ms = cuda_ms(lambda: SS.set_sweep(*args), 20)
    profiled.append((len(rows_out), lambda args=args: SS.set_sweep(*args), 20, SWEEP_KERNELS))
    plain_ms = cuda_ms(lambda: SS.set_sweep_plain(args[0], args[1], S._row0(args[2]), *args[3:]), 3)
    Bp, Jp = args[5].shape
    C = args[8].shape[0]
    E, R = ctx.avail0.shape
    nb = nbytes(args) - nbytes(args[1]) + nbytes(args[1].ereq, args[1].h_cnt, args[1].v_cnt) + Bp
    ops, n_left = ops_and_left(Bp, C, E, R, args[0], want[2])
    ops += Bp * Jp * C  # the counts base + M @ P
    b_ms, b_by = bound(nb, ops)
    log(f"K8 set_sweep{tag} (B={Bp} lanes for {len(member)} rows, J={Jp}, C={C}, E={E}, {n_left} lanes with "
        f"leftovers): {mism} mismatches vs plain (verdicts, steps, leftovers); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by})")
    if mism:
        return False
    rows_out.append(row("set_sweep" + tag, "set_sweep.cu", "karpenter_tpu/controllers/disruption/setsweep.py:100",
                        n_launch, mism, ms, plain_ms, b_ms, b_by))

    # ---- the referee ----
    t0 = time.monotonic()
    n_checked, bad = 0, []
    for singleton in (False, True):
        lanes = referee_lanes(verdicts[singleton], seeded, seed=seed + singleton, edges=not c0_differs)
        rows = [(k, [j == k if singleton else j <= k for j in range(len(cands))]) for k in lanes]
        bad += referee_mismatches(w, cands, rows, verdicts[singleton])
        n_checked += len(rows)
    lanes = referee_lanes(set_verdicts, seeded, seed=seed + 2, edges=not c0_differs)
    bad += referee_mismatches(w, cands, [(k, member[k]) for k in lanes], set_verdicts)
    n_checked += len(lanes)
    log(f"referee{tag}: {n_checked} lanes checked, {len(bad)} disagree ({time.monotonic() - t0:.1f}s host)")
    return not bad


def sweep_worlds() -> list:
    """The sweep phase's four 2000-node fleets, in the order it takes them:
    the c4 shape, the leftover fleet, the c0 fleet and the spread fleet,
    then the SPREAD_CHECK_NODES spread fleet (host work only: main builds
    them while nvcc runs)."""
    from karpenter_tpu_torch.testing.fixtures import underutilized_world

    return [
        underutilized_world(SWEEP_NODES, seed=7, n_pending=SWEEP_PENDING),
        underutilized_world(
            SWEEP_NODES, seed=7, rider_requests=LEFTOVER_RIDER, n_pending=SWEEP_PENDING,
            pending_requests=LEFTOVER_PENDING,
        ),
        underutilized_world(
            SWEEP_NODES, seed=7, rider_requests=LEFTOVER_RIDER, heavy_every=C0_EVERY, heavy_requests=C0_HEAVY
        ),
        underutilized_world(SWEEP_NODES, seed=7, rider_spread=RIDER_SPREAD),
        underutilized_world(SPREAD_CHECK_NODES, seed=7, rider_spread=RIDER_SPREAD),
    ]


def spread_referee_check(dev, w) -> bool:
    """Every prefix lane of a spread fleet (K7, the full-state lane path)
    against the sequential referee, on a fleet small enough that the
    referee is cheap (SPREAD_CHECK_NODES): the check of the lanes the
    2000-node spread fleet holds only up to PAST_EDGE past the last
    verdict change."""
    import torch

    from karpenter_tpu_torch.controllers.disruption import sweep as S
    from karpenter_tpu_torch.solver import tpu_kernel as K

    cands = sweep_candidates(w, LANE_CANDIDATES)
    reset_launches()
    t0 = time.monotonic()
    v = S.prefix_feasibility(w.kube, w.cluster, w.cloud, cands, device=dev)
    torch.cuda.synchronize()
    n = K.LAUNCHES["scan_lanes"] + K.LAUNCHES["scan_lanes_relax"]
    log(f"small spread world: {SPREAD_CHECK_NODES} nodes, {len(cands)} candidates; scan_lanes (prefix) "
        f"{time.monotonic() - t0:.3f}s host, path={S.last_sweep['path']}, launches={n}, "
        f"feasible {sum(v)}/{len(cands)}: {''.join('1' if x else '0' for x in v)}")
    if S.last_sweep["path"] != "sweep_vmap" or n != 1:
        return False
    t0 = time.monotonic()
    bad = referee_mismatches(w, cands, [(k, [j <= k for j in range(len(cands))]) for k in range(len(cands))], v)
    log(f"referee, small spread world (prefix): every lane, {len(cands)} checked, {len(bad)} disagree "
        f"({time.monotonic() - t0:.1f}s host)")
    return not bad


def sweep_phase(dev, worlds: Optional[list] = None) -> Optional[list]:
    """The consolidation sweeps on the card: the fast path (K6, prefix and
    singleton lanes) and the removal-set sweep (K8) at the c4 shape, where
    every lane places all its pods on existing nodes, and on a leftover
    fleet whose lanes leave pods for one new claim, which some lanes'
    leftovers fit and others' do not; the full-state lane path (K7) on a
    spread fleet. Each main path with its launch counts reset just before
    and read just after, each kernel held bit for bit against its plain
    version on the same inputs, verdicts held against the sequential
    referee, every prefix lane on the small spread fleet
    (spread_referee_check). The fleets are `worlds` (sweep_worlds(), built
    here when None).
    Returns the kernels-line rows, or None when a check failed."""
    import torch

    from karpenter_tpu_torch.controllers.disruption import sweep as S
    from karpenter_tpu_torch.solver import tpu_kernel as K

    t_phase = time.monotonic()
    rows_out = []
    profiled = []  # (row index, call, reps, kernel names) for device_ms
    worlds = list(worlds or sweep_worlds())
    w = worlds.pop(0)
    cands = sweep_candidates(w, SWEEP_CANDIDATES)
    log(f"sweep world: {SWEEP_NODES} nodes, {len(cands)} candidates, {SWEEP_PENDING} pending pods")
    if not fast_fleet_checks(dev, w, cands, "", 7, rows_out, profiled):
        return None
    w = worlds.pop(0)
    cands = sweep_candidates(w, SWEEP_CANDIDATES)
    log(f"leftover world: {SWEEP_NODES} nodes with riders of {LEFTOVER_RIDER}, {len(cands)} candidates, "
        f"{SWEEP_PENDING} pending pods of {LEFTOVER_PENDING}")
    if not fast_fleet_checks(dev, w, cands, LEFTOVER_TAG, 17, rows_out, profiled):
        return None
    w = worlds.pop(0)
    cands = sweep_candidates(w, SWEEP_CANDIDATES)
    log(f"c0 world: {SWEEP_NODES} nodes with riders of {LEFTOVER_RIDER}, every {C0_EVERY}rd holding {C0_HEAVY} "
        f"instead, {len(cands)} candidates")
    if not fast_fleet_checks(dev, w, cands, C0_TAG, 27, rows_out, profiled, C0_REFEREE_SEEDED, c0_differs=True):
        return None
    del w, cands

    # ---- the full-state lane path (K7) ----
    w2 = worlds.pop(0)
    cands2 = sweep_candidates(w2, LANE_CANDIDATES)
    log(f"lane world: {SWEEP_NODES} nodes, riders with a zone spread (max skew {RIDER_SPREAD}), "
        f"{len(cands2)} candidates")
    k7_ms, k7_plain_ms, k7_mism, k7_launch, nb, ops = 0.0, 0.0, 0, 0, 0, 0
    for singleton in (False, True):
        reset_launches()
        t0 = time.monotonic()
        lane_verdicts = S.prefix_feasibility(w2.kube, w2.cluster, w2.cloud, cands2, singleton=singleton, device=dev)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        k7_launch += K.LAUNCHES["scan_lanes"] + K.LAUNCHES["scan_lanes_relax"]
        log(f"scan_lanes main path ({'singleton' if singleton else 'prefix'}): {dt:.3f}s host, "
            f"path={S.last_sweep['path']}, steps={S.last_sweep['steps']}, launches={dict(K.LAUNCHES)}, "
            f"feasible {sum(lane_verdicts)}/{len(cands2)}: {''.join('1' if v else '0' for v in lane_verdicts)}")
        if S.last_sweep["path"] != "sweep_vmap" or K.LAUNCHES["scan_lanes"] + K.LAUNCHES["scan_lanes_relax"] != 1:
            return None
        u2 = S.build_union(w2.kube, w2.cluster, w2.cloud, cands2, device=dev)
        st_b, xs, valid_b, lane_pods, relax = S.lane_scan_args(w2.cluster, cands2, u2, singleton)
        got = K.scan_lanes(u2.tb, st_b, xs, valid_b, relax)
        xs_c = cut_positions(xs, LANE_CHECK_POSITIONS, axis=0)
        valid_c = valid_b[:, :LANE_CHECK_POSITIONS].contiguous()
        got_c = K.scan_lanes(u2.tb, st_b, xs_c, valid_c, relax)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = K.scan_lanes_plain(u2.tb, st_b, xs_c, valid_c, relax)
        end.record()
        torch.cuda.synchronize()
        k7_plain_ms += start.elapsed_time(end)
        bad_fields = lanes_mismatches(got_c, want)
        log(f"K7 scan_lanes ({'singleton' if singleton else 'prefix'}; B={valid_b.shape[0]}, P={valid_b.shape[1]}, "
            f"E={st_b.eavail.shape[1]}, N={st_b.active.shape[1]}, relax={relax}): mismatched {bad_fields or 'nothing'} "
            f"vs plain on the first {LANE_CHECK_POSITIONS} positions ({start.elapsed_time(end):.1f} ms plain)")
        k7_mism += len(bad_fields)
        if bad_fields:
            return None
        k7_ms += cuda_ms(lambda: K.scan_lanes(u2.tb, st_b, xs, valid_b, relax), 3)
        # (the K7 row is appended after both lane kinds, at this index)
        profiled.append((len(rows_out), lambda a=(u2.tb, st_b, xs, valid_b, relax): K.scan_lanes(*a), 3,
                         ("scan_lanes_kernel",)))
        # each lane reads the shared tables and batch and reads and writes
        # its own State once
        nb += nbytes(u2.tb, xs, valid_b) + 2 * nbytes(st_b) + nbytes(got[1], got[2])
        ops += int(valid_b.sum()) * st_b.eavail.shape[1] * (u2.tb.va.full_mask.shape[0] + u2.tb.va.num_keys)
        t0 = time.monotonic()
        if singleton:
            lanes = list(range(len(cands2)))
        else:
            # every prefix lane up to PAST_EDGE past the last verdict change
            # (a deep prefix lane's referee call is long), and seeded ones
            v = lane_verdicts
            edge = max([k for k in range(1, len(v)) if v[k] != v[k - 1]], default=0)
            lanes = sorted(set(range(min(len(v), edge + 1 + PAST_EDGE))) | set(referee_lanes(v, 4, seed=11)))
        rows = [(k, [j == k if singleton else j <= k for j in range(len(cands2))]) for k in lanes]
        bad = referee_mismatches(w2, cands2, rows, lane_verdicts)
        log(f"referee, lane world ({'singleton' if singleton else 'prefix'}): {len(rows)} lanes checked, "
            f"{len(bad)} disagree ({time.monotonic() - t0:.1f}s host)")
        if bad:
            return None
    b_ms, b_by = bound(nb, ops)
    log(f"K7 scan_lanes prefix + singleton: kernel {k7_ms:.3f} ms, plain {k7_plain_ms:.1f} ms, "
        f"bound {b_ms:.6f} ms ({b_by})")
    rows_out.append(dict(row("scan_lanes", "scan_lanes.cu", "karpenter_tpu/controllers/disruption/sweep.py:690",
                             k7_launch, k7_mism, k7_ms, k7_plain_ms, b_ms, b_by),
                         plain_positions=LANE_CHECK_POSITIONS))

    if not spread_referee_check(dev, worlds.pop(0)):
        return None

    # the kernels' own device time, from profiler traces taken after every
    # check, so that no trace overlaps the host timings above
    for i, fn, reps, names in profiled:
        split = device_split(fn, reps, names)
        if split:
            rows_out[i]["device_ms"] = rows_out[i].get("device_ms", 0.0) + sum(split.values())
            for k, v in split.items():
                rows_out[i].setdefault("device_ms_split", {})[k] = rows_out[i].get("device_ms_split", {}).get(k, 0.0) + v
    log("device time by the profiler (ms): " + json.dumps({r["name"]: r.get("device_ms") for r in rows_out}))
    log("device time by kernel, cache launch and lane launch apart (ms): "
        + json.dumps({r["name"]: r.get("device_ms_split") for r in rows_out}))
    log(f"sweep phase: {time.monotonic() - t_phase:.1f}s")
    return rows_out


def launch_counts() -> dict:
    """Every kernel wrapper's launch count since reset_launches(), the
    non-zero ones."""
    from karpenter_tpu_torch.controllers.disruption import setsweep as SS
    from karpenter_tpu_torch.controllers.disruption import sweep as S
    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver import tpu_runs as KR

    return {k: v for counts in (S.LAUNCHES, SS.LAUNCHES, T.LAUNCHES, K.LAUNCHES, KR.LAUNCHES) for k, v in counts.items() if v}


def fleet_digest(world) -> tuple:
    """The fleet's state as the consolidation controllers read it: each
    state node, whether it is being deleted, its pods; the pending pods."""
    c = world.cluster
    nodes = tuple(
        (sn.name, sn.marked_for_deletion, sn.deleting(), tuple(sorted(p.name for p in c.pods_on(sn.name))))
        for sn in c.state_nodes()
    )
    return nodes, tuple(sorted(p.name for p in world.kube.pending_pods()))


def command_view(cmd) -> tuple:
    """A Command as the consolidation phase compares it: candidate names in
    order, decision, each replacement's instance type names in order."""
    return (
        tuple(c.name for c in cmd.candidates), cmd.decision,
        tuple(tuple(it.name for it in r.instance_type_options) for r in cmd.replacements),
    )


def live_nodes(world) -> set:
    """Nodes neither marked for deletion nor deleting."""
    return {sn.name for sn in world.cluster.state_nodes()
            if sn.node is not None and not (sn.marked_for_deletion or sn.deleting())}


def single_node_world():
    """The fleet of the consolidation phase's check (c): the c4 shape at
    SINGLE_NODES nodes (host work: main builds it while nvcc runs)."""
    from karpenter_tpu_torch.testing.fixtures import underutilized_world

    return underutilized_world(SINGLE_NODES, seed=7, n_pending=SWEEP_PENDING)


def consolidation_phase(dev, w, digest, w_single) -> Optional[dict]:
    """The consolidation controllers on the card at the c4 width, on the
    sweep phase's c4 fleet `w` (held unchanged to `digest`, its state
    before the sweep phase): 2000 nodes, 100 candidates, 20 pending pods.

    (a) MultiNodeConsolidation(sweep="sets"): a Command, K8 launched, its
        removal feasible for the referee, its savings >= the batched rung's;
    (b) the batched rung (K6) against the binary search on the oracle;
    (c) SingleNodeConsolidation against its force_oracle sequential walk,
        on `w` (2000 candidates: no sweep) and on `w_single`
        (single_node_world(): one K6 singleton launch over every
        candidate);
    (d) (a)'s Command rebuilt by compute_consolidation with
        Options(tpu_min_pods=0), the simulation on K1, K3 or K2, K4 and K5
        (K5 runs from _DEDUP_DECODE_MIN claim slots up: lowered to 1 here),
        against the default route's;
    (e) a DisruptionController round trip: propose; validate after the TTL
        and start; with the replacements initialized by hand (the port has
        no lifecycle controller yet), delete the originals. The cluster
        then has as many fewer live nodes as the Command removed, and
        every pod is bound to a live node or waits for the next round.

    Each main path with its launch counts reset just before and read just
    after. Returns {"launches": totals over the main paths, "seconds": the
    phase's}, or None when a check failed."""
    import torch

    from karpenter_tpu_torch.api.objects import COND_INITIALIZED
    from karpenter_tpu_torch.controllers.disruption import consolidation as CN
    from karpenter_tpu_torch.controllers.disruption import setsweep as SS
    from karpenter_tpu_torch.controllers.disruption.controller import DisruptionController
    from karpenter_tpu_torch.controllers.disruption.helpers import simulate_scheduling
    from karpenter_tpu_torch.controllers.disruption.queue import VALIDATION_TTL_SECONDS
    from karpenter_tpu_torch.controllers.disruption.types import command_savings
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.options import Options
    from karpenter_tpu_torch.solver import tpu as T

    t_phase = time.monotonic()
    total: dict = {}
    bad: list = []

    def main_path(label, fn):
        reset_launches()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        counts = launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        log(f"consolidation {label}: {dt:.3f}s host, launches={counts}")
        return out, counts

    def show(label, cmd):
        log(f"consolidation {label}: {cmd.decision}, {len(cmd.candidates)} nodes removed, "
            f"{len(cmd.replacements)} replacement(s), {command_savings(cmd):.6f} $/h saved")

    if fleet_digest(w) != digest:
        log("consolidation phase: the sweep phase changed the c4 fleet")
        return None
    args = (w.kube, w.cluster, w.cloud, w.clock)

    # (a) the sets rung (K8)
    cmds, n = main_path("(a) MultiNodeConsolidation(sweep='sets')",
                        CN.MultiNodeConsolidation(*args, sweep="sets", device=dev).compute_commands)
    log(f"consolidation (a) last_search_stats: {json.dumps(SS.last_search_stats)}")
    if not cmds or n.get("set_sweep", 0) < 1:
        log("consolidation (a): no Command, or K8 not launched")
        return None
    cmd_a = cmds[0]
    show("(a)", cmd_a)
    t0 = time.monotonic()
    sim = simulate_scheduling(w.kube, w.cluster, w.cloud, cmd_a.candidates, force_oracle=True)
    referee_ok = sim.all_pods_scheduled() and len(sim.non_empty_new_claims()) <= 1
    log(f"consolidation (a) referee: removal {'feasible' if referee_ok else 'INFEASIBLE'} "
        f"({time.monotonic() - t0:.1f}s host)")
    if not referee_ok:
        bad.append("(a) referee")

    # (b) the batched rung (K6) against the binary search on the oracle
    cmds_b, n = main_path("(b) MultiNodeConsolidation(sweep='batched')",
                          CN.MultiNodeConsolidation(*args, sweep="batched", device=dev).compute_commands)
    t0 = time.monotonic()
    cmds_bin = CN.MultiNodeConsolidation(*args, sweep="binary", force_oracle=True).compute_commands()
    log(f"consolidation (b) binary search on the oracle: {time.monotonic() - t0:.1f}s host")
    if not cmds_b or n.get("fast_sweep", 0) < 1 or [command_view(c) for c in cmds_b] != [
        command_view(c) for c in cmds_bin
    ]:
        bad.append("(b) batched against binary")
    else:
        show("(b) batched = binary", cmds_b[0])
        if command_savings(cmd_a) < command_savings(cmds_b[0]):
            bad.append("(a) savings below the batched rung's")

    # (c) single-node against the sequential walk: on the c4 fleet (more
    # candidates than lanes: no sweep), then one singleton launch
    for label, world, lanes in (("c4 fleet", w, 0), (f"{SINGLE_NODES}-node fleet", w_single, 1)):
        a = (world.kube, world.cluster, world.cloud, world.clock)
        cmds_c, n = main_path(f"(c) SingleNodeConsolidation, {label}",
                              CN.SingleNodeConsolidation(*a, device=dev).compute_commands)
        t0 = time.monotonic()
        cmds_seq = CN.SingleNodeConsolidation(*a, force_oracle=True).compute_commands()
        log(f"consolidation (c) sequential walk on the oracle, {label}: {time.monotonic() - t0:.1f}s host")
        if n.get("fast_sweep_singleton", 0) != lanes or not cmds_c or [command_view(c) for c in cmds_c] != [
            command_view(c) for c in cmds_seq
        ]:
            bad.append(f"(c) single-node against the sequential walk, {label}")
        else:
            show(f"(c) single-node = sequential, {label}", cmds_c[0])

    # (d) (a)'s Command with the simulation on the kernels
    kernels_route = CN.MultiNodeConsolidation(*args, options=Options(tpu_min_pods=0), device=dev)
    dedup_min = T._DEDUP_DECODE_MIN
    T._DEDUP_DECODE_MIN = 1
    try:
        cmd_d, n = main_path("(d) compute_consolidation, tpu_min_pods=0",
                             lambda: kernels_route.compute_consolidation(cmd_a.candidates))
    finally:
        T._DEDUP_DECODE_MIN = dedup_min
    k_step = n.get("run_step", 0) + n.get("run_step_relax", 0) + n.get("scan_step", 0) + n.get("scan_step_relax", 0)
    if command_view(cmd_d) != command_view(cmd_a) or abs(command_savings(cmd_d) - command_savings(cmd_a)) > 1e-12:
        bad.append("(d) the kernel route's Command")
    if min(n.get(k, 0) for k in ("typeok_screen", "run_arrays", "dedup_rows")) < 1 or not k_step:
        bad.append("(d) kernel launches")
    if tpu_errors():
        bad.append("(d) tpu_error")

    # (e) the controller's round trip
    before = live_nodes(w)
    prov = Provisioner(w.kube, w.cluster, w.cloud, w.clock, device=dev)
    ctrl = DisruptionController(w.kube, w.cluster, w.cloud, prov, w.clock, device=dev)
    t_e = time.monotonic()
    main_path("(e) reconcile 1 (propose)", ctrl.reconcile)
    proposal = ctrl._pending_validation[1] if ctrl._pending_validation else None
    if proposal is None or command_view(proposal) != command_view(cmd_a):
        bad.append("(e) proposal")
        log(f"consolidation phase: {time.monotonic() - t_phase:.1f}s; failed: {', '.join(bad)}")
        return None
    w.clock.advance(VALIDATION_TTL_SECONDS)
    started, _ = main_path("(e) reconcile 2 (validate, start)", ctrl.reconcile)
    if started is None or command_view(started) != command_view(cmd_a):
        bad.append("(e) validation")
        log(f"consolidation phase: {time.monotonic() - t_phase:.1f}s; failed: {', '.join(bad)}")
        return None
    new_claims = list(ctrl.queue.in_flight[0].replacement_names)
    # the lifecycle controller's part (not yet ported): the replacements
    # launch, register and initialize
    for name in new_claims:
        claim = w.kube.get("NodeClaim", name)
        claim.status.conditions[COND_INITIALIZED] = "True"
        w.kube.update("NodeClaim", claim)
    w.clock.advance(2.0)
    main_path("(e) reconcile 3 (delete the originals)", ctrl.reconcile)
    removed = {c.name for c in started.candidates}
    after = live_nodes(w)
    deleting = {c.name for c in w.kube.list("NodeClaim") if c.metadata.deletion_timestamp is not None}
    waiting = {p.name for p in prov.get_pending_pods() + prov._reschedulable_from_deleting_nodes()}
    stray = [p.name for p in w.kube.list("Pod") if p.node_name not in after and p.name not in waiting]
    log(f"consolidation (e): {len(before)} -> {len(after)} live nodes ({len(removed)} removed, "
        f"{len(new_claims)} replacement claim(s) {new_claims}), {len(deleting)} claims deleting, {len(waiting)} pods "
        f"for the next provisioning round, {len(stray)} stray; {time.monotonic() - t_e:.1f}s for the round trip")
    if ctrl.queue.busy or after != before - removed or deleting != {c.claim_name() for c in started.candidates}:
        bad.append("(e) deletions")
    riders = {p.name for c in started.candidates for p in c.reschedulable_pods}
    if stray or not riders <= waiting:
        bad.append("(e) pods")
    if tpu_errors():
        bad.append("tpu_error")
    seconds = time.monotonic() - t_phase
    log(f"consolidation phase: {seconds:.1f}s; launches on its main paths {json.dumps(total)}; "
        f"{'failed: ' + ', '.join(bad) if bad else 'ok'}")
    return None if bad else {"launches": total, "seconds": seconds}


def fleet_world(its, cpu: str, n_pods: int, n_pref: int = 0, n_follow: int = 0) -> World:
    """One fleet lane's problem: n_pods self-spread pods at `cpu` (the
    fixture that forces the scan path), n_pref preference pods from one
    seed and n_follow follower pods (which need a second round), against
    `its` on one default NodePool."""
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.testing import fixtures

    pools = [fixtures.node_pool(name="default")]
    ibp = {"default": its}
    pods = fixtures.make_self_spread_pods(n_pods, cpu)
    if n_pref:
        fixtures.reset_rng(FLEET_PREF_SEED)
        pods += fixtures.make_preference_pods(n_pref)
    pods += fixtures.make_follower_pods(n_follow)
    return World(pools, ibp, pods, None, None, Topology(pools, ibp, pods))


def traced_scheduler(world: World, dev, fleet=None):
    """A TorchScheduler whose `_decode` keeps the solve's per-pod kinds and
    slots (copies) in `.seen` for the checks."""
    from karpenter_tpu_torch.solver.tpu import TorchScheduler

    sched = TorchScheduler(world.pools, world.ibp, world.topo, world.views, None, world.options, device=dev, fleet=fleet)
    decode = sched._decode

    def keep(p, st, kinds, slots, timed_out):
        sched.seen = (kinds.copy(), slots.copy())
        return decode(p, st, kinds, slots, timed_out)

    sched._decode = keep
    return sched


def lane_outcome(sched, res, pods) -> tuple:
    """What a lane must agree on with its solo solve: the decisions, the
    per-pod kinds and slots, and the odometer."""
    odo = sched.last_odometer
    return (results_snapshot(res, pods), sched.seen[0].tobytes(), sched.seen[1].tobytes(),
            (odo["steps"], odo["tier_steps"], tuple(odo["tier_hist"])))


def run_window(worlds: list, dev, captured: list):
    """Solve every world in its own thread through one FleetCoalescer, all
    released by one barrier. Returns (outcomes, schedulers, coalescer,
    wall seconds, launches) or raises when a lane failed or hung. The
    launch counts are set to 0 just before and read just after."""
    import threading

    import torch

    from karpenter_tpu_torch.solver import fleet as F
    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver import tpu_kernel as K

    coalescer = F.FleetCoalescer(window_seconds=FLEET_WINDOW_SECONDS, max_lanes=len(worlds))
    scheds = [traced_scheduler(w, dev, coalescer) for w in worlds]
    outcomes, errors = [None] * len(worlds), []
    barrier = threading.Barrier(len(worlds) + 1)

    def lane(k):
        try:
            barrier.wait(timeout=FLEET_JOIN_SECONDS)
            res = scheds[k].solve(worlds[k].pods)
            outcomes[k] = lane_outcome(scheds[k], res, worlds[k].pods)
        except BaseException as e:  # reported below; the phase fails on it
            errors.append(e)

    real_dispatch = F.fleet_dispatch

    def keep_first(tb, st_b, xs_b, relax=True):
        if not captured:
            captured.append((tb, st_b, xs_b, relax))
        return real_dispatch(tb, st_b, xs_b, relax)

    threads = [threading.Thread(target=lane, args=(k,), daemon=True) for k in range(len(worlds))]
    for t in threads:
        t.start()
    torch.cuda.synchronize()
    reset_launches()
    F.fleet_dispatch = keep_first
    try:
        barrier.wait(timeout=FLEET_JOIN_SECONDS)
        t0 = time.monotonic()
        for t in threads:
            t.join(timeout=FLEET_JOIN_SECONDS)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        F.fleet_dispatch = real_dispatch
    launches = {k: v for counts in (T.LAUNCHES, K.LAUNCHES) for k, v in counts.items()}
    if any(t.is_alive() for t in threads) or errors:
        raise RuntimeError(f"fleet window: lanes hung or failed: {errors}")
    return outcomes, scheds, coalescer, wall, launches


def solo_outcomes(worlds: list, dev) -> tuple[list, float]:
    """Each world solved alone in a fresh TorchScheduler (no coalescer),
    on the scan path through K2; (outcomes, summed wall seconds)."""
    import torch

    from karpenter_tpu_torch.solver import tpu_kernel as K

    outs, total = [], 0.0
    for w in worlds:
        sched = traced_scheduler(w, dev)
        n0 = K.LAUNCHES["scan_step"] + K.LAUNCHES["scan_step_relax"]
        t0 = time.monotonic()
        res = sched.solve(w.pods)
        torch.cuda.synchronize()
        total += time.monotonic() - t0
        if sched.last_used_runs or K.LAUNCHES["scan_step"] + K.LAUNCHES["scan_step_relax"] == n0:
            raise RuntimeError("a fleet lane's solo referee did not run K2")
        outs.append(lane_outcome(sched, res, w.pods))
    return outs, total


def cut_positions(xs, n: int, axis: int = 1):
    """The first n pod positions of a PodX, contiguous: stacked ([B, P,
    ...] fields, axis 1) or one batch (axis 0)."""
    from karpenter_tpu_torch.ops.encode import Reqs

    def cut(a):
        return a.narrow(axis, 0, n).contiguous()

    return type(xs)(*(Reqs(*(cut(a) for a in f)) if isinstance(f, Reqs) else cut(f) for f in xs))


def lanes_at(out, idx: list):
    """A solve_scan_lanes result with its lanes gathered at `idx`."""
    import torch

    def at(x):
        if isinstance(x, tuple):
            return type(x)(*(at(f) for f in x))
        return x[torch.tensor(idx, device=x.device)]

    return tuple(at(x) for x in out)


def lanes_mismatches(got, want) -> list[str]:
    """Fields where two solve_scan_lanes results differ."""
    import torch

    bad = state_mismatches(got[0], want[0])
    bad += [n for n, a, b in zip(("kinds", "slots", "overflow"), got[1:4], want[1:4]) if not torch.equal(a, b)]
    return bad + odometer_mismatches(got[4], want[4])


def fleet_inputs(worlds: list, dev):
    """(tb, st_b, xs_b, relax) of the first round of a window of these
    worlds, assembled as the coalescer assembles it: lane 0's tables, each
    lane's initial State and its pods in FFD order at the window's rung."""
    from karpenter_tpu_torch.solver import epochs
    from karpenter_tpu_torch.solver import fleet as F
    from karpenter_tpu_torch.solver.tpu_problem import _pow2, encode_problem

    lanes = []
    for w in worlds:
        sched, pods = scheduler_for(w, dev)
        problem = encode_problem(sched.oracle, pods)
        order = sched._order_pods(problem)
        tb = sched._tables(problem)
        sched._upload_pod_tables(problem)
        lanes.append((sched, problem, order, tb))
    if len({epochs.table_fingerprint(p) for _, p, _, _ in lanes}) != 1:
        raise RuntimeError("fleet check lanes do not share one table fingerprint")
    n = len(worlds[0].pods)
    N = min(_pow2(max(64, (n + 3) // 4)), _pow2(n))
    P0 = max(_pow2(len(o)) for _, _, o, _ in lanes)
    st_b, xs_b = F.stack_lanes(
        [s._init_state(p, N) for s, p, _, _ in lanes],
        [s._pod_xs_with_idx(p, o, pad_to=P0)[0] for s, p, o, _ in lanes],
    )
    return lanes[0][3], st_b, xs_b, bool((lanes[0][1].ntiers_r > 1).any())


def fleet_bound(tb, st_b, xs_b) -> tuple[float, str]:
    """Row 11's bound for a fleet launch: the tables read once; per lane
    the State read and written once, the pod rows read once, kinds and
    slots written; one screen of every (valid pod, existing node) pair."""
    B, P = xs_b.valid.shape
    nb = nbytes(tb) + 2 * nbytes(st_b) + nbytes(xs_b) + 2 * 4 * B * P
    ops = int(xs_b.valid.sum()) * st_b.eavail.shape[1] * (tb.va.full_mask.shape[0] + tb.va.num_keys)
    return bound(nb, ops)


def fleet_phase(dev, its) -> Optional[dict]:
    """Fleet lanes on the card: windows of 2, 5 and 8 concurrent scan-path
    solves (relax off), a window of FLEET_RELAX_LANES lanes with
    preference ladders and a window whose lanes' follower pods requeue
    (every lane at least two rounds), each through
    TorchScheduler(fleet=FleetCoalescer), one thread per lane. Every lane
    must be coalesced (no solo fallback), one K7 launch per round, and
    every lane's decisions, kinds, slots and odometer must equal its solo
    solve through K2 (a requeued lane's steps: its rounds at the window's
    rung); two lanes of the widest window also equal the oracle. The fleet launch is held bit for bit to
    its plain version on each lane's first FLEET_CHECK_POSITIONS positions
    (B=8, relax off and on); an overflowing lane must leave its window and
    equal its solo solve. Measures each window's launch (events and the
    profiler), its wall time against the sum of its solo solves and its
    host phases, and K7 at B=1 against K2 on one lane, with both
    kernels' clock breakdowns there. Returns the kernels-line row, or None
    when a check failed."""
    import torch

    from karpenter_tpu_torch.solver import fleet as F
    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver.oracle import Scheduler

    t_phase = time.monotonic()
    windows = {}
    total_launches, inputs_b8 = 0, None
    specs = [(str(B), B, 0, 0) for B in FLEET_WINDOWS] + [
        (f"{FLEET_RELAX_LANES}+relax", FLEET_RELAX_LANES, FLEET_PREF_PODS, 0),
        (f"{FLEET_FOLLOW[0]}+follow", FLEET_FOLLOW[0], 0, FLEET_FOLLOW[1]),
    ]
    for label, B, n_pref, n_follow in specs:
        make = [lambda k=k: fleet_world(its, f"{k + 1}00m", FLEET_PODS, n_pref, n_follow) for k in range(B)]
        solo, solo_s = solo_outcomes([m() for m in make], dev)
        captured = []
        worlds = [m() for m in make]
        try:
            outcomes, scheds, coalescer, wall, launches = run_window(worlds, dev, captured)
        except RuntimeError as e:
            log(f"fleet window {label}: {e}")
            return None
        modes = [s.last_fleet and s.last_fleet["mode"] for s in scheds]
        rounds = coalescer.last_window.get("rounds")
        lane_rounds = [s.last_fleet and s.last_fleet["rounds"] for s in scheds]
        fleet_launch = launches["fleet_lanes"] + launches["fleet_lanes_relax"]
        P0w = coalescer.last_window.get("P0")

        def differs(k):
            """Lane k against its solo solve; a window's later rounds walk
            the window's rung P0 (the reference's rule), so the steps of a
            requeued lane are its rounds times P0, the solo loop's its own
            rungs."""
            if not n_follow:
                return outcomes[k] != solo[k]
            o, w = outcomes[k], solo[k]
            return o[:3] != w[:3] or o[3][1:] != w[3][1:] or o[3][0] != lane_rounds[k] * P0w

        bad = [k for k in range(B) if differs(k)]
        log(
            f"fleet window {label}: {B} lanes x {FLEET_PODS} self-spread pods (+{n_pref} preference pods), "
            f"modes {modes}, FLEET_SOLVES {F.FLEET_SOLVES}, rounds {rounds} (lanes {lane_rounds}), "
            f"dispatches {F.FLEET_DISPATCHES}, "
            f"launches {launches}; {wall:.3f}s wall against {solo_s:.3f}s for the {B} solo solves; "
            f"lanes differing from their solo solve: {bad or 'none'}"
        )
        if any(m != "coalesced" for m in modes) or F.FLEET_SOLVES != {"coalesced": B, "solo_window": 0, "fallback": 0}:
            log(f"fleet window {label}: a lane was not coalesced; last_fallback_error={coalescer.last_fallback_error!r}")
            return None
        if bad or not rounds or F.FLEET_DISPATCHES["fleet"] != rounds or fleet_launch != rounds:
            return None
        if n_follow and min(lane_rounds) < 2:
            return None  # every lane of this window requeues
        if launches["scan_step"] or launches["scan_step_relax"] or bool(n_pref) != bool(launches["fleet_lanes_relax"]):
            return None  # no lane ran the solo loop, and relax follows the lanes' tiers
        lane_phases = {k: round(sum(s.last_phases[k] for s in scheds), 4) for k in scheds[0].last_phases}
        waits = [round(s.last_fleet["wait_seconds"], 4) for s in scheds]
        log(f"fleet window {label} host phases (s): lanes' sums {json.dumps(lane_phases)}, window "
            f"{json.dumps({k: round(v, 4) for k, v in coalescer.last_window['phases'].items()})}, waits {waits}")
        tb, st_b, xs_b, relax = captured[0]
        ms = cuda_ms(lambda: K.solve_scan_lanes(tb, st_b, xs_b, relax), 3)
        b_ms, b_by = fleet_bound(tb, st_b, xs_b)
        windows[label] = {
            "lanes": B, "rounds": rounds, "lane_rounds": lane_rounds, "P0": int(xs_b.valid.shape[1]),
            "N": int(st_b.active.shape[1]),
            "launch_ms": ms, "bound_ms": b_ms, "bound_by": b_by, "window_s": wall, "solo_sum_s": solo_s,
            "window_phases_s": coalescer.last_window["phases"], "lane_phases_s": lane_phases, "waits_s": waits,
            "_args": (tb, st_b, xs_b, relax),
        }
        total_launches += fleet_launch
        if B == max(FLEET_WINDOWS) and not n_pref:
            inputs_b8 = (tb, st_b, xs_b, relax)
            for k in FLEET_ORACLE_LANES:
                w = fleet_world(its, f"{k + 1}00m", FLEET_PODS)
                t0 = time.monotonic()
                want = results_snapshot(Scheduler(w.pools, w.ibp, w.topo).solve(w.pods), w.pods)
                same = want == outcomes[k][0]
                log(f"fleet lane {k} of {label} vs the oracle: {'equal' if same else 'DIFFERENT'} "
                    f"({len(want[0])} claims, {time.monotonic() - t0:.1f}s)")
                if not same:
                    return None

    # the fleet launch against its plain version, B=8, relax off and on
    mism, plain_ms, ms_cut, cut_bound, cut_args = 0, 0.0, 0.0, None, None
    relax_worlds = [fleet_world(its, f"{k + 1}00m", FLEET_PODS, FLEET_PREF_PODS) for k in range(FLEET_CHECK_LANES)]
    for tb, st_b, xs_b, relax in (inputs_b8, fleet_inputs(relax_worlds, dev)):
        xs_c = cut_positions(xs_b, FLEET_CHECK_POSITIONS)
        got = K.solve_scan_lanes(tb, st_b, xs_c, relax)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        want = K.solve_scan_lanes_plain(tb, st_b, xs_c, relax)
        torch.cuda.synchronize()
        p_ms = (time.monotonic() - t0) * 1e3
        bad = lanes_mismatches(got, want)
        k_ms = cuda_ms(lambda: K.solve_scan_lanes(tb, st_b, xs_c, relax), 3)
        log(f"K7 fleet lanes vs plain (B={xs_c.valid.shape[0]}, first {FLEET_CHECK_POSITIONS} positions, "
            f"N={st_b.active.shape[1]}, relax={relax}, tier_steps={got[4].tier_steps.tolist()}): kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.1f} ms, mismatched {bad or 'nothing'}")
        mism += len(bad)
        if bad:
            return None
        if not relax:
            plain_ms, ms_cut, cut_bound, cut_args = p_ms, k_ms, fleet_bound(tb, st_b, xs_c), (tb, st_b, xs_c, relax)
        elif not int(got[4].tier_steps.sum()):
            return None  # the relax check must run the tier loop

    # a launch wider than K7's lane table runs as consecutive launches: the
    # widest window's 8 lanes repeated past the table's width, each lane
    # held to the 8-lane launch on the first FLEET_WIDE_POSITIONS positions
    tb, st_b, xs_b, relax = inputs_b8
    xs_c = cut_positions(xs_b, FLEET_WIDE_POSITIONS)
    width = K._scan_lanes_library()[0].scan_lanes_max_lanes()
    idx = [k % FLEET_CHECK_LANES for k in range(width + FLEET_CHECK_LANES)]
    wide = K.solve_scan_lanes(tb, *(K.stack_lanes([K.lane_slice(t, k) for k in idx]) for t in (st_b, xs_c)), relax)
    narrow = K.solve_scan_lanes(tb, st_b, xs_c, relax)
    torch.cuda.synchronize()
    bad = lanes_mismatches(wide, lanes_at(narrow, idx))
    log(f"K7 over {len(idx)} lanes (a lane table of {width}) vs the {FLEET_CHECK_LANES}-lane launch, first "
        f"{FLEET_WIDE_POSITIONS} positions: mismatched {bad or 'nothing'}")
    if bad:
        return None

    # an overflowing lane leaves its window and equals its solo solve
    n_over, profiles = FLEET_OVERFLOW
    small = _small_types((2, 8))
    solo, _ = solo_outcomes([fleet_world(small, cpu, n_over) for cpu in profiles], dev)
    outcomes, scheds, coalescer, _, launches = run_window([fleet_world(small, cpu, n_over) for cpu in profiles], dev, [])
    modes = [s.last_fleet["mode"] for s in scheds]
    log(f"fleet overflow window: {len(profiles)} lanes x {n_over} pods at {profiles}: modes {modes}, "
        f"FLEET_SOLVES {F.FLEET_SOLVES}, launches {launches}, equal to solo: {[o == w for o, w in zip(outcomes, solo)]}")
    if modes != ["coalesced"] * (len(profiles) - 1) + ["fallback"] or outcomes != solo:
        return None
    if coalescer.last_fallback_error is not None or not launches["scan_step"]:
        return None

    # K7 at B=1 against K2 on the same lane (lane 0 of the widest window),
    # then K7 over the window's first b lanes, in turns with K2
    tb, st_b, xs_b, _ = inputs_b8
    st0, xs0 = K.lane_slice(st_b, 0), K.lane_slice(xs_b, 0)
    st1, xs1 = K.stack_lanes([st0]), K.stack_lanes([xs0])
    got1 = K.solve_scan_lanes(tb, st1, xs1)
    got2 = K.solve_scan(tb, st0, xs0)
    same = torch.equal(got1[1][0], got2[1]) and torch.equal(got1[2][0], got2[2]) and not state_mismatches(
        K.lane_slice(got1[0], 0), got2[0])
    k7_one = cuda_ms(lambda: K.solve_scan_lanes(tb, st1, xs1), 3)
    k2_one = cuda_ms(lambda: K.solve_scan(tb, st0, xs0), 3)
    k7_one_dev = device_ms(lambda: K.solve_scan_lanes(tb, st1, xs1), 3, ("scan_lanes_kernel",))
    k2_one_dev = device_ms(lambda: K.solve_scan(tb, st0, xs0), 3, ("scan_step_kernel",))
    log(f"K7 at B=1 vs K2 on lane 0 (P={xs0.valid.shape[0]}, N={st0.active.shape[0]}): K7 {k7_one:.3f} ms "
        f"(device {k7_one_dev}), K2 {k2_one:.3f} ms (device {k2_one_dev}); outputs {'equal' if same else 'DIFFERENT'}")
    if not same:
        return None
    # their per-phase clock breakdowns on that lane, each profiled launch
    # held bit for bit to the launch without it
    breakdowns = {}
    for label, kernel, launch, differ in (
        ("K7 one lane", "scan_lanes", lambda p: K.solve_scan_lanes(tb, st1, xs1, prof=p), lanes_mismatches),
        ("K2 same lane", "scan_step", lambda p: K.solve_scan(tb, st0, xs0, prof=p), scan_mismatches),
    ):
        bd, bad = clock_breakdown(kernel, [launch], differ, dev)
        log(f"clock breakdown {label} ({kernel}; profiled vs plain launch: {bad or 'equal'}): {json.dumps(bd)}")
        if bad:
            return None
        breakdowns[label] = {"cycles": bd["cycles"], "ms": bd["ms"], "clock_mhz": bd["clock_mhz"]}
    sweep = []
    for b in (0, 1, 2, 4, 8, 1, 0):  # 0: K2 on lane 0
        if b:
            args = (tb, *(K.stack_lanes([K.lane_slice(t, k) for k in range(b)]) for t in (st_b, xs_b)))
            sweep.append((f"K7 x{b}", device_ms(lambda: K.solve_scan_lanes(*args), 3, ("scan_lanes_kernel",))))
        else:
            sweep.append(("K2", device_ms(lambda: K.solve_scan(tb, st0, xs0), 3, ("scan_step_kernel",))))
    log("device ms in turns, lanes 0..b-1 of the widest window: " + json.dumps(sweep))

    # the launches' own device time, after every check
    for w in windows.values():
        w["device_ms"] = device_ms(lambda a=w.pop("_args"): K.solve_scan_lanes(*a), 3, ("scan_lanes_kernel",))
    log("fleet windows: " + json.dumps(windows))
    # ms, plain_ms, bound_ms and device_ms: the relax-off check's launch (B=8,
    # the first FLEET_CHECK_POSITIONS positions); each window's own launch
    # under "windows"
    out = dict(
        row("fleet_lanes", "scan_lanes.cu", "karpenter_tpu/solver/fleet.py:164", total_launches, mism,
            ms_cut, plain_ms, *cut_bound),
        device_ms=device_ms(lambda: K.solve_scan_lanes(*cut_args), 3, ("scan_lanes_kernel",)), windows=windows,
        k7_b1_vs_k2={"k7_ms": k7_one, "k2_ms": k2_one, "k7_device_ms": k7_one_dev, "k2_device_ms": k2_one_dev,
                     "in_turns_device_ms": sweep, "breakdown": breakdowns},
    )
    log(f"fleet phase: {time.monotonic() - t_phase:.1f}s")
    return out


def entry_cluster(n_pods: int, n_pvc: int, its, dev, force_oracle: bool = False):
    """A port SimKube with one default NodePool and a KWOK provider holding
    `its`; pending: the c6 mix at n_pods, then n_pvc pods with the mix's
    requests, each with its own PVC of a StorageClass in ENTRY_ZONE. Returns
    the Provisioner (Options(tpu_min_pods=0) on `dev`, or the oracle's)."""
    from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_tpu_torch.controllers.kube import FakeClock, SimKube
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.controllers.state import Cluster, wire_informers
    from karpenter_tpu_torch.options import Options
    from karpenter_tpu_torch.testing import fixtures

    clock = FakeClock()
    kube = SimKube(clock)
    cluster = Cluster(clock)
    wire_informers(kube, cluster)
    cloud = KwokCloudProvider(kube, clock, instance_types=its)
    kube.create("NodePool", fixtures.node_pool(name="default"))
    create_entry_pods(kube, n_pods, n_pvc)
    return Provisioner(kube, cluster, cloud, clock, Options(tpu_min_pods=0), force_oracle=force_oracle,
                       device=None if force_oracle else dev)


def create_entry_pods(kube, n_pods: int, n_pvc: int) -> None:
    """The entry cluster's pending pods in `kube`: the c6 mix at n_pods
    (named c6-<i>), then n_pvc pods with the mix's requests, each with its
    own PVC of a StorageClass in ENTRY_ZONE."""
    from karpenter_tpu_torch.api.objects import PersistentVolumeClaim, StorageClass
    from karpenter_tpu_torch.testing import fixtures

    pods = c6_pods(n_pods)
    for i, p in enumerate(pods):  # the mix's families reuse names; the store keys on them
        p.metadata.name = f"c6-{i}"
    sc = StorageClass()
    sc.metadata.name = "zonal"
    sc.zones = [ENTRY_ZONE]
    kube.create("StorageClass", sc)
    for i in range(n_pvc):
        pvc = PersistentVolumeClaim(storage_class_name="zonal")
        pvc.metadata.name = f"data-{i}"
        kube.create("PersistentVolumeClaim", pvc)
        p = fixtures.pod(name=f"stateful-{i}")
        p.requests = dict(pods[i].requests)
        p.volume_claims = [pvc.metadata.name]
        pods.append(p)
    for p in pods:
        kube.create("Pod", p)


def tpu_errors() -> float:
    """The guard's count: kernel solves that raised and were re-solved on a
    pristine oracle (any is a failure of the run)."""
    from karpenter_tpu_torch.solver.hybrid import SOLVE_FALLBACKS

    return SOLVE_FALLBACKS.value({"reason": "tpu_error"})


def _opening(claim) -> int:
    """A solve's claim by the order it was opened (its synthetic hostname's
    sequence number)."""
    return int(claim.hostname.rsplit("-", 1)[1])


def solve_partition(solve, oracle, pods, ignore_preferences: bool):
    """The referee's rule for a kernel route: `solve` (an oracle Scheduler's
    solve, or a wrapper of it) on the pods the kernels take
    (`pod_unsupported_reason` None) first, their claims then put in the order
    they were opened (the order the kernels' decode returns them; the
    oracle's last sort by pod count, scheduler.go:499, leaves them
    otherwise), then the rest continued on the same `oracle`, as
    TorchHybridScheduler continues them after the kernels. An oracle-only
    solve interleaves the two sets in FFD order instead, so where both are
    present its decisions may legally differ (the JAX package's hybrid
    differs from its oracle the same way)."""
    from karpenter_tpu_torch.solver.tpu_problem import pod_unsupported_reason

    ok = [pod_unsupported_reason(p, ignore_preferences) is None for p in pods]
    supported = [p for p, o in zip(pods, ok) if o]
    rest = [p for p, o in zip(pods, ok) if not o]
    if not supported or not rest:
        out = solve(pods)
        if supported:
            oracle.new_node_claims.sort(key=_opening)
        return out
    first = solve(supported)
    oracle.new_node_claims.sort(key=_opening)
    cont = solve(rest)
    cont.pod_errors.update(first.pod_errors)
    cont.timed_out = cont.timed_out or first.timed_out
    return cont


def solve_partitioned_oracle(pools, ibp, pods, views, daemonset_pods, options, cluster):
    """The referee of a kernel route: the port's oracle on the hybrid's
    partition (solve_partition)."""
    from karpenter_tpu_torch.solver.oracle import Scheduler
    from karpenter_tpu_torch.solver.topology import Topology

    topology = Topology(pools, ibp, pods, cluster=cluster, state_node_views=views,
                        ignore_preferences=options.ignore_preferences)
    oracle = Scheduler(pools, ibp, topology, views, daemonset_pods, options)
    return solve_partition(oracle.solve, oracle, pods, options.ignore_preferences)


def partition_view(r, pods) -> tuple:
    """A solve's claims with the stateful (PVC) pods set apart: each claim
    keyed by its nodepool and its other pods' sorted names, valued by its
    instance types and requests (None where it holds a stateful pod); the
    stateful pods' claims' zones; the failed pods. Where the oracle
    continues a stateful pod among claims that fit it equally depends on
    the claims' order, which the kernels' decode and the oracle leave
    differently."""
    from karpenter_tpu_torch.api import labels as well_known

    name = {p.uid: p.name for p in pods}
    claims, zones = {}, {}
    for c in r.new_node_claims:
        names = sorted(name[p.uid] for p in c.pods)
        stateful = [n for n in names if n.startswith("stateful-")]
        key = (tuple(n for n in names if n not in stateful), c.template.nodepool_name)
        if key[0]:  # a claim of stateful pods alone is keyed by nothing the two sides share
            claims[key] = None if stateful else (
                tuple(sorted(it.name for it in c.instance_type_options)), tuple(sorted(c.requests.items())))
        zone = tuple(sorted(c.requirements.get(well_known.TOPOLOGY_ZONE_LABEL_KEY).values))
        zones.update((n, zone) for n in stateful)
    return claims, zones, tuple(sorted(name[u] for u in r.pod_errors))


def partition_mismatches(got, want) -> list[str]:
    """Where two partition views disagree: the claims' pod sets, the
    instance types and requests of claims that hold no stateful pod on
    either side, which stateful pods were placed, the failed pods."""
    bad = []
    if set(got[0]) != set(want[0]):
        bad.append(f"claims ({len(set(got[0]) ^ set(want[0]))} pod sets differ)")
    diff = [k for k in set(got[0]) & set(want[0]) if None not in (got[0][k], want[0][k]) and got[0][k] != want[0][k]]
    if diff:
        bad.append(f"instance types or requests of {len(diff)} claims")
    if set(got[1]) != set(want[1]):
        bad.append("stateful pods placed")
    if got[2] != want[2]:
        bad.append("failed pods")
    return bad


def claims_view(claims) -> list:
    """Created NodeClaims as two reconciles of one cluster must agree on
    them: each claim's JSON without what a round names on its own (the
    object's name, uid, version and creation time, the synthetic hostname)."""
    from karpenter_tpu_torch.api import codec
    from karpenter_tpu_torch.api import labels as well_known

    out = []
    for c in claims:
        d = codec.to_jsonable(c)
        for k in ("name", "uid", "resource_version", "creation_timestamp"):
            d["metadata"].pop(k, None)
        d["metadata"]["labels"].pop(well_known.HOSTNAME_LABEL_KEY, None)
        for r in d["requirements"]:
            if r["key"] == well_known.HOSTNAME_LABEL_KEY:
                r["values"] = []
        out.append(json.dumps(d, sort_keys=True))
    return sorted(out)


def entry_point_phase(dev, its) -> Optional[dict]:
    """The provisioning entry point at full width: Provisioner.reconcile ->
    schedule -> solve_in_process -> TorchHybridScheduler.solve (the c6 mix
    on K1, K3, K4 and K5, the PVC tail continued on the oracle) ->
    create_node_claims. None on any failed check."""
    import torch

    from karpenter_tpu_torch.api import labels as well_known
    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver import tpu_runs as KR

    t_phase = time.monotonic()
    n_total = C6_PODS + ENTRY_PVC_PODS

    def reconcile(prov):
        t0 = time.monotonic()
        result = prov.reconcile(ignore_batcher=True)
        torch.cuda.synchronize()
        return result, time.monotonic() - t0

    t0 = time.monotonic()
    prov = entry_cluster(C6_PODS, ENTRY_PVC_PODS, its, dev)
    log(f"entry point: cluster of {n_total} pending pods built in {time.monotonic() - t0:.1f}s (host)")
    reconcile(prov)  # warm-up
    prov = entry_cluster(C6_PODS, ENTRY_PVC_PODS, its, dev)
    reset_launches()
    result, dt = reconcile(prov)
    launches = {k: v for counts in (T.LAUNCHES, K.LAUNCHES, KR.LAUNCHES) for k, v in counts.items() if v}
    h = prov.last_scheduler
    res = result.results
    claims = [c for c in res.new_node_claims if c.pods]
    placed = sum(len(c.pods) for c in claims) + sum(len(n.pods) for n in res.existing_nodes)
    continued = f"{ENTRY_PVC_PODS} pod(s) continued on the oracle: pod volume claims"
    pvc_zones = {
        p.name: sorted(c.requirements.get(well_known.TOPOLOGY_ZONE_LABEL_KEY).values)
        for c in claims for p in c.pods if p.name.startswith("stateful-")
    }
    log(
        f"entry point reconcile on {torch.cuda.get_device_name(0)}: {n_total} pods in {dt:.3f}s = "
        f"{n_total / dt:.1f} pods/s; solver={prov.last_solver_used} kind={h.fallback_kind} "
        f"reason={h.fallback_reason!r} claims={len(claims)} created={len(result.created_claims)} "
        f"placed={placed} errors={len(res.pod_errors)} launches={launches} tpu_error={tpu_errors()}"
    )
    bad = []
    if prov.last_solver_used != "tpu" or h.fallback_kind != "partition_continuation" or h.fallback_reason != continued:
        bad.append("route")
    if placed + len(res.pod_errors) != n_total or len(result.created_claims) != len(claims):
        bad.append("placements or claims")
    if len(pvc_zones) != ENTRY_PVC_PODS or any(z != [ENTRY_ZONE] for z in pvc_zones.values()):
        bad.append(f"PVC pods' zones ({len(pvc_zones)} placed)")
    if min(launches.get(k, 0) for k in ("typeok_screen", "run_arrays", "dedup_rows")) < 1 or not (
        launches.get("run_step", 0) + launches.get("run_step_relax", 0)
    ):
        bad.append("kernel launches")
    if tpu_errors():
        bad.append("tpu_error")
    # the Provisioner's pod order (`kube.list`) is the mix's, so the kernel
    # odometer is the JAX package's for the c6 mix
    odo = {k: h.tpu.last_odometer[k] for k in C6_JAX_ODOMETER}
    odo_diff = {k: (odo[k], v) for k, v in C6_JAX_ODOMETER.items() if odo[k] != v}
    log(f"entry point odometer: {json.dumps(odo)}; vs the JAX package's c6: "
        f"{'equal' if not odo_diff else f'DIFFERENT {odo_diff}'}")
    if odo_diff:
        bad.append("odometer")
    times = [dt]
    phases = [dict(prov.last_phases)]
    for _ in range(ENTRY_TIMED - 1):
        prov = entry_cluster(C6_PODS, ENTRY_PVC_PODS, its, dev)
        _, dt = reconcile(prov)
        times.append(dt)
        phases.append(dict(prov.last_phases))
    med = sorted(times)[len(times) // 2]
    log(f"entry point reconcile seconds (n={len(times)}): {[round(x, 4) for x in times]}; median {med:.4f}s = "
        f"{n_total / med:.1f} pods/s")
    log("entry point host phases (s), the median run: "
        + json.dumps({k: round(v, 4) for k, v in phases[times.index(med)].items()}))
    if tpu_errors():
        bad.append("tpu_error")
    log(f"entry point phase: {time.monotonic() - t_phase:.1f}s; {'failed: ' + ', '.join(bad) if bad else 'ok'}")
    return None if bad else {"pods": n_total, "median_s": med, "pods_per_s": n_total / med, "launches": launches,
                             "claims_view": claims_view(result.created_claims)}


def decisions_phase(dev, its) -> bool:
    """The card's Provisioner on DECISIONS_PODS against the oracle's
    decisions for the same partition (`solve_partitioned_oracle` on a twin
    cluster's solve inputs): equal claims (`partition_view`), every
    stateful pod in ENTRY_ZONE, and a NodeClaim for every non-empty claim.
    An oracle-only Provisioner interleaves the stateful pods in FFD order,
    so it may legally decide differently (the reference's does too)."""
    import torch

    t_phase = time.monotonic()
    n, n_pvc = DECISIONS_PODS
    prov = entry_cluster(n, n_pvc, its, dev)
    t0 = time.monotonic()
    result = prov.reconcile(ignore_batcher=True)
    torch.cuda.synchronize()
    card_s = time.monotonic() - t0
    card = partition_view(result.results, prov.kube.list("Pod"))
    n_claims = sum(1 for c in result.results.new_node_claims if c.pods)
    twin = entry_cluster(n, n_pvc, its, dev, force_oracle=True)
    t0 = time.monotonic()
    want = partition_view(solve_partitioned_oracle(*twin.scheduler_inputs(twin.get_pending_pods())),
                          twin.kube.list("Pod"))
    orc_s = time.monotonic() - t0
    bad = partition_mismatches(card, want)
    same = not bad
    h = prov.last_scheduler
    ok = same and prov.last_solver_used == "tpu" and h.fallback_kind == "partition_continuation"
    ok = ok and len(result.created_claims) == n_claims and len(card[1]) == n_pvc
    ok = ok and all(z == (ENTRY_ZONE,) for z in card[1].values()) and not tpu_errors()
    log(f"decisions, {n} c6 + {n_pvc} PVC pods: card Provisioner ({prov.last_solver_used}, {h.fallback_kind}, "
        f"{card_s:.2f}s, {len(result.created_claims)} NodeClaims) vs the oracle on its partition ({orc_s:.2f}s): "
        f"{len(card[0])} vs {len(want[0])} claims, {'equal' if same else f'DIFFERENT: {bad}'}; "
        f"phase {time.monotonic() - t_phase:.1f}s")
    return ok


def crossover_phase(dev, its) -> Optional[dict]:
    """solve_in_process on make_generic_pods(n) (requests only) with
    tpu_min_pods=0 on the card against force_oracle=True, per n in
    CROSSOVER_SIZES: the card one warm-up and 3 timed solves, the oracle
    3 timed solves (CROSSOVER_ORACLE_REPS where it is more than 5x slower),
    equal decisions. The crossover is the smallest n from which the card's median
    beats the oracle's at n and every larger n (0 from the first)."""
    import torch

    from karpenter_tpu_torch.solver import solve_in_process
    from karpenter_tpu_torch.solver.oracle import SchedulerOptions
    from karpenter_tpu_torch.testing import fixtures

    t_phase = time.monotonic()
    pools = [fixtures.node_pool(name="default")]
    ibp = {pools[0].name: its}
    table = []
    for n in CROSSOVER_SIZES:
        medians, snaps = {}, {}
        for side, force in (("card", False), ("oracle", True)):
            times = []
            for rep in range(CROSSOVER_ORACLE_REPS.get(n, 3) if force else 4):  # the card's first solve warms it up
                fixtures.reset_rng(42)
                pods = fixtures.make_generic_pods(n)
                t0 = time.monotonic()
                res, sched = solve_in_process(pools, ibp, pods, options=SchedulerOptions(tpu_min_pods=0),
                                              force_oracle=force, device=dev)
                torch.cuda.synchronize()
                if rep or force:
                    times.append(time.monotonic() - t0)
                if sched.used_tpu is force:
                    log(f"crossover n={n}: the {side} side took the other route ({sched.fallback_kind})")
                    return None
            medians[side] = sorted(times)[len(times) // 2]
            snaps[side] = results_snapshot(res, pods)
        same = snaps["card"] == snaps["oracle"]
        table.append({"n": n, "card_s": medians["card"], "oracle_s": medians["oracle"], "equal": same})
        log(f"crossover n={n}: card {medians['card']:.4f}s (median of 3), oracle {medians['oracle']:.4f}s (median of "
            f"{CROSSOVER_ORACLE_REPS.get(n, 3)}), decisions {'equal' if same else 'DIFFERENT'}")
        if not same:
            return None
    wins = [r["card_s"] < r["oracle_s"] for r in table]
    first = next((i for i in range(len(table)) if all(wins[i:])), None)
    crossover = None if first is None else (0 if first == 0 else table[first]["n"])
    log(f"small-batch crossover: {crossover} (card faster from this n on; None: not within {CROSSOVER_SIZES}); "
        f"phase {time.monotonic() - t_phase:.1f}s")
    if tpu_errors():
        return None
    return {"sizes": table, "crossover": crossover}


def sidecar_views(n: int, relabel: int = 0, first: int = 0):
    """n existing nodes of the headline's pool (8 cores, 32 GiB, a third
    of it free, zones in turn) as StateNodeViews, with the ClusterSource
    that names them; node i is "sidecar-<first + i>", and the first
    `relabel` nodes carry one more label."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.objects import Node, ObjectMeta
    from karpenter_tpu_torch.solver.nodes import StateNodeView
    from karpenter_tpu_torch.solver.topology import ClusterSource

    views = []
    for i in range(first, first + n):
        name = f"sidecar-{i}"
        labels = {
            wk.TOPOLOGY_ZONE_LABEL_KEY: ("test-zone-a", "test-zone-b", "test-zone-c")[i % 3],
            wk.HOSTNAME_LABEL_KEY: name, wk.CAPACITY_TYPE_LABEL_KEY: "on-demand", wk.OS_LABEL_KEY: "linux",
            wk.ARCH_LABEL_KEY: "amd64", wk.NODEPOOL_LABEL_KEY: "default",
        }
        if i - first < relabel:
            labels["team"] = "blue"
        gib = 1024**3 * 1000
        views.append(StateNodeView(
            name=name, node_labels=dict(labels), labels=labels,
            available={"cpu": 2700, "memory": 11 * gib, "pods": 110_000},
            capacity={"cpu": 8000, "memory": 32 * gib, "pods": 110_000}, initialized=True,
        ))
    nodes = {v.name: Node(metadata=ObjectMeta(name=v.name, labels=dict(v.labels))) for v in views}
    return views, ClusterSource(pods_by_namespace={}, nodes_by_name=nodes, namespace_labels={"default": {}})


def wire_parts(got: dict, pods) -> tuple:
    """A sidecar answer (wire.decode_result) as results_snapshot reads a
    local one: claims by pod names with their types and requests, the
    existing-node placements, the failed pods."""
    name = {p.uid: p.name for p in pods}
    claims = sorted(
        (tuple(sorted(name[u] for u in c["pod_uids"])), c["nodepool"], tuple(sorted(c["instance_types"])),
         tuple(sorted((k, int(v)) for k, v in c["requests"].items())))
        for c in got["new_node_claims"] if c["pod_uids"]
    )
    existing = {}
    for u, n in got["existing_assignments"].items():
        existing.setdefault(n, []).append(name[u])
    return (claims, sorted((n, tuple(sorted(v))) for n, v in existing.items()),
            tuple(sorted(name[u] for u in got["pod_errors"])), bool(got["timed_out"]))


def sidecar_phase(dev, its, entry_claims: list) -> Optional[dict]:
    """The solver sidecar on the card: the port's SolverServer in this
    process on a unix socket, with a DeviceTableCache, an EpochStore and an
    AdmissionGate, reached by the port's SolverClient at the headline's
    width (make_diverse_pods(HEADLINE_PODS) x HEADLINE_TYPES types):

    (a) a full snapshot with an epoch key equals the in-process
        solve_in_process, through K1, K4, K3 and K5, used_tpu;
    (b) a SOLVE_DELTA of the same batch, no churn: the same answer, the
        table cache's `hit`, no upload bytes, no K1 launch;
    (c) a delta with churn (SIDECAR_CHURN nodes added, removed, relabelled
        on an epoch of SIDECAR_NODES nodes) equals a full snapshot of the
        churned world;
    (d) SIDECAR_LANES concurrent scan-path lanes (make_self_spread_pods(
        FLEET_PODS), a profile each) through a server with a fleet window:
        each lane equals its solo solve, one K7 launch a round;
    (e) a Provisioner(solver=ResilientSolver) reconcile of the entry
        cluster answers from the sidecar with the entry phase's claims;
        with the server stopped, the next reconcile (DECISIONS_PODS)
        degrades in-process to the card and the breaker records it;
    (f) the server-side phases of (a) beside the in-process solve's: the
        wire's own cost; the client's and the server's traces share one
        wire id.

    No solve degrades to the oracle on the server. Returns {launches,
    seconds, upload_bytes, phases}, or None when a check failed."""
    import shutil
    import tempfile
    import threading

    import torch

    from karpenter_tpu_torch import tracing
    from karpenter_tpu_torch.solver import epochs as E
    from karpenter_tpu_torch.solver import fleet as F
    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver.hybrid import SOLVER_FALLBACK, ResilientSolver, solve_in_process
    from karpenter_tpu_torch.solver.service import SolverClient, SolverServer

    t_phase = time.monotonic()
    os.makedirs("build", exist_ok=True)
    sock_dir = os.path.relpath(tempfile.mkdtemp(prefix="sidecar-", dir="build"))  # short: AF_UNIX paths
    bad = []
    srv = SolverServer(os.path.join(sock_dir, "solver.sock"), device=dev, table_cache=E.DeviceTableCache(),
                       epoch_store=E.EpochStore(), admission=E.AdmissionGate(max_inflight=8))
    srv.start()
    fleet_srv = None
    try:
        w = headline_world(HEADLINE_PODS, its)
        client = SolverClient(srv.socket_path, request_timeout=SIDECAR_TIMEOUT)

        def wire_solve(label, pods, views=None, source=None, c=client):
            tr = tracing.new_trace("sidecar_client", side="local")
            t0 = time.monotonic()
            got = c.solve(w.pools, w.ibp, pods, state_node_views=views, cluster=source, trace=tr)
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
            tr.finish("ok")
            server = [t for t in tracing.RING.find(tr.trace_id) if t.side == "server"]
            if len(server) != 1:
                bad.append(f"{label}: {len(server)} server traces share the wire id {tr.trace_id}")
                return got, tr, None, dt
            return got, tr, server[0], dt

        # (a) the full snapshot, with the epoch key
        torch.cuda.synchronize()
        reset_launches()
        got_a, ctr_a, str_a, dt_a = wire_solve("(a)", w.pods)
        launches_a = launch_counts()
        ltr = tracing.new_trace("solve")
        w_local = headline_world(HEADLINE_PODS, its)
        t0 = time.monotonic()
        local, _ = solve_in_process(w_local.pools, w_local.ibp, w_local.pods, device=dev, trace=ltr)
        torch.cuda.synchronize()
        dt_local = time.monotonic() - t0
        ltr.finish("ok")
        parts_a = wire_parts(got_a, w.pods)
        missing = [k for k in ("typeok_screen", "run_arrays", "dedup_rows") if launches_a.get(k, 0) < 1]
        if not launches_a.get("run_step", 0) + launches_a.get("run_step_relax", 0):
            missing.append("run_step")
        cache_a = [s.attrs["outcome"] for s in str_a.spans if s.name == "table_cache"] if str_a else []
        upload_a = str_a.counts.get("upload_bytes", 0) if str_a else 0
        same_a = parts_a == results_snapshot(local, w_local.pods)
        log(f"sidecar (a) full snapshot, {len(w.pods)} pods: {dt_a:.3f}s through the wire "
            f"(in-process {dt_local:.3f}s); used_tpu={got_a['used_tpu']} claims={len(parts_a[0])} "
            f"table_cache={cache_a} upload_bytes={upload_a} launches={launches_a}; "
            f"vs solve_in_process: {'equal' if same_a else 'DIFFERENT'}; missing launches: {missing or 'none'}")
        if not (same_a and got_a["used_tpu"]) or missing or cache_a != ["miss"] or client.full_solves != 1:
            bad.append("(a)")

        # (b) the same batch as a delta of that epoch, no churn
        k1 = T.LAUNCHES["typeok_screen"]
        got_b, _, str_b, dt_b = wire_solve("(b)", w.pods)
        cache_b = [s.attrs["outcome"] for s in str_b.spans if s.name == "table_cache"] if str_b else []
        upload_b = str_b.counts.get("upload_bytes", 0) if str_b else None
        k1_b = T.LAUNCHES["typeok_screen"] - k1
        same_b = wire_parts(got_b, w.pods) == parts_a
        log(f"sidecar (b) same-epoch delta: {dt_b:.3f}s; table_cache={cache_b} upload_bytes={upload_b} "
            f"K1 launches +{k1_b}; delta solves {client.delta_solves}; answer {'equal' if same_b else 'DIFFERENT'}")
        if not same_b or cache_b != ["hit"] or upload_b != 0 or k1_b or client.delta_solves != 1:
            bad.append("(b)")

        # (c) an epoch with existing nodes, then a delta that churns them
        n_add, n_del, n_rel = SIDECAR_CHURN
        views0, src0 = sidecar_views(SIDECAR_NODES)
        wire_solve("(c) base", w.pods, views0, src0)
        views1, src1 = sidecar_views(SIDECAR_NODES - n_del, relabel=n_rel, first=n_del)
        more, more_src = sidecar_views(n_add, first=SIDECAR_NODES)
        views1 += more
        src1.nodes_by_name.update(more_src.nodes_by_name)
        got_c, _, str_c, dt_c = wire_solve("(c) churn", w.pods, views1, src1)
        snap = SolverClient(srv.socket_path, request_timeout=SIDECAR_TIMEOUT, epochs=False)
        got_full, _, _, dt_full = wire_solve("(c) full", w.pods, views1, src1, c=snap)
        snap.close()
        same_c = wire_parts(got_c, w.pods) == wire_parts(got_full, w.pods)
        used = len({n for n, _ in wire_parts(got_c, w.pods)[1]})
        log(f"sidecar (c) churn delta (+{n_add} -{n_del} ~{n_rel} of {SIDECAR_NODES} nodes): {dt_c:.3f}s, "
            f"full snapshot {dt_full:.3f}s; existing nodes used {used}; delta solves {client.delta_solves}, "
            f"resyncs {client.resyncs}; {'equal' if same_c else 'DIFFERENT'}")
        if not same_c or client.delta_solves != 3 or client.resyncs or not used:
            bad.append("(c)")
        client.close()

        # (d) scan-path lanes over the wire through a fleet window
        fleet_srv = SolverServer(os.path.join(sock_dir, "fleet.sock"), device=dev, table_cache=E.DeviceTableCache(),
                                 fleet_window_seconds=FLEET_WINDOW_SECONDS, fleet_max_lanes=SIDECAR_LANES,
                                 admission=E.AdmissionGate(max_inflight=32))
        fleet_srv.start()
        solo = []
        for k in range(SIDECAR_LANES):
            s_, pods_ = scheduler_for(fleet_world(its, f"{k + 1}00m", FLEET_PODS), dev)
            res_ = s_.solve(pods_)
            if s_.last_used_runs:
                bad.append("(d) a solo lane took the runs path")
            solo.append(results_snapshot(res_, pods_))
        lanes = [fleet_world(its, f"{k + 1}00m", FLEET_PODS) for k in range(SIDECAR_LANES)]
        out, errors = [None] * SIDECAR_LANES, []
        barrier = threading.Barrier(SIDECAR_LANES + 1)
        seq0 = tracing.Trace("probe").seq

        def lane(k):
            try:
                c = SolverClient(fleet_srv.socket_path, request_timeout=SIDECAR_TIMEOUT)
                barrier.wait(timeout=FLEET_JOIN_SECONDS)
                out[k] = wire_parts(c.solve(lanes[k].pools, lanes[k].ibp, lanes[k].pods), lanes[k].pods)
                c.close()
            except BaseException as e:  # reported below; the phase fails on it
                errors.append(e)

        threads = [threading.Thread(target=lane, args=(k,), daemon=True) for k in range(SIDECAR_LANES)]
        for t in threads:
            t.start()
        torch.cuda.synchronize()
        reset_launches()
        barrier.wait(timeout=FLEET_JOIN_SECONDS)
        t0 = time.monotonic()
        for t in threads:
            t.join(timeout=FLEET_JOIN_SECONDS)
        torch.cuda.synchronize()
        dt_d = time.monotonic() - t0
        launches_d = launch_counts()
        fleet_srv.stop()
        windows = [s_ for t in tracing.RING.snapshot() if t.seq > seq0 and t.side == "server"
                   for s_ in t.spans if s_.name == "fleet_window"]
        rounds = sorted({s_.attrs.get("rounds") for s_ in windows})
        k7 = launches_d.get("fleet_lanes", 0) + launches_d.get("fleet_lanes_relax", 0)
        lane_bad = [k for k in range(SIDECAR_LANES) if out[k] is None or out[k] != solo[k]]
        log(f"sidecar (d) {SIDECAR_LANES} lanes x {FLEET_PODS} pods over the wire: {dt_d:.3f}s; windows "
            f"{[(s_.attrs.get('mode'), s_.attrs.get('lanes'), s_.attrs.get('rounds')) for s_ in windows]}; "
            f"launches {launches_d}; lanes differing from their solo solve: {lane_bad or 'none'}; errors {errors}")
        if errors or lane_bad or len(windows) != SIDECAR_LANES or len(rounds) != 1:
            bad.append("(d)")
        elif any(s_.attrs.get("mode") != "coalesced" for s_ in windows) or k7 != rounds[0]:
            bad.append("(d) not one K7 launch a round")
        if launches_d.get("scan_step", 0) or launches_d.get("scan_step_relax", 0):
            bad.append("(d) a lane ran solo")

        # (e) the Provisioner through a ResilientSolver, then the server gone
        rs = ResilientSolver(srv.socket_path, request_timeout_seconds=SIDECAR_TIMEOUT, device=dev)
        prov = entry_cluster(C6_PODS, ENTRY_PVC_PODS, its, dev)
        prov.solver = rs
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.monotonic()
        result = prov.reconcile(ignore_batcher=True)
        torch.cuda.synchronize()
        dt_e = time.monotonic() - t0
        launches_e = launch_counts()
        same_e = claims_view(result.created_claims) == entry_claims
        log(f"sidecar (e) Provisioner(solver=ResilientSolver) on {C6_PODS + ENTRY_PVC_PODS} pods: {dt_e:.3f}s; "
            f"solver={prov.last_solver_used} created={len(result.created_claims)} launches={launches_e}; "
            f"claims vs the entry phase's in-process reconcile: {'equal' if same_e else 'DIFFERENT'}")
        if prov.last_solver_used != "sidecar" or not same_e or rs.fallback_reason:
            bad.append("(e) sidecar reconcile")
        srv.stop()
        failed0 = SOLVER_FALLBACK.value({"reason": "sidecar_unavailable"})
        prov2 = entry_cluster(*DECISIONS_PODS, its, dev)
        prov2.solver = rs
        result2 = prov2.reconcile(ignore_batcher=True)
        torch.cuda.synchronize()
        placed2 = sum(len(c.pods) for c in result2.results.new_node_claims) + sum(
            len(n.pods) for n in result2.results.existing_nodes)
        degraded = SOLVER_FALLBACK.value({"reason": "sidecar_unavailable"}) - failed0
        log(f"sidecar (e) server stopped, {sum(DECISIONS_PODS)} pods: solver={prov2.last_solver_used} "
            f"placed={placed2} errors={len(result2.results.pod_errors)} breaker={rs.breaker.state} "
            f"failures={rs.breaker.consecutive_failures} sidecar_unavailable +{degraded:g}; "
            f"reason {rs.fallback_reason!r}")
        if prov2.last_solver_used != "tpu" or rs.breaker.consecutive_failures != 1 or degraded != 1:
            bad.append("(e) degrade")
        if placed2 + len(result2.results.pod_errors) != sum(DECISIONS_PODS):
            bad.append("(e) degraded placements")

        # (f) the wire's own cost: (a)'s phases on both sides
        phases = {}
        if str_a is not None:
            phases = {
                "client": {k: round(v, 4) for k, v in ctr_a.top_phases().items()},
                "server": {k: round(v, 4) for k, v in str_a.top_phases().items()},
                "in_process": {k: round(v, 4) for k, v in ltr.top_phases().items()},
                "client_s": round(dt_a, 4), "server_s": round(str_a.total_seconds, 4),
                "in_process_s": round(dt_local, 4), "wire_id": ctr_a.trace_id,
                "bytes": {s_.name: s_.attrs.get("bytes") for s_ in ctr_a.spans if "bytes" in s_.attrs},
            }
            log("sidecar (f) phases (s) of (a): " + json.dumps(phases))
        if not phases or ctr_a.trace_id != str_a.trace_id:
            bad.append("(f)")
        if srv.oracle_degraded_solves or fleet_srv.oracle_degraded_solves or srv.device_failures:
            bad.append("a server-side oracle degrade or device failure")
        if tpu_errors():
            bad.append("tpu_error")
    finally:
        srv.stop()
        if fleet_srv is not None:
            fleet_srv.stop()
        srv.table_cache.clear()
        shutil.rmtree(sock_dir, ignore_errors=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    seconds = time.monotonic() - t_phase
    log(f"sidecar phase: {seconds:.1f}s; {'failed: ' + ', '.join(bad) if bad else 'ok'}")
    if bad:
        return None
    launches = dict(launches_a)
    launches.update({k: v for k, v in launches_d.items() if k.startswith("fleet_lanes")})
    return {"launches": launches, "seconds": seconds, "upload_bytes": upload_a, "phases": phases}


def cold_start_run(mode: str, dev) -> dict:
    """One fresh process's first headline solve (phase 14a): with
    mode "prewarm", `aot.prewarm()` on `dev` first. Returns its seconds,
    the prewarm's record, the launches, the decisions' digest and each
    library's build seconds as `_build.build_all` saw them here (0: no
    nvcc)."""
    import hashlib

    import torch

    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.solver import aot
    from karpenter_tpu_torch.solver.hybrid import solve_in_process

    out: dict = {"mode": mode}
    its = build_universe(HEADLINE_TYPES)
    w = headline_world(HEADLINE_PODS, its)
    reset_launches()
    if mode == "prewarm":
        t0 = time.monotonic()
        pw = aot.prewarm(device=dev)
        out["prewarm_s"] = time.monotonic() - t0
        out["prewarm"] = {k: pw[k] for k in ("completed", "built", "build_seconds", "launched", "skipped")}
        out["combos"] = {k: {"first_launch_ms": v["first_launch_ms"], "build_seconds": v["build_seconds"]}
                         for k, v in pw["combos"].items()}
        out["launches_prewarm"] = launch_counts()
        reset_launches()
    t0 = time.monotonic()
    res, sched = solve_in_process(w.pools, w.ibp, w.pods, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["first_solve_s"] = time.monotonic() - t0
    out["since_start_s"] = time.monotonic() - _T0
    out["used_tpu"] = bool(sched.used_tpu)
    out["launches_solve"] = launch_counts()
    out["decisions"] = hashlib.sha256(repr(results_snapshot(res, w.pods)).encode()).hexdigest()
    out["build"] = {} if dev.type != "cuda" else {k: v["seconds"] for k, v in _build.build_all().items()}
    return out


def cold_start_worker(mode: str) -> int:
    """`python3 chip_smoke.py --cold-start prewarm|plain`: cold_start_run
    on the card in this fresh process, printed as one COLD_START line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    print("COLD_START " + json.dumps(cold_start_run(mode, torch.device("cuda"))), flush=True)
    return 0


def cold_start_phase(dev, its, steady_s: float) -> Optional[dict]:
    """Phase 14a. Two fresh processes on the card after this one built the
    kernels: A runs `aot.prewarm()` then the headline's first solve, B the
    same first solve without a prewarm. Neither may invoke nvcc, A's
    prewarm must complete, and A's decisions must equal B's. A's first
    solve is printed beside B's and the headline phase's steady median.
    Then a SolverServer(prewarm=True) on the card in this process, its
    default prewarm held after its first combo: a solve sent then is
    served by the oracle (`prewarm_degraded` on the server's trace) with
    the in-process decisions; after ready, the same solve is on the card.
    Returns {"launches_prewarm", "seconds", ...}, or None on a failed check."""
    import shutil
    import tempfile
    import threading

    import torch

    from karpenter_tpu_torch import tracing
    from karpenter_tpu_torch.solver import aot
    from karpenter_tpu_torch.solver.hybrid import solve_in_process
    from karpenter_tpu_torch.solver.oracle import SchedulerOptions
    from karpenter_tpu_torch.solver.service import SolverClient, SolverServer
    from karpenter_tpu_torch.testing import fixtures

    t_phase = time.monotonic()
    bad = []
    runs = {}
    here = os.path.dirname(os.path.abspath(__file__))
    for mode in ("prewarm", "plain"):
        t0 = time.monotonic()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--cold-start", mode], cwd=here,
                              capture_output=True, text=True, timeout=COLD_START_TIMEOUT)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("COLD_START ")), None)
        if proc.returncode != 0 or line is None:
            log(f"cold start ({mode}): exit {proc.returncode}; {proc.stderr[-2000:]}")
            return None
        runs[mode] = json.loads(line[len("COLD_START "):])
        runs[mode]["process_s"] = time.monotonic() - t0
    a, b = runs["prewarm"], runs["plain"]
    nvcc = {m: {k: v for k, v in r["build"].items() if v} for m, r in runs.items()}
    log(f"cold start A (prewarm): process {a['process_s']:.1f}s, prewarm {a['prewarm_s']:.2f}s "
        f"{json.dumps(a['prewarm'])}, first solve {a['first_solve_s']:.3f}s ({a['since_start_s']:.1f}s after the "
        f"script's import), launches in the prewarm {json.dumps(a['launches_prewarm'])}")
    log(f"cold start A's manifest (first-launch ms, build s): {json.dumps(a['combos'])}")
    log(f"cold start B (no prewarm): process {b['process_s']:.1f}s, first solve {b['first_solve_s']:.3f}s "
        f"({b['since_start_s']:.1f}s after the script's import)")
    log(f"first headline solve: A {a['first_solve_s']:.3f}s (after a {a['prewarm_s']:.2f}s prewarm), "
        f"B {b['first_solve_s']:.3f}s, steady (the headline phase's median) {steady_s:.3f}s; "
        f"decisions A vs B {'equal' if a['decisions'] == b['decisions'] else 'DIFFERENT'}; "
        f"nvcc in A and B: {nvcc}")
    if any(nvcc.values()) or not all(r["build"] for r in runs.values()):
        bad.append("nvcc in a fresh process")
    if not a["prewarm"]["completed"] or a["prewarm"]["built"]:
        bad.append("prewarm")
    if a["decisions"] != b["decisions"] or not (a["used_tpu"] and b["used_tpu"]):
        bad.append("first solves")

    # the sidecar's default prewarm, held after its first combo
    os.makedirs("build", exist_ok=True)
    sock_dir = os.path.relpath(tempfile.mkdtemp(prefix="prewarm-", dir="build"))
    gate = threading.Event()
    real = aot.prewarm
    combos_seen = []

    def held(**kw):
        def progress(name, seconds):
            combos_seen.append(name)
            if len(combos_seen) == 1:
                gate.wait(COLD_START_TIMEOUT)

        out = real(progress=progress, **kw)
        if not combos_seen:  # every combo already warm here: hold the ready flip instead
            gate.wait(COLD_START_TIMEOUT)
        return out

    fixtures.reset_rng(42)
    pods = fixtures.make_generic_pods(PREWARM_DEGRADED_PODS)
    pools = [fixtures.node_pool(name="default")]
    ibp = {"default": its}
    kernels = SchedulerOptions(tpu_min_pods=0)
    local, _ = solve_in_process(pools, ibp, pods, options=kernels, device=dev)
    want = results_snapshot(local, pods)
    aot.prewarm = held
    srv = SolverServer(os.path.join(sock_dir, "solver.sock"), prewarm=True, device=dev)
    try:
        srv.start()
        c = SolverClient(srv.socket_path, request_timeout=SIDECAR_TIMEOUT)
        status = c.ping_status()["status"]
        tr = tracing.new_trace("sidecar_client", side="local")
        t0 = time.monotonic()
        got = c.solve(pools, ibp, pods, options=kernels, trace=tr)
        dt_degraded = time.monotonic() - t0
        tr.finish("ok")
        server = [t for t in tracing.RING.find(tr.trace_id) if t.side == "server"]
        marks = [s_.attrs.get("reason") for t in server for s_ in t.spans if s_.name == "oracle_fallback"]
        gate.set()
        ready = srv.ready.wait(COLD_START_TIMEOUT)
        t0 = time.monotonic()
        got2 = c.solve(pools, ibp, pods, options=kernels)
        torch.cuda.synchronize()
        dt_ready = time.monotonic() - t0
        status2 = c.ping_status()["status"]
        c.close()
    finally:
        gate.set()
        aot.prewarm = real
        srv.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
    same = wire_parts(got, pods) == want and wire_parts(got2, pods) == want
    log(f"sidecar prewarm on the card: PONG {status!r} mid-prewarm; a {len(pods)}-pod solve then {dt_degraded:.3f}s, "
        f"used_tpu={got['used_tpu']}, server trace {marks}; ready={ready} after {len(combos_seen)} combos, PONG "
        f"{status2!r}; the same solve {dt_ready:.3f}s used_tpu={got2['used_tpu']}; both vs solve_in_process: "
        f"{'equal' if same else 'DIFFERENT'}; degraded solves {srv.oracle_degraded_solves}")
    if status != "prewarming" or got["used_tpu"] or marks != ["prewarm_degraded"] or srv.oracle_degraded_solves != 1:
        bad.append("mid-prewarm degrade")
    if not ready or status2 != "ready" or not got2["used_tpu"] or not same:
        bad.append("after the prewarm")
    if aot.PREWARM_READY.value() != 1.0 or tpu_errors():
        bad.append("prewarm gauge or tpu_error")
    seconds = time.monotonic() - t_phase
    log(f"cold start phase: {seconds:.1f}s; {'failed: ' + ', '.join(bad) if bad else 'ok'}")
    if bad:
        return None
    return {"launches_prewarm": a["launches_prewarm"], "seconds": seconds, "prewarm_s": a["prewarm_s"],
            "first_solve_s": {"prewarm": a["first_solve_s"], "plain": b["first_solve_s"], "steady": steady_s},
            "combos": sorted(a["combos"])}


def operator_cluster(n_pods: int, n_pvc: int, its, dev, force_oracle: bool = False, probe_port=None):
    """The port's Operator over a KWOK provider holding `its`, with one
    default NodePool that consolidates at once (consolidateAfter 0, a 100%
    budget) and entry_cluster's pending pods (the c6 mix at n_pods, n_pvc
    PVC pods in ENTRY_ZONE); Options(tpu_min_pods=0) on `dev`, or the
    oracle's with force_oracle."""
    from karpenter_tpu_torch.api.objects import Budget
    from karpenter_tpu_torch.controllers.kube import FakeClock
    from karpenter_tpu_torch.controllers.operator import Operator
    from karpenter_tpu_torch.options import Options
    from karpenter_tpu_torch.testing import fixtures

    op = Operator(clock=FakeClock(), options=Options(tpu_min_pods=0, probe_port=probe_port),
                  force_oracle=force_oracle, device=None if force_oracle else dev)
    op.raw_cloud.types = its
    op.raw_cloud._by_name = {it.name: it for it in its}
    op.kube.create("NodePool", fixtures.node_pool(name="default", budgets=[Budget(nodes="100%")],
                                                  consolidate_after_seconds=0.0))
    create_entry_pods(op.kube, n_pods, n_pvc)
    return op


class OperatorRun(NamedTuple):
    """What operator_run observed: the ticks of each half, host seconds by
    controller, the launches of each half, the Commands started, the
    claims after provisioning, the nodes before and after consolidation."""

    settle_ticks: int
    settled: bool
    consolidate_ticks: int
    phases: dict
    launches_settle: dict
    launches_consolidate: dict
    commands: list
    claims: list
    nodes_provisioned: set
    nodes_final: set
    host_s: dict


def node_names(op) -> set:
    """The names of the Nodes in the Operator's store (read in place: a
    list() would copy every Node)."""
    return set(op.kube._store("Node"))


def operator_run(op, max_ticks: int, still_ticks: int, consolidate: bool = True, churn: bool = True) -> OperatorRun:
    """Phase 14's scenario on `op`: run_until_settled (provisioning), then,
    with `consolidate`, every pod RUNNING, every pod on every second node
    (by name) deleted (with `churn`), and ticks until the node set holds
    still for `still_ticks` ticks with no Command pending or in flight and nothing
    deleting, or `max_ticks` run out; past the budget the controller only
    finishes what it started (validates a pending Command, drains what is
    in flight). Each half with its launch counts reset just before and read
    just after."""
    import torch

    from karpenter_tpu_torch.api.objects import PodPhase

    phases: dict = {}
    commands: list = []
    step, reconcile = op.step, op.disruption.reconcile
    d = op.disruption

    def timed_step(advance_seconds: float = 1.0) -> None:
        step(advance_seconds)
        for k, v in op.last_phases.items():
            phases[k] = phases.get(k, 0.0) + v

    def recorded_reconcile():
        cmd = reconcile()
        if cmd is not None:
            commands.append(command_record(cmd))
        return cmd

    def finishing():
        # past the budget: a pending Command is validated (and started or
        # dropped); otherwise only the queue runs, so nothing new is proposed
        if d._pending_validation is not None:
            return recorded_reconcile()
        d.queue.reconcile()
        return None

    def busy() -> bool:
        return d._pending_validation is not None or d.queue.busy or any(
            x.metadata.deletion_timestamp is not None
            for kind in ("Node", "NodeClaim") for x in op.kube._store(kind).values())

    op.step, d.reconcile = timed_step, recorded_reconcile
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    reset_launches()
    t0 = time.monotonic()
    ticks = op.run_until_settled(max_ticks=max_ticks)
    sync()
    host = {"settle": time.monotonic() - t0}
    settled = op.settled()
    launches_settle = launch_counts()
    claims = claims_view(op.kube.list("NodeClaim"))
    provisioned = node_names(op)
    n = 0
    launches_consolidate: dict = {}
    if consolidate:
        t0 = time.monotonic()
        for p in op.kube.list("Pod", lambda p: churn and p.phase != PodPhase.RUNNING):
            p.phase = PodPhase.RUNNING
            op.kube.update("Pod", p)
        emptied = set(sorted(provisioned)[1::2]) if churn else set()
        for p in op.kube.list("Pod", lambda p: p.node_name in emptied):
            op.kube.delete("Pod", p.name)
        host["churn"] = time.monotonic() - t0
        sync()
        reset_launches()
        t0 = time.monotonic()
        still = 0
        while n < max_ticks and still < still_ticks:
            before = node_names(op)
            op.step(2.0)
            n += 1
            still = still + 1 if node_names(op) == before and not busy() else 0
        d.reconcile = finishing
        wind_down = 0
        while busy() and wind_down < max_ticks:
            op.step(2.0)
            wind_down += 1
        n += wind_down
        sync()
        host["consolidate"] = time.monotonic() - t0
        launches_consolidate = launch_counts()
    op.step, d.reconcile = step, reconcile
    return OperatorRun(ticks, settled, n, phases, launches_settle, launches_consolidate, commands, claims, provisioned,
                       node_names(op), host)


def operator_checks(op, run: OperatorRun, n_pvc: int = 0, provisioning: bool = True, sweep: bool = False,
                    decode_kernel: bool = True) -> list:
    """Phase 14's checks on a finished operator_run, each a failure's name:
    with `provisioning`, the settle's (settled, one node a claim, the
    kernel route: K1, K3, K4, and K5 with `decode_kernel`, which decodes
    from tpu._DEDUP_DECODE_MIN claim slots up; the PVC pods in
    ENTRY_ZONE); where the consolidation half ran, a Command executed and
    its nodes drained and gone (with `sweep`, K8 or K6 launched in the
    run: a Command's search may start in the settle's last tick); always, every pod bound to a
    live node within its allocatable, nothing pending, every claim
    launched, registered and initialized."""
    from karpenter_tpu_torch.api import labels as well_known
    from karpenter_tpu_torch.api.objects import COND_INITIALIZED, COND_LAUNCHED, COND_REGISTERED
    from karpenter_tpu_torch.utils import resources as res

    bad = []
    if provisioning:
        if not run.settled:
            bad.append("not settled")
        if not run.claims or len(run.nodes_provisioned) != len(run.claims):
            bad.append("claims and nodes")
        k_runs = run.launches_settle.get("run_step", 0) + run.launches_settle.get("run_step_relax", 0)
        needed = ("typeok_screen", "run_arrays") + (("dedup_rows",) if decode_kernel else ())
        if min(run.launches_settle.get(k, 0) for k in needed) < 1 or not k_runs:
            bad.append("provisioning launches")
        if op.provisioner.last_solver_used != "tpu":
            bad.append("route")
    if tpu_errors():
        bad.append("tpu_error")
    if run.consolidate_ticks:
        if not run.commands:
            bad.append("no Command executed")
        removed = {name for cmd in run.commands for name in cmd["nodes"]}
        terminated = {e.name for e in op.recorder.for_reason("Terminated")}
        if not removed <= terminated or removed & run.nodes_final:
            bad.append("the Commands' nodes not drained and removed")
        k_sweep = sum(counts.get(k, 0) for counts in (run.launches_settle, run.launches_consolidate)
                      for k in ("set_sweep", "fast_sweep"))
        if sweep and not k_sweep:
            bad.append("no K8 or K6 launch")
    if op.kube.pending_pods():
        bad.append("pending pods")
    live = {n.name: n for n in op.kube.list("Node")}
    used: dict = {}
    pods = op.kube.list("Pod")
    for p in pods:
        if p.node_name not in live:
            bad.append("a pod off the live nodes")
            break
        used[p.node_name] = res.merge(used.get(p.node_name, {}), p.requests)
    if any(not res.fits(u, live[n].allocatable) for n, u in used.items() if n in live):
        bad.append("a node's pods exceed its allocatable")
    conds = (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED)
    if any(tuple(c.status.conditions.get(k) for k in conds) != ("True",) * 3 for c in op.kube.list("NodeClaim")):
        bad.append("a claim not launched, registered and initialized")
    if provisioning and not run.consolidate_ticks:
        stateful = [p for p in pods if p.name.startswith("stateful-")]
        zones = {live[p.node_name].metadata.labels.get(well_known.TOPOLOGY_ZONE_LABEL_KEY)
                 for p in stateful if p.node_name in live}
        if n_pvc and (zones != {ENTRY_ZONE} or len(stateful) != n_pvc):
            bad.append(f"PVC pods' zones {sorted(map(str, zones))} ({len(stateful)} of {n_pvc})")
    return bad


def command_record(cmd) -> dict:
    """A started Command as phase 14 keeps it (taken when it starts: its
    candidates' state goes with their nodes)."""
    from karpenter_tpu_torch.controllers.disruption.types import command_savings

    return {"view": command_view(cmd), "nodes": [c.name for c in cmd.candidates], "reason": cmd.reason,
            "decision": cmd.decision, "replacements": len(cmd.replacements),
            "usd_per_hour": round(command_savings(cmd), 6)}


def show_commands(commands) -> list:
    return [{k: (len(v) if k == "nodes" else v) for k, v in c.items() if k != "view"} for c in commands]


class PartitionReferee:
    """(c)'s oracle side, as a context manager: a force_oracle
    TorchHybridScheduler solves by solve_partition, the referee's rule for
    the kernel route, so that its claims come in the kernels' order and its
    stateful pods after the rest. Without it the Provisioner would name the
    same claims differently, and a later round, which sees nodes by name,
    would decide differently. The kernel route's own solves are left as
    they are."""

    def __enter__(self):
        from karpenter_tpu_torch.solver import hybrid as H

        self._cls = H.TorchHybridScheduler
        orig = self._orig = self._cls._oracle_solve

        def oracle_solve(sched, tr, pods):
            if sched.tpu is not None:  # the kernel route's continuation
                return orig(sched, tr, pods)
            return solve_partition(lambda ps: orig(sched, tr, ps), sched.oracle, pods,
                                   sched.opts.ignore_preferences)

        self._cls._oracle_solve = oracle_solve
        return self

    def __exit__(self, *exc):
        self._cls._oracle_solve = self._orig
        return False


def operator_oracle_run() -> dict:
    """(c)'s oracle side: the DECISIONS_PODS scenario through the port's
    Operator(force_oracle=True) under the PartitionReferee, its claims named
    from OPERATOR_CLAIM_SEQ0 like the card's; what (c) compares and shows of
    it."""
    from karpenter_tpu_torch.controllers import provisioning as P

    P._claim_name_seq[0] = OPERATOR_CLAIM_SEQ0
    t0 = time.monotonic()
    its = build_universe(HEADLINE_TYPES)
    o = operator_cluster(*DECISIONS_PODS, its, None, force_oracle=True)
    with PartitionReferee():
        r = operator_run(o, OPERATOR_TICKS, OPERATOR_STILL_TICKS)
    o.stop()
    return {"claims": r.claims, "first_command": [c["view"] for c in r.commands[:1]],
            "nodes": sorted(r.nodes_final), "commands": show_commands(r.commands), "ticks": [r.settle_ticks,
            r.consolidate_ticks], "nodes_provisioned": len(r.nodes_provisioned), "seconds": time.monotonic() - t0,
            "host_s": r.host_s}


def operator_oracle_worker() -> int:
    """`python3 chip_smoke.py --operator-oracle`: operator_oracle_run in this
    process (the oracle alone: no card), printed as one OPERATOR_ORACLE
    line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    print("OPERATOR_ORACLE " + json.dumps(operator_oracle_run()), flush=True)
    return 0


class OperatorOracle:
    """(c)'s oracle side in a process of its own (operator_oracle_worker).
    It is host work alone, so it is started as soon as the kernels are built
    and runs beside the card's phases; `close` stops it on any way out."""

    def __init__(self):
        self.proc = None
        self.log = None
        self.t_start = 0.0

    def start(self) -> None:
        os.makedirs("build", exist_ok=True)
        # its log goes to a file: a pipe nobody reads until the end would fill
        self.log = open(os.path.join("build", "operator-oracle.log"), "w+")
        self.t_start = time.monotonic()
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--operator-oracle"],
                                     cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                                     stderr=self.log, text=True)

    def result(self) -> Optional[dict]:
        """Its OPERATOR_ORACLE record, waited for at most
        OPERATOR_ORACLE_TIMEOUT seconds; None (and its log's tail printed)
        when it failed."""
        if self.proc is None:
            log("operator (c) oracle process: never started")
            return None
        t0 = time.monotonic()
        try:
            out, _ = self.proc.communicate(timeout=OPERATOR_ORACLE_TIMEOUT)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        line = next((ln for ln in out.splitlines() if ln.startswith("OPERATOR_ORACLE ")), None)
        if self.proc.returncode != 0 or line is None:
            self.log.seek(0)
            log(f"operator (c) oracle process: exit {self.proc.returncode}; {self.log.read()[-2000:]}")
            return None
        rec = json.loads(line[len("OPERATOR_ORACLE "):])
        rec["waited_s"] = time.monotonic() - t0
        rec["started_s"] = self.t_start - _T0
        return rec

    def close(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        if self.log is not None:
            self.log.close()


def operator_phase(dev, its, oracle: OperatorOracle) -> Optional[dict]:
    """Phase 14b-d: the port's Operator on the card, with
    Options(tpu_min_pods=0), over the headline's types and
    operator_cluster's pool (consolidateAfter 0, a 100% budget).

    (b) The c6 mix at C6_PODS plus ENTRY_PVC_PODS PVC pods:
        run_until_settled binds every pod within its node's allocatable on
        the kernel route (K1, K3, K4, K5), the PVC pods in ENTRY_ZONE, every
        claim launched, registered and initialized by the lifecycle
        controller. The consolidation half (the host's ticks at the full
        width would not fit the run's time) runs on (c)'s card cluster and
        on an under-utilized fleet of OPERATOR_FLEET_NODES one-pod nodes
        (fixtures.underutilized_operator): on each a Command proposed,
        validated and executed by the OrchestrationQueue, its nodes drained
        by NodeTermination and gone, every surviving pod bound; on the
        fleet through K8 or K6 (the c6 mix fails the sweeps' fast gates,
        so its multi-node search bisects on simulations, which run on the
        kernels).
    (c) DECISIONS_PODS through the card's Operator and through the port's
        Operator(force_oracle=True) under the PartitionReferee (`oracle`,
        started earlier in a process of its own), on fresh clusters: equal
        claims after provisioning, an equal first Command, an equal final
        node set.
    (d) (b)'s probe server: /readyz 200, /debug/programs with the
        prewarm's combos, /metrics with karpenter_solver_prewarm_ready 1;
        two headline solves under profiling.device_trace write a Chrome
        trace that names the kernels they launched.

    Returns {"launches", "seconds", ...}, or None on a failed check."""
    import urllib.error
    import urllib.request

    from karpenter_tpu_torch import profiling
    from karpenter_tpu_torch.controllers import provisioning as P
    from karpenter_tpu_torch.options import Options
    from karpenter_tpu_torch.solver.hybrid import solve_in_process
    from karpenter_tpu_torch.testing import fixtures

    t_phase = time.monotonic()
    bad = []
    launches_op: dict = {}
    phases: dict = {}
    n_ticks = 0

    def add(run):
        nonlocal n_ticks
        for counts in (run.launches_settle, run.launches_consolidate):
            for k, v in counts.items():
                launches_op[k] = launches_op.get(k, 0) + v
        for k, v in run.phases.items():
            phases[k] = phases.get(k, 0.0) + v
        n_ticks += run.settle_ticks + run.consolidate_ticks

    # (b) provisioning at full width, and (d) its probes
    t0 = time.monotonic()
    op = operator_cluster(C6_PODS, ENTRY_PVC_PODS, its, dev, probe_port=0)
    log(f"operator (b): Operator and {C6_PODS + ENTRY_PVC_PODS} pending pods built in {time.monotonic() - t0:.1f}s")
    try:
        run = operator_run(op, OPERATOR_TICKS, OPERATOR_STILL_TICKS, consolidate=False)
        add(run)
        bad += [f"(b) {b}" for b in operator_checks(op, run, ENTRY_PVC_PODS)]
        log(f"operator (b) run_until_settled: settled={run.settled} in {run.settle_ticks} ticks, "
            f"{run.host_s['settle']:.2f}s host; {len(run.claims)} claims, {len(run.nodes_provisioned)} nodes; "
            f"route {op.provisioner.last_solver_used}; launches {run.launches_settle}; Commands during the settle "
            f"{json.dumps(show_commands(run.commands))}")
        log(f"operator (b) host seconds a tick by controller (mean of {run.settle_ticks} ticks): "
            + json.dumps({k: round(v / max(run.settle_ticks, 1), 4) for k, v in run.phases.items()}))
        base = f"http://127.0.0.1:{op.probes.port}"

        def get(path):
            try:
                with urllib.request.urlopen(base + path, timeout=30) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        ready = get("/readyz")[0]
        code, body = get("/debug/programs")
        programs = json.loads(body).get("programs", {}) if code == 200 else {}
        metrics_ok = "karpenter_solver_prewarm_ready 1" in get("/metrics")[1]
        log(f"operator (d) probes: /readyz {ready}; /debug/programs {code} with {len(programs)} combos; "
            f"/metrics has karpenter_solver_prewarm_ready 1: {metrics_ok}")
        if ready != 200 or not programs or not metrics_ok:
            bad.append("(d) probes")
    finally:
        op.stop()
    del op

    # (d) a solve under the device trace
    logdir = os.path.join("build", "device_trace")
    t0 = time.monotonic()
    with profiling.device_trace(logdir):
        # two solves: the trace has dropped a kernel's event before (PERF.md §7)
        for _ in range(2):
            w = headline_world(HEADLINE_PODS, its)
            solve_in_process(w.pools, w.ibp, w.pods, device=dev)
    with open(os.path.join(logdir, profiling.TRACE_NAME)) as f:
        events = json.load(f).get("traceEvents", [])
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    traced = sorted(k for k in TRACE_KERNELS if any(k in n for n in names))
    log(f"operator (d) device_trace: {time.monotonic() - t0:.1f}s, {len(events)} events, {len(names)} kernel names; "
        f"the path's kernels named: {traced} of {list(TRACE_KERNELS)}")
    if traced != sorted(TRACE_KERNELS):
        bad.append("(d) device_trace")

    # (b) the consolidation half where the sweeps apply: an under-utilized
    # fleet of one-pod nodes provisioned through the Operator (the
    # fixtures' underutilized_operator), ticked until it holds still
    t0 = time.monotonic()
    fop = fixtures.underutilized_operator(OPERATOR_FLEET_NODES, device=dev, force_oracle=False,
                                          options=Options(tpu_min_pods=0))
    built_s = time.monotonic() - t0
    fr = operator_run(fop, OPERATOR_TICKS, OPERATOR_STILL_TICKS, churn=False)
    fop.stop()
    add(fr)
    bad += [f"(b) fleet {b}" for b in operator_checks(fop, fr, provisioning=False, sweep=True)]
    log(f"operator (b) under-utilized fleet of {OPERATOR_FLEET_NODES} nodes (built through the Operator in "
        f"{built_s:.1f}s): {fr.consolidate_ticks} ticks, {fr.host_s['consolidate']:.2f}s host; "
        f"{len(fr.nodes_provisioned)} -> {len(fr.nodes_final)} nodes; Commands {json.dumps(show_commands(fr.commands))}; "
        f"launches {fr.launches_consolidate}")
    del fop

    # (c) the card's Operator against the oracle's; the card's run is (b)'s
    # consolidation half
    n, n_pvc = DECISIONS_PODS
    P._claim_name_seq[0] = OPERATOR_CLAIM_SEQ0
    t0 = time.monotonic()
    o = operator_cluster(n, n_pvc, its, dev)
    r = operator_run(o, OPERATOR_TICKS, OPERATOR_STILL_TICKS)
    o.stop()
    add(r)
    bad += [f"(b, c) {b}" for b in operator_checks(o, r, n_pvc, decode_kernel=False)]
    # as the oracle's process printed its own (JSON: tuples become lists)
    card = (r.claims, json.loads(json.dumps([c["view"] for c in r.commands[:1]])), sorted(r.nodes_final))
    log(f"operator (c) card: {n} + {n_pvc} pods, {r.settle_ticks} + {r.consolidate_ticks} ticks, "
        f"{time.monotonic() - t0:.1f}s ({json.dumps({k: round(v, 2) for k, v in r.host_s.items()})} host); "
        f"{len(r.claims)} claims; {len(r.nodes_provisioned)} -> {len(r.nodes_final)} nodes; Commands "
        f"{json.dumps(show_commands(r.commands))}; launches {r.launches_settle} then {r.launches_consolidate}")
    log(f"operator (c) card host seconds a tick by controller (mean of {r.settle_ticks + r.consolidate_ticks} ticks): "
        + json.dumps({k: round(v / max(r.settle_ticks + r.consolidate_ticks, 1), 4) for k, v in r.phases.items()}))
    del o
    orc = oracle.result()
    if orc is None:
        return None
    log(f"operator (c) oracle (its own process, started at {orc['started_s']:.1f}s, waited {orc['waited_s']:.1f}s "
        f"for): {orc['ticks'][0]} + {orc['ticks'][1]} ticks, {orc['seconds']:.1f}s "
        f"({json.dumps({k: round(v, 2) for k, v in orc['host_s'].items()})} host); {len(orc['claims'])} claims; "
        f"{orc['nodes_provisioned']} -> {len(orc['nodes'])} nodes; Commands {json.dumps(orc['commands'])}")
    orc_views = (orc["claims"], orc["first_command"], orc["nodes"])
    same = [card[i] == orc_views[i] for i in range(3)]
    log(f"operator (c) card vs oracle Operator: claims {'equal' if same[0] else 'DIFFERENT'}, first Command "
        f"{'equal' if same[1] else 'DIFFERENT'}, final nodes {'equal' if same[2] else 'DIFFERENT'}")
    if not all(same):
        bad.append("(c) card against the oracle")
        if not same[0]:
            only_card, only_orc = sorted(set(card[0]) - set(orc_views[0])), sorted(set(orc_views[0]) - set(card[0]))
            log(f"operator (c) claims only the card made: {len(only_card)}, only the oracle: {len(only_orc)}; "
                f"first of each: {only_card[:1]} / {only_orc[:1]}")
        if not same[1]:
            log(f"operator (c) first Commands: card {card[1]} / oracle {orc_views[1]}")
        if not same[2]:
            log(f"operator (c) final nodes only the card kept: {sorted(set(card[2]) - set(orc_views[2]))[:20]}, "
                f"only the oracle: {sorted(set(orc_views[2]) - set(card[2]))[:20]}")
    log(f"operator host seconds by controller over its {n_ticks} card ticks: "
        + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    seconds = time.monotonic() - t_phase
    log(f"operator phase: {seconds:.1f}s; launches on its main paths {json.dumps(launches_op)}; "
        f"{'failed: ' + ', '.join(bad) if bad else 'ok'}")
    if bad:
        return None
    return {"launches": launches_op, "seconds": seconds, "ticks": n_ticks, "commands": show_commands(r.commands)}


def device_failure_check(dev, its) -> bool:
    """A failure of the card inside a solve propagates out of
    TorchHybridScheduler.solve instead of being re-solved on the oracle:
    with the scheduler built and then every free byte of the card held,
    a solve of 1024 requests-only pods (tpu_min_pods=0) must raise a
    device failure (torch's out-of-memory, or a kernel's DeviceError) and
    count no tpu_error. The memory is released after."""
    import torch

    from karpenter_tpu_torch.solver import TorchHybridScheduler
    from karpenter_tpu_torch.solver.hybrid import device_failure
    from karpenter_tpu_torch.solver.oracle import SchedulerOptions
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.testing import fixtures

    fixtures.reset_rng(42)
    pods = fixtures.make_generic_pods(1024)
    pools = [fixtures.node_pool(name="default")]
    ibp = {pools[0].name: its}
    h = TorchHybridScheduler(pools, ibp, Topology(pools, ibp, pods), options=SchedulerOptions(tpu_min_pods=0),
                             device=dev)
    before = tpu_errors()
    torch.cuda.synchronize()
    hold, raised = [], None
    try:
        # from large blocks down to the caching allocator's smallest, so
        # no free fragment is left for the solve
        for size in (1 << 30, 1 << 24, 1 << 21, 1 << 16, 512):
            while True:
                try:
                    hold.append(torch.empty(size, dtype=torch.uint8, device=dev))
                except torch.OutOfMemoryError:
                    break
        held = sum(t.numel() for t in hold)
        try:
            h.solve(pods)
        except Exception as e:  # noqa: BLE001 - the check is that it raises
            raised = e
    finally:
        hold.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ok = raised is not None and device_failure(raised) and tpu_errors() == before and h.used_tpu is None
    log(f"device failure inside a solve ({held / 2**30:.2f} GiB of the card held): "
        f"{'raised ' + type(raised).__name__ if raised is not None else 'returned, route ' + str(h.fallback_kind)}; "
        f"tpu_error {tpu_errors() - before:+g}; {'ok' if ok else 'FAILED: the guard hid the card'}")
    return ok


def main() -> int:
    oracle = OperatorOracle()
    try:
        return _main(oracle)
    finally:
        oracle.close()


def _main(oracle: OperatorOracle) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from karpenter_tpu_torch import _build
        from karpenter_tpu_torch.solver import tpu as T
        from karpenter_tpu_torch import device as D
        from karpenter_tpu_torch.solver import tpu_kernel as K
        from karpenter_tpu_torch.solver import tpu_runs as KR
    except ImportError as e:
        print(f"chip_smoke: the karpenter_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if any(m == "jax" or m.startswith(("jax.", "karpenter_tpu.")) for m in sys.modules):
        print("chip_smoke: the port pulled in jax or the reference package", file=sys.stderr)
        return 1
    t_start = time.monotonic()

    # ---- 1. build, and meanwhile the sweep phase's fleets on the host
    # (about 45 s of host work that would otherwise count against the
    # run's 800 s aim) ----
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.monotonic()
    with ThreadPoolExecutor(1) as ex:
        building = ex.submit(_build.build_all)
        fleets = sweep_worlds()
        snc_fleet = single_node_world()
        log(f"sweep fleets built on the host while nvcc runs: {time.monotonic() - t0:.1f}s")
        built = building.result()
    oracle.start()  # phase 14c's oracle side: host work alone, beside the card's phases
    log(f"build: {time.monotonic() - t0:.1f}s wall for {len(built)} libraries (parallel nvcc)")
    for name, info in built.items():
        log(f"  {name}: {info['seconds']:.1f}s")
        for line in ptxas_lines(info["log"]):
            log(f"    {line}")

    # ---- 2. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")

    its = build_universe(HEADLINE_TYPES)

    # ---- 3. K1 typeok_screen vs its plain version, headline tables ----
    from karpenter_tpu_torch.solver.tpu_problem import _pow2

    t0 = time.monotonic()
    k1h = k1_rows(headline_world(HEADLINE_PODS, its), dev)
    log(f"headline encode and tables: {time.monotonic() - t0:.2f}s (host)")
    k1_mism = k1_checked("headline class rows", k1h)
    if k1_mism:
        return 1
    k1_ms = cuda_ms(k1h.launch, 200)
    k1_plain_ms = cuda_ms(k1h.plain, 20)
    IW = k1h.iw
    k1_bound, k1_by = k1_bound_of(k1h)

    # ---- 4. K2 scan_step vs its plain version, on the card ----
    k2_mism = 0
    for label, world, in_order in (
        ("diverse-16", headline_world(16, _small_types()), True),
        ("mixed", mixed_world(), False),
        ("reserved", reserved_world(), False),
    ):
        tb_s, st_s, xs_s = step_inputs(world, dev, in_order=in_order)
        st_k, kinds_k, slots_k, over_k, odo_k = K.solve_scan(tb_s, st_s, xs_s)
        st_p, kinds_p, slots_p, over_p, odo_p = K.solve_scan_plain(tb_s, st_s, xs_s)
        torch.cuda.synchronize()
        bad = state_mismatches(st_k, st_p)
        if not torch.equal(kinds_k, kinds_p):
            bad.append("kinds")
        if not torch.equal(slots_k, slots_p):
            bad.append("slots")
        if bool(over_k) != bool(over_p) or int(odo_k.steps) != int(odo_p.steps):
            bad.append("overflow/steps")
        kinds = kinds_k.cpu().tolist()
        log(
            f"K2 scan_step {label}: P={xs_s.valid.shape[0]} E={st_s.eavail.shape[0]} "
            f"N={st_s.active.shape[0]} T={tb_s.tdaemon.shape[0]} HPW={st_s.hp_used.shape[1]} "
            f"NRES={st_s.rescap.shape[0]} held_bits={int(D.popcount(st_k.held).sum())} "
            f"minValues={bool((tb_s.treq.minv >= 0).any())} "
            f"kinds(existing/claim/new/fail)={[kinds.count(k) for k in range(4)]} "
            f"mismatches={bad or 'none'}"
        )
        k2_mism += len(bad)
    if k2_mism:
        return 1

    # K2 over a prefix of the headline round at full width (the plain
    # version takes about 11 ms a pod), and over the whole round for speed
    tb_h, st_h, xs_h = step_inputs(headline_world(HEADLINE_PODS, its), dev, prefix=K2_PREFIX)
    P_h = xs_h.valid.shape[0]
    k2_ms = cuda_ms(lambda: K.solve_scan(tb_h, st_h, xs_h), 3)
    st_k, kinds_k, slots_k, over_k, odo_k = K.solve_scan(tb_h, st_h, xs_h)
    t0 = time.monotonic()
    st_p, kinds_p, slots_p, over_p, odo_p = K.solve_scan_plain(tb_h, st_h, xs_h)
    torch.cuda.synchronize()
    k2_plain_ms = (time.monotonic() - t0) * 1e3
    bad = state_mismatches(st_k, st_p)
    if not (torch.equal(kinds_k, kinds_p) and torch.equal(slots_k, slots_p)):
        bad.append("kinds/slots")
    if bool(over_k) != bool(over_p) or int(odo_k.steps) != int(odo_p.steps):
        bad.append("overflow/steps")
    k2_layout = K.last_layout("scan_step")
    log(
        f"K2 scan_step headline prefix (P={P_h}, N={st_h.active.shape[0]}): kernel {k2_ms:.3f} ms, "
        f"plain {k2_plain_ms:.1f} ms, tables {k2_layout}, mismatches={bad or 'none'}"
    )
    # at the headline's shapes every type table lives in shared memory
    if bad or not all(k2_layout["shared"].values()):
        return 1
    # the least time for the same work: every input read once, the state
    # and the outputs written once, and the (pod, open claim) pairs the
    # screens must visit
    is_new = (kinds_k == K.KIND_NEW).to(torch.int64)
    k2_pairs = int((torch.cumsum(is_new, 0) - is_new)[xs_h.valid].sum())
    TWh, Kh = tb_h.va.full_mask.shape[0], tb_h.va.num_keys
    k2_bound, k2_by = bound(nbytes(tb_h, st_h, xs_h) + nbytes(st_h) + 2 * 4 * P_h, k2_pairs * (2 * TWh + 3 * Kh))
    tb_f, st_f, xs_f = step_inputs(headline_world(HEADLINE_PODS, its), dev)
    k2_round_ms = cuda_ms(lambda: K.solve_scan(tb_f, st_f, xs_f), 2)
    log(f"K2 scan_step whole headline round (P={xs_f.valid.shape[0]}, N={st_f.active.shape[0]}): {k2_round_ms:.3f} ms")

    # ---- 5. K3 run_step vs its plain version, on the card ----
    k3_mism = 0
    for label, world, div in (
        ("diverse-16", headline_world(16, _small_types()), None),
        ("diverse-400 (64 slots)", headline_world(400, _small_types()), 10_000),
        ("mixed-bulk", mixed_bulk_world(), None),
    ):
        rr = runs_round(world, dev, div)
        n = len(rr.order)
        nseq0 = torch.zeros((), dtype=torch.int32, device=dev)
        got = KR.solve_runs(rr.tb, rr.st, rr.rx, rr.seq, nseq0, n)
        want = KR.solve_runs_plain(rr.tb, rr.st, rr.rx, rr.seq, nseq0, n)
        torch.cuda.synchronize()
        bad = runs_mismatches(got, want)
        kinds = got[3].cpu().tolist()
        log(
            f"K3 run_step {label}: P={rr.rx.is_head.shape[0]} n={n} E={rr.st.eavail.shape[0]} "
            f"N={rr.st.active.shape[0]} steps={int(got[6].steps)} bulk_steps={int(got[6].bulk_steps)} "
            f"over={bool(got[5])} ptr={int(got[7])} kinds(existing/claim/new/fail)={[kinds.count(k) for k in range(4)]} "
            f"mismatches={bad or 'none'}"
        )
        k3_mism += len(bad)
    if k3_mism:
        return 1
    # the headline's two dispatches: N=1024 up to the overflow, then the
    # rest of the round after growing to 2048 slots
    rr = runs_round(headline_world(HEADLINE_PODS, its), dev)
    n = len(rr.order)
    nseq0 = torch.zeros((), dtype=torch.int32, device=dev)
    first_args = (rr.tb, rr.st, rr.rx, rr.seq, nseq0, n)
    got1 = KR.solve_runs(*first_args)
    t0 = time.monotonic()
    want1 = KR.solve_runs_plain(*first_args)
    torch.cuda.synchronize()
    k3_plain_ms = (time.monotonic() - t0) * 1e3
    bad = runs_mismatches(got1, want1)
    if not bool(got1[5]):
        bad.append("no overflow in the first dispatch")
    ptr1 = int(got1[7])
    N1 = rr.st.active.shape[0]
    st2, seq2 = rr.sched._grow(rr.problem, got1[0], got1[1], N1)
    batch = rr.order[ptr1:]
    xs2, idx2 = rr.sched._pod_xs_with_idx(rr.problem, batch)
    rx2 = rr.sched._run_x(xs2, idx2, len(batch))
    cont_args = (rr.tb, st2, rx2, seq2, got1[2], len(batch))
    got2 = KR.solve_runs(*cont_args)
    t0 = time.monotonic()
    want2 = KR.solve_runs_plain(*cont_args)
    torch.cuda.synchronize()
    k3_plain_ms += (time.monotonic() - t0) * 1e3
    bad += runs_mismatches(got2, want2)
    k3_ms = cuda_ms(lambda: KR.solve_runs(*first_args), 3) + cuda_ms(lambda: KR.solve_runs(*cont_args), 3)
    k3_layout = K.last_layout("run_step")
    log(
        f"K3 run_step headline: dispatch 1 N={N1} stops at ptr={ptr1} (steps={int(got1[6].steps)}, "
        f"bulk_steps={int(got1[6].bulk_steps)}); dispatch 2 N={2 * N1} over {len(batch)} pods "
        f"(steps={int(got2[6].steps)}, bulk_steps={int(got2[6].bulk_steps)}, over={bool(got2[5])}); "
        f"kernel {k3_ms:.3f} ms, plain {k3_plain_ms:.1f} ms, tables {k3_layout}, mismatches={bad or 'none'}"
    )
    if bad or not all(k3_layout["shared"].values()):
        return 1
    k3_iters = int(got1[6].steps) + int(got2[6].steps)
    R_h = rr.tb.ialloc.shape[1]
    # every input read once, state and outputs written once; each
    # iteration's feasibility screen over the claim slots (fits: R
    # compares, type screen: IW words)
    k3_bound, k3_by = bound(
        nbytes(rr.tb, rr.st, rr.rx) + nbytes(st2) + nbytes(rx2) + 2 * 4 * (n + len(batch)),
        int(got1[6].steps) * N1 * (R_h + IW) + int(got2[6].steps) * 2 * N1 * (R_h + IW),
    )

    # ---- 6. K4 run_arrays vs its plain version: both headline rounds, the edges ----
    cls_d = rr.sched._dev_tables["cls"]
    bulk_d, aff_d = rr.sched._runflags_dev
    _, idx_h = rr.sched._pod_xs_with_idx(rr.problem, rr.order)
    k4_args = (cls_d, bulk_d, aff_d, idx_h, n)
    k4_rounds = {"headline round 1": k4_args, "headline round 2": (cls_d, bulk_d, aff_d, idx2, len(batch))}
    k4_mism = sum(
        int(not torch.equal(a, b)) for args in k4_rounds.values() for a, b in zip(T.run_arrays(*args), T.run_arrays_plain(*args))
    )
    k4_mism += len(k4_edge_checks(dev))
    k4_ms = cuda_ms(lambda: T.run_arrays(*k4_args), 200)
    k4_plain_ms = cuda_ms(lambda: T.run_arrays_plain(*k4_args), 50)
    P_r = idx_h.shape[0]
    k4_bound, k4_by = bound(P_r * 4 + P_r * 4 + bulk_d.numel() + aff_d.numel() + P_r * (3 + 4), P_r * 8)
    log(
        f"K4 run_arrays headline rounds (P={P_r}, {idx2.shape[0]}): kernel {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms, "
        f"mismatched arrays={k4_mism}"
    )
    if k4_mism:
        return 1

    # ---- 7. K5 dedup_rows vs its plain version: the headline's final
    # claim state as the decode hands it over, synthetic rows, the edges ----
    st_final = got2[0]
    n_cl = int(st_final.n_claims)
    n2 = min(_pow2(max(n_cl, 1), floor=64), st_final.active.shape[0])
    dcols = T.decode_columns(st_final)
    k5_got, k5_want = T.dedup_decode_state(st_final, n2), T.dedup_columns_plain(dcols, n2)
    torch.cuda.synchronize()
    k5_bad = dedup_mismatches(k5_got, k5_want)
    gen = torch.Generator(device="cpu").manual_seed(5)
    drows = T.decode_rows(st_final, n2)  # the packed rows: torch.unique's input
    pool = torch.randint(-(1 << 31), (1 << 31) - 1, (512, drows.shape[1]), generator=gen, dtype=torch.int64)
    synth = pool[torch.randint(0, 512, (16384,), generator=gen)].to(torch.int32).to(dev)
    k5_big_got, k5_big_want = T.dedup_rows(synth), T.dedup_rows_plain(synth)
    torch.cuda.synchronize()
    k5_bad += [f"synthetic {b}" for b in dedup_mismatches(k5_big_got, k5_big_want)]
    k5_bad += k5_edge_checks(dev)
    # the per-phase clock breakdown, the profiled launch held to the plain version
    k5_prof = torch.zeros(len(T.DEDUP_PHASES) + 1, dtype=torch.int64, device=dev)
    k5_bad += [f"profiled {b}" for b in dedup_mismatches(T.dedup_columns(dcols, n2, prof=k5_prof), k5_want)]
    k5_phases = T.dedup_breakdown(k5_prof)
    k5_ms = cuda_ms(lambda: T.dedup_decode_state(st_final, n2), 50)
    k5_plain_ms = cuda_ms(lambda: T.dedup_columns_plain(dcols, n2), 3)
    k5_lib_ms = cuda_ms(lambda: torch.unique(drows, dim=0, return_inverse=True), 3)
    k5_big_ms = cuda_ms(lambda: T.dedup_rows(synth), 3)
    C_d = drows.shape[1]
    # the rows read once from the columns as they lie (a bool a byte, an
    # int32 four), compact, inv and n_uniq written once
    k5_read = sum(n2 * c.shape[1] * c.element_size() for c in dcols)
    k5_bound, k5_by = bound(k5_read + n2 * C_d * 4 + n2 * 4 + 4, 4 * n2 * C_d)
    log(
        f"K5 dedup_rows headline final state (n2={n2}, C={C_d}, claims={n_cl}, uniques={int(k5_got[0])}): "
        f"kernel {k5_ms:.4f} ms, plain {k5_plain_ms:.4f} ms, torch.unique {k5_lib_ms:.4f} ms; "
        f"synthetic 16384 rows (uniques={int(k5_big_got[0])}): kernel {k5_big_ms:.4f} ms; "
        f"clock breakdown (cycles, CTA 0): {json.dumps(k5_phases)}; mismatches={k5_bad or 'none'}"
    )
    if k5_bad:
        return 1

    # the data movement the reference also left to plain array ops (torch
    # ops here, each its own library call), at the headline's shapes: a
    # round's row gathers, the claim-slot regrow, the decode's row-slice
    # fetch (taken below 2048 slots) and the fetch of the dedup's unique rows
    E_h = st_final.eavail.shape[0]
    u2 = min(_pow2(max(int(k5_got[0]), 1), floor=64), n2)

    def slice_fetch():
        return [a[:n2].cpu() for a in (*st_final.creq, st_final.alive, st_final.tmpl, st_final.crequests)] + [
            st_final.h_cnt[:, : E_h + n2].cpu()
        ]

    xs_g, _ = rr.sched._pod_xs_with_idx(rr.problem, rr.order)
    grown, _ = rr.sched._grow(rr.problem, got1[0], got1[1], N1)
    fetched = nbytes(tuple(slice_fetch()))
    moves = {
        "gather_xs": (cuda_ms(lambda: rr.sched._pod_xs_with_idx(rr.problem, rr.order), 20), 2 * nbytes(xs_g)),
        "grow_state": (cuda_ms(lambda: rr.sched._grow(rr.problem, got1[0], got1[1], N1), 20), nbytes(got1[0]) + nbytes(grown)),
        "slice_decode_state": (cuda_ms(slice_fetch, 20), 2 * fetched),
        "slice_rows": (cuda_ms(lambda: k5_got[2][:u2].cpu(), 20), 2 * u2 * C_d * 4),
    }
    log(
        "data movement at the headline (torch ops; ms, bytes, bound ms): "
        + json.dumps({k: [round(ms, 4), b, round(bound(b, 0)[0], 6)] for k, (ms, b) in moves.items()})
    )

    # ---- 8. the main path at full width: the headline through the runs path ----
    def fresh():
        return scheduler_for(headline_world(HEADLINE_PODS, its), dev)

    sched, pods = fresh()
    t0 = time.monotonic()
    sched.solve(pods)
    torch.cuda.synchronize()
    log(f"warm-up headline solve: {time.monotonic() - t0:.2f}s")
    counted = (T.LAUNCHES, K.LAUNCHES, KR.LAUNCHES)
    sched, pods = fresh()
    for counts in counted:
        for k in counts:
            counts[k] = 0
    t0 = time.monotonic()
    res = sched.solve(pods)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = {k: v for counts in counted for k, v in counts.items()}
    odo = sched.last_odometer
    placed = sum(len(c.pods) for c in res.new_node_claims)
    log(
        f"headline solve on {torch.cuda.get_device_name(0)}: {len(pods)} pods x {len(its)} types in "
        f"{dt:.3f}s = {len(pods) / dt:.1f} pods/s; runs path={sched.last_used_runs} "
        f"claims={len(res.new_node_claims)} placed={placed} errors={len(res.pod_errors)} "
        f"steps={odo['steps']} bulk_steps={odo['bulk_steps']} dispatches={odo['dispatches']} "
        f"regrows={odo['regrows']} claims_opened={odo['claims_opened']} claim_slots={odo['claim_slots']} "
        f"launches={launches}"
    )
    main_kernels = ("typeok_screen", "run_step", "run_arrays", "dedup_rows")
    if not sched.last_used_runs or min(launches[k] for k in main_kernels) < 1 or odo["regrows"] < 1:
        return 1
    if sched.last_relax or launches["run_step_relax"] or odo["tier_steps"]:
        return 1  # the headline has no tiers: the kernels run without the tier loop
    if placed + len(res.pod_errors) != len(pods) or len(res.new_node_claims) == 0:
        return 1
    times = [dt]
    for _ in range(2):
        sched, pods = fresh()
        t0 = time.monotonic()
        sched.solve(pods)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    med = sorted(times)[1]
    log(f"headline solve seconds (n=3): {[round(x, 4) for x in times]}; median {med:.4f}s = {len(pods) / med:.1f} pods/s")

    phases = phase_breakdown(headline_world(HEADLINE_PODS, its), dev)
    log("headline phases (s): " + json.dumps({k: round(v, 4) for k, v in phases.items()}))

    # ---- 9. the scan path, and runs against forced scan at 1000 pods ----
    runs_sched, runs_pods = scheduler_for(headline_world(PARITY_PODS, its), dev)
    runs_snap = results_snapshot(runs_sched.solve(runs_pods), runs_pods)
    scan_sched, scan_pods = scheduler_for(headline_world(PARITY_PODS, its), dev)
    scan_sched.debug_force_scan = True
    for counts in counted:
        for k in counts:
            counts[k] = 0
    scan_snap = results_snapshot(scan_sched.solve(scan_pods), scan_pods)
    torch.cuda.synchronize()
    scan_launches = {k: v for counts in counted for k, v in counts.items()}
    same = runs_snap == scan_snap
    log(
        f"runs vs forced scan, headline-{PARITY_PODS}: {'equal' if same else 'DIFFERENT'} "
        f"(runs path={runs_sched.last_used_runs}, scan path launches={scan_launches})"
    )
    if not same or not runs_sched.last_used_runs or scan_sched.last_used_runs:
        return 1
    if min(scan_launches[k] for k in ("typeok_screen", "scan_step")) < 1:
        return 1

    # decision parity with the port's oracle, solved on the card
    for label, make in (
        (f"headline-{PARITY_PODS}", lambda: headline_world(PARITY_PODS, its)),
        ("mixed", mixed_world),
        ("reserved", reserved_world),
        ("mixed-bulk", mixed_bulk_world),
    ):
        same, n_claims, used_runs = oracle_parity(make(), dev)
        log(f"oracle parity, {label}: {'equal' if same else 'DIFFERENT'} ({n_claims} claims, runs path={used_runs})")
        if not same:
            return 1

    # ---- 10. the relax tier loop: K1 on tier rows, K2 and K3 with relax ----
    # K1 over the c6 mix's tier rows (each relaxable class x tier)
    k1t = k1_rows(c6_world(C6_PODS, its), dev, tier=True)
    k1t_mism = k1_checked("c6 tier rows (relaxable classes x tiers)", k1t)
    if k1t_mism:
        return 1
    k1t_ms = cuda_ms(k1t.launch, 200)
    k1t_plain_ms = cuda_ms(k1t.plain, 20)
    k1t_bound, k1t_by = k1_bound_of(k1t)
    log(f"K1 typeok_screen c6 tier rows: kernel {k1t_ms:.4f} ms, plain {k1t_plain_ms:.4f} ms")

    # K2 with relax on small tiered problems: an overflow mid-ladder (2
    # slots), a tier that fails after the claim screen and verify loop
    # (minValues), and existing nodes + host ports + limits beside tiers
    k2r_mism = 0
    for label, world, N_s in (
        ("pref-24 (2 slots)", preference_world(24, _small_types((2, 8))), 2),
        ("min-values", min_values_world(), None),
        ("mixed+pref", mixed_world(12), None),
    ):
        tb_s, st_s, xs_s = step_inputs(world, dev, N=N_s)
        got = K.solve_scan(tb_s, st_s, xs_s, relax=True)
        bad = scan_mismatches(got, K.solve_scan_plain(tb_s, st_s, xs_s, relax=True))
        torch.cuda.synchronize()
        kinds = got[1].cpu().tolist()
        log(
            f"K2 scan_step+relax {label}: P={xs_s.valid.shape[0]} E={st_s.eavail.shape[0]} N={st_s.active.shape[0]} "
            f"over={bool(got[3])} tier_steps={int(got[4].tier_steps)} tier_hist={got[4].tier_hist.tolist()} "
            f"kinds(existing/claim/new/fail)={[kinds.count(k) for k in range(4)]} mismatches={bad or 'none'}"
        )
        k2r_mism += len(bad)
    if k2r_mism:
        return 1

    # K2 with relax over the preference round at full width, against its
    # plain version; the tier loop's own cost is the round against the same
    # round with every pod held to one trip on its own rows
    tb_p, st_p, xs_p = step_inputs(preference_world(PREF_PODS, its), dev)
    xs_one = xs_p._replace(ntiers=torch.ones_like(xs_p.ntiers))
    k2r_ms = cuda_ms(lambda: K.solve_scan(tb_p, st_p, xs_p, relax=True), 2)
    k2one_ms = cuda_ms(lambda: K.solve_scan(tb_p, st_p, xs_one, relax=True), 2)
    got_p = K.solve_scan(tb_p, st_p, xs_p, relax=True)
    # the plain version on the round's first PREF_CHECK_POSITIONS positions,
    # against the kernel on the same positions
    xs_pc, xs_onec = (cut_positions(x, PREF_CHECK_POSITIONS, axis=0) for x in (xs_p, xs_one))
    got_pc = K.solve_scan(tb_p, st_p, xs_pc, relax=True)
    t0 = time.monotonic()
    want_pc = K.solve_scan_plain(tb_p, st_p, xs_pc, relax=True)
    torch.cuda.synchronize()
    k2r_plain_ms = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    K.solve_scan_plain(tb_p, st_p, xs_onec, relax=True)
    torch.cuda.synchronize()
    k2one_plain_ms = (time.monotonic() - t0) * 1e3
    bad = scan_mismatches(got_pc, want_pc)
    P_p, N_p = xs_p.valid.shape[0], st_p.active.shape[0]
    n_valid_p = int(xs_p.valid.sum())
    pref_trips = int(got_p[4].tier_steps)
    pref_hist = got_p[4].tier_hist.tolist()
    log(
        f"K2 scan_step+relax preference round (P={P_p}, {n_valid_p} pods, N={N_p}): kernel {k2r_ms:.3f} ms "
        f"(one trip a pod: {k2one_ms:.3f} ms), plain on the first {PREF_CHECK_POSITIONS} positions "
        f"{k2r_plain_ms:.1f} ms (one trip a pod: {k2one_plain_ms:.1f} ms), "
        f"over={bool(got_p[3])} tier_steps={pref_trips} tier_hist={pref_hist} mismatches={bad or 'none'}"
    )
    if bad:
        return 1
    # K2's bound as before (inputs, state and outputs once; the (pod, open
    # claim) pairs its screens visit), with the tier tables read once too;
    # the tier loop's bound: what the trips past a pod's first must do at
    # least, read the tier rows of the classes the round uses once (and the
    # batch's rrow/ntiers), and screen every template and existing node
    # against the tier rows on each trip
    is_new = (got_p[1] == K.KIND_NEW).to(torch.int64)
    pairs_p = int((torch.cumsum(is_new, 0) - is_new)[xs_p.valid].sum())
    TWp, Kp, Tp, Ep = tb_p.va.full_mask.shape[0], tb_p.va.num_keys, tb_p.tdaemon.shape[0], st_p.eavail.shape[0]
    k2r_bound, k2r_by = bound(nbytes(tb_p, st_p, xs_p) + nbytes(st_p) + 2 * 4 * P_p, pairs_p * (2 * TWp + 3 * Kp))
    extra_trips = pref_trips - P_p  # every position takes at least one trip
    rt_used = torch.unique(xs_p.rrow[xs_p.valid & (xs_p.ntiers > 1)])
    tier_rows = tuple(a[rt_used] for a in (*tb_p.rt_preq, tb_p.rt_typeok, tb_p.rt_tol_t, tb_p.rt_tol_e, tb_p.rt_kind,
                                           tb_p.rt_gid, tb_p.rt_sel))
    relax_bound, relax_by = bound(nbytes(tier_rows, xs_p.rrow, xs_p.ntiers), extra_trips * (Tp + Ep) * (2 * TWp + 3 * Kp))

    # K3 with relax on small tiered problems: an overflow stop on a tiered
    # pod (64 slots), and existing-node windows beside tiered pods
    k3r_mism = 0
    for label, world, div in (("lonely (64 slots)", lonely_world(), 10_000), ("mixed-bulk+pref", mixed_bulk_world(12), None)):
        rr_s = runs_round(world, dev, div)
        n_s = len(rr_s.order)
        nseq0 = torch.zeros((), dtype=torch.int32, device=dev)
        args_s = (rr_s.tb, rr_s.st, rr_s.rx, rr_s.seq, nseq0, n_s, True)
        got = KR.solve_runs(*args_s)
        bad = runs_mismatches(got, KR.solve_runs_plain(*args_s))
        torch.cuda.synchronize()
        ptr_s = int(got[7])
        log(
            f"K3 run_step+relax {label}: P={rr_s.rx.is_head.shape[0]} n={n_s} N={rr_s.st.active.shape[0]} "
            f"steps={int(got[6].steps)} bulk_steps={int(got[6].bulk_steps)} tier_steps={int(got[6].tier_steps)} "
            f"over={bool(got[5])} ptr={ptr_s} (ntiers there: {int(rr_s.rx.x.ntiers[min(ptr_s, n_s - 1)])}) "
            f"mismatches={bad or 'none'}"
        )
        k3r_mism += len(bad)
    if k3r_mism:
        return 1

    # K3 with relax over the c6 mix's two dispatches, against its plain version
    rr6 = runs_round(c6_world(C6_PODS, its), dev)
    if not rr6.relax:
        return 1
    n6 = len(rr6.order)
    nseq0 = torch.zeros((), dtype=torch.int32, device=dev)
    first6 = (rr6.tb, rr6.st, rr6.rx, rr6.seq, nseq0, n6, True)
    got61 = KR.solve_runs(*first6)
    t0 = time.monotonic()
    want61 = KR.solve_runs_plain(*first6)
    torch.cuda.synchronize()
    k3r_plain_ms = (time.monotonic() - t0) * 1e3
    bad = runs_mismatches(got61, want61)
    ptr61 = int(got61[7])
    N61 = rr6.st.active.shape[0]
    st62, seq62 = rr6.sched._grow(rr6.problem, got61[0], got61[1], N61)
    batch6 = rr6.order[ptr61:]
    xs62, idx62 = rr6.sched._pod_xs_with_idx(rr6.problem, batch6)
    rx62 = rr6.sched._run_x(xs62, idx62, len(batch6))
    cont6 = (rr6.tb, st62, rx62, seq62, got61[2], len(batch6), True)
    # K4 on the c6 mix's two rounds
    cls6, (bulk6, aff6) = rr6.sched._dev_tables["cls"], rr6.sched._runflags_dev
    _, idx61 = rr6.sched._pod_xs_with_idx(rr6.problem, rr6.order)
    k4_args6 = (cls6, bulk6, aff6, idx61, n6)
    k4_rounds.update({"c6 round 1": k4_args6, "c6 round 2": (cls6, bulk6, aff6, idx62, len(batch6))})
    k4c6_bad = [
        label for label, args in k4_rounds.items() if label.startswith("c6")
        and not all(torch.equal(a, b) for a, b in zip(T.run_arrays(*args), T.run_arrays_plain(*args)))
    ]
    log(f"K4 run_arrays c6 rounds (P={idx61.shape[0]}, {idx62.shape[0]}): mismatches={k4c6_bad or 'none'}")
    if k4c6_bad:
        return 1
    got62 = KR.solve_runs(*cont6)
    t0 = time.monotonic()
    want62 = KR.solve_runs_plain(*cont6)
    torch.cuda.synchronize()
    k3r_plain_ms += (time.monotonic() - t0) * 1e3
    bad += runs_mismatches(got62, want62)
    k3r_ms = cuda_ms(lambda: KR.solve_runs(*first6), 3) + cuda_ms(lambda: KR.solve_runs(*cont6), 3)
    c6_trips = int(got61[6].tier_steps) + int(got62[6].tier_steps)
    log(
        f"K3 run_step+relax c6: dispatch 1 N={N61} stops at ptr={ptr61} (steps={int(got61[6].steps)}, "
        f"bulk_steps={int(got61[6].bulk_steps)}, tier_steps={int(got61[6].tier_steps)}); dispatch 2 N={2 * N61} over "
        f"{len(batch6)} pods (steps={int(got62[6].steps)}, bulk_steps={int(got62[6].bulk_steps)}, "
        f"tier_steps={int(got62[6].tier_steps)}, over={bool(got62[5])}); kernel {k3r_ms:.3f} ms, "
        f"plain {k3r_plain_ms:.1f} ms, mismatches={bad or 'none'}"
    )
    if bad or not bool(got61[5]):
        return 1
    R6 = rr6.tb.ialloc.shape[1]
    # K5 on the c6 mix's final claim state
    st6 = got62[0]
    n26 = min(_pow2(max(int(st6.n_claims), 1), floor=64), st6.active.shape[0])
    k5c6_bad = dedup_mismatches(T.dedup_decode_state(st6, n26), T.dedup_columns_plain(T.decode_columns(st6), n26))
    torch.cuda.synchronize()
    log(f"K5 dedup_rows c6 final state (n2={n26}): mismatches={k5c6_bad or 'none'}")
    if k5c6_bad:
        return 1

    # ---- 10b. the per-phase clock breakdown of K3 and K2 ----
    # each profiled launch is held bit for bit to the same launch without it
    t0 = time.monotonic()
    bd_bad = []
    for label, kernel, launches_, mism in (
        ("K3 headline", "run_step", [lambda p, a=a: KR.solve_runs(*a, prof=p) for a in (first_args, cont_args)],
         runs_mismatches),
        ("K3+relax c6", "run_step", [lambda p, a=a: KR.solve_runs(*a, prof=p) for a in (first6, cont6)],
         runs_mismatches),
        ("K2 headline prefix", "scan_step", [lambda p: K.solve_scan(tb_h, st_h, xs_h, prof=p)], scan_mismatches),
    ):
        bd, bad = clock_breakdown(kernel, launches_, mism, dev)
        bd_bad += bad
        log(f"clock breakdown {label} ({kernel}; profiled vs plain launch: {bad or 'equal'}): {json.dumps(bd)}")
    log(f"clock breakdown phase: {time.monotonic() - t0:.1f}s")
    if bd_bad:
        return 1
    k3r_bound, k3r_by = bound(
        nbytes(rr6.tb, rr6.st, rr6.rx) + nbytes(st62) + nbytes(rx62) + 2 * 4 * (n6 + len(batch6)),
        int(got61[6].steps) * N61 * (R6 + IW) + int(got62[6].steps) * 2 * N61 * (R6 + IW),
    )

    # ---- 11. the c6 mix end to end: the runs path with the tier loop ----
    def fresh6():
        return scheduler_for(c6_world(C6_PODS, its), dev)

    sched, pods = fresh6()
    t0 = time.monotonic()
    sched.solve(pods)
    torch.cuda.synchronize()
    log(f"warm-up c6 solve: {time.monotonic() - t0:.2f}s")
    sched, pods = fresh6()
    for counts in counted:
        for k in counts:
            counts[k] = 0
    t0 = time.monotonic()
    res = sched.solve(pods)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches6 = {k: v for counts in counted for k, v in counts.items()}
    odo6 = sched.last_odometer
    placed = sum(len(c.pods) for c in res.new_node_claims)
    log(
        f"c6 solve on {torch.cuda.get_device_name(0)}: {len(pods)} pods x {len(its)} types in {dt:.3f}s = "
        f"{len(pods) / dt:.1f} pods/s; runs path={sched.last_used_runs} relax={sched.last_relax} "
        f"claims={len(res.new_node_claims)} placed={placed} errors={len(res.pod_errors)} "
        f"odometer={json.dumps({k: odo6[k] for k in C6_JAX_ODOMETER})} launches={launches6}"
    )
    odo_diff = {k: (odo6[k], v) for k, v in C6_JAX_ODOMETER.items() if odo6[k] != v}
    log(f"c6 odometer vs the JAX package's: {'equal' if not odo_diff else f'DIFFERENT {odo_diff}'}")
    if odo_diff or not (sched.last_used_runs and sched.last_relax):
        return 1
    if launches6["typeok_screen"] < 2 or min(launches6[k] for k in ("run_step_relax", "run_arrays", "dedup_rows")) < 1:
        return 1
    if launches6["run_step"] or placed + len(res.pod_errors) != len(pods):
        return 1
    times6 = [dt]
    for _ in range(2):
        sched, pods = fresh6()
        t0 = time.monotonic()
        sched.solve(pods)
        torch.cuda.synchronize()
        times6.append(time.monotonic() - t0)
    med6 = sorted(times6)[1]
    log(f"c6 solve seconds (n=3): {[round(x, 4) for x in times6]}; median {med6:.4f}s = {len(pods) / med6:.1f} pods/s")
    phases6 = phase_breakdown(c6_world(C6_PODS, its), dev)
    log("c6 phases (s): " + json.dumps({k: round(v, 4) for k, v in phases6.items()}))

    # the preference round end to end: the scan path with the tier loop
    pref_sched, pref_pods = scheduler_for(preference_world(PREF_PODS, its), dev)
    pref_sched.debug_force_scan = True
    for counts in counted:
        for k in counts:
            counts[k] = 0
    t0 = time.monotonic()
    res = pref_sched.solve(pref_pods)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    pref_launches = {k: v for counts in counted for k, v in counts.items()}
    podo = pref_sched.last_odometer
    log(
        f"preference round solve (forced scan): {len(pref_pods)} pods in {dt:.3f}s; relax={pref_sched.last_relax} "
        f"claims={len(res.new_node_claims)} errors={len(res.pod_errors)} steps={podo['steps']} "
        f"tier_steps={podo['tier_steps']} tier_hist={podo['tier_hist']} dispatches={podo['dispatches']} "
        f"launches={pref_launches}"
    )
    if pref_sched.last_used_runs or not pref_sched.last_relax or pref_launches["scan_step_relax"] < 1:
        return 1
    if pref_launches["scan_step"] or res.pod_errors:
        return 1

    # c6: runs against forced scan, and decisions against the oracle
    runs_sched, runs_pods = scheduler_for(c6_world(PARITY_PODS, its), dev)
    runs_snap = results_snapshot(runs_sched.solve(runs_pods), runs_pods)
    scan_sched, scan_pods = scheduler_for(c6_world(PARITY_PODS, its), dev)
    scan_sched.debug_force_scan = True
    same = runs_snap == results_snapshot(scan_sched.solve(scan_pods), scan_pods)
    log(f"runs vs forced scan, c6-{PARITY_PODS}: {'equal' if same else 'DIFFERENT'} (runs path={runs_sched.last_used_runs})")
    if not same or not runs_sched.last_used_runs or not runs_sched.last_relax:
        return 1
    for label, make in (
        (f"c6-{C6_PARITY_PODS}", lambda: c6_world(C6_PARITY_PODS, its)),
        ("pref-24", lambda: preference_world(24, _small_types((2, 8)))),
        ("min-values", min_values_world),
        ("mixed+pref", lambda: mixed_world(12)),
        ("lonely", lonely_world),
        ("mixed-bulk+pref", lambda: mixed_bulk_world(12)),
    ):
        t0 = time.monotonic()
        same, n_claims, used_runs = oracle_parity(make(), dev)
        log(
            f"oracle parity, {label}: {'equal' if same else 'DIFFERENT'} ({n_claims} claims, runs path={used_runs}, "
            f"{time.monotonic() - t0:.1f}s)"
        )
        if not same:
            return 1

    # ---- 11a. the provisioning entry point: Provisioner.reconcile at full
    # width, its decisions against the oracle's, the small-batch crossover ----
    entry = entry_point_phase(dev, its)
    if entry is None or not decisions_phase(dev, its):
        return 1
    crossover = crossover_phase(dev, its)
    if crossover is None:
        return 1

    # ---- 11b. existing nodes, host ports, limits, reservations and
    # minValues at full size; a catalog past the shared-memory budget ----
    full = full_size_phase(dev)
    if full is None:
        return 1

    # ---- 12. the consolidation sweeps (K6, K7, K8) ----
    c4_fleet = fleets[0]
    c4_digest = fleet_digest(c4_fleet)
    sweep_rows = sweep_phase(dev, fleets)
    del fleets
    if sweep_rows is None:
        return 1

    # ---- 12b. the consolidation controllers on the c4 fleet ----
    consolidation = consolidation_phase(dev, c4_fleet, c4_digest, snc_fleet)
    del c4_fleet, snc_fleet
    if consolidation is None:
        return 1

    # ---- 13. fleet lanes (K7 with each lane's own pod rows) ----
    fleet_row = fleet_phase(dev, its)
    if fleet_row is None:
        return 1

    # ---- 13b. the solver sidecar on the card: epochs, the table cache on
    # the device, a fleet window over the wire, the ResilientSolver ----
    sidecar = sidecar_phase(dev, its, entry["claims_view"])
    if sidecar is None:
        return 1

    # ---- 13c. process start: fresh processes' first solve with and without
    # the prewarm, the sidecar's prewarm; then the Operator's control loop ----
    cold = cold_start_phase(dev, its, med)
    if cold is None:
        return 1
    operator = operator_phase(dev, its, oracle)
    if operator is None:
        return 1

    # ---- 14. K1, K4 and K5 apart: device time (profiler) and the wrapper's
    # host time a call, beside the launch floor (an empty kernel) ----
    floor = {"device_ms": device_ms(lambda: T.empty_launch(dev), 200, ("empty_kernel",)),
             "host_ms": host_ms(lambda: T.empty_launch(dev), 200)}
    log(f"launch floor (empty kernel, a launch): {json.dumps(floor)}")
    small = {
        "typeok_screen": (k1h.launch, ("typeok_kernel",)),
        "typeok_screen (tier rows)": (k1t.launch, ("typeok_kernel",)),
        "typeok_screen (large catalog)": (full["k1_large"].launch, ("typeok_kernel",)),
        "run_arrays": (lambda: T.run_arrays(*k4_args), ("run_arrays_kernel",)),
    }
    apart = {k: {"device_ms": device_ms(fn, 200, names), "host_ms": host_ms(fn, 200)} for k, (fn, names) in small.items()}
    # K5 as the decode calls it: every device kernel of the call
    def k5_call():
        return T.dedup_decode_state(st_final, n2)

    k5_trace = device_trace(k5_call, 200)
    # up to 8192 rows the decode's dedup is one kernel launch and nothing
    # else (a trace may miss a few of the 200 launches: time a launch); a
    # trace with no device event shows nothing and fails too
    if len(k5_trace) != 1 or next(iter(k5_trace.values()))[1] > 1:
        log(f"K5: the decode's dedup is not one kernel launch a call in the trace: {json.dumps(k5_trace)}")
        return 1
    apart["dedup_rows"] = {"device_ms": next(ms / k for ms, k in k5_trace.values()),
                           "host_ms": host_ms(k5_call, 200), "device_kernels": k5_trace}
    log(f"device and host ms a call: {json.dumps(apart)}")

    # ---- 14b. a failure of the card inside a solve is not hidden by the
    # hybrid scheduler's last-resort guard (last: it fills the card) ----
    if not device_failure_check(dev, its):
        return 1

    # ---- 15. the kernels line ----
    kernels = [
        row("typeok_screen", "typeok.cu", "karpenter_tpu/solver/tpu.py:61", launches["typeok_screen"], k1_mism,
            k1_ms, k1_plain_ms, k1_bound, k1_by),
        row("scan_step", "scan_step.cu", "karpenter_tpu/solver/tpu_kernel.py:931", scan_launches["scan_step"],
            k2_mism, k2_ms, k2_plain_ms, k2_bound, k2_by),
        row("run_step", "run_step.cu", "karpenter_tpu/solver/tpu_runs.py:319", launches["run_step"], k3_mism,
            k3_ms, k3_plain_ms, k3_bound, k3_by),
        row("run_arrays", "run_arrays.cu", "karpenter_tpu/solver/tpu.py:155", launches["run_arrays"], k4_mism,
            k4_ms, k4_plain_ms, k4_bound, k4_by),
        row("dedup_rows", "dedup_rows.cu", "karpenter_tpu/solver/tpu.py:264", launches["dedup_rows"], len(k5_bad),
            k5_ms, k5_plain_ms, k5_bound, k5_by, k5_lib_ms),
        # K1 on the tier rows: its launches are the c6 solve's (class rows
        # and tier rows)
        row("typeok_screen (tier rows)", "typeok.cu", "karpenter_tpu/solver/tpu.py:982", launches6["typeok_screen"],
            k1t_mism, k1t_ms, k1t_plain_ms, k1t_bound, k1t_by),
        dict(row("scan_step+relax", "scan_step.cu", "karpenter_tpu/solver/tpu_kernel.py:932",
                 pref_launches["scan_step_relax"], k2r_mism, k2r_ms, k2r_plain_ms, k2r_bound, k2r_by),
             plain_positions=PREF_CHECK_POSITIONS),
        row("run_step+relax", "run_step.cu", "karpenter_tpu/solver/tpu_runs.py:358", launches6["run_step_relax"],
            k3r_mism, k3r_ms, k3r_plain_ms, k3r_bound, k3r_by),
        # the tier loop inside K2 and K3: it runs in every relax launch of
        # the two main paths above; its time is the preference round's trips
        # past each pod's first (the round against one trip a pod)
        dict(
            row("relax_step", "step.cuh", "karpenter_tpu/solver/tpu_kernel.py:898",
                launches6["run_step_relax"] + pref_launches["scan_step_relax"], k2r_mism + k3r_mism,
                k2r_ms - k2one_ms, k2r_plain_ms - k2one_plain_ms, relax_bound, relax_by),
            tier_steps={"preference_round": pref_trips, "c6": c6_trips},
            tier_hist={"preference_round": pref_hist, "c6": odo6["tier_hist"]},
            plain_positions=PREF_CHECK_POSITIONS,
        ),
    ] + sweep_rows + [fleet_row]
    for r in kernels:
        r.update(apart.get(r["name"], {}))
        if r["name"] in CONSOLIDATION_ROWS:
            r["launches_consolidation"] = sum(consolidation["launches"].get(k, 0) for k in CONSOLIDATION_ROWS[r["name"]])
        r["launches_sidecar"] = sum(sidecar["launches"].get(k, 0) for k in SIDECAR_ROWS.get(r["name"], ()))
        r["launches_operator"] = sum(operator["launches"].get(k, 0) for k in ROW_COUNTERS.get(r["name"], ()))
        r["launches_prewarm"] = sum(cold["launches_prewarm"].get(k, 0) for k in ROW_COUNTERS.get(r["name"], ()))
    log(f"chip_smoke: {time.monotonic() - t_start:.1f}s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _small_types(sizes=(2, 8, 32)):
    from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types

    return construct_instance_types(sizes=list(sizes))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--cold-start":
        sys.exit(cold_start_worker(sys.argv[2]))
    if len(sys.argv) == 2 and sys.argv[1] == "--operator-oracle":
        sys.exit(operator_oracle_worker())
    sys.exit(main())
