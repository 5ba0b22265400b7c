#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (karpenter_tpu_torch).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the eight CUDA kernels from csrc/ and holds each against its plain
PyTorch version, bit for bit: on the card, or, for the five deepest checks
(K2's 2048-pod headline prefix, the preference round's first 1000
positions and the full-size screens world's 2048, K7 on all 64 positions
of the sweep lanes and the first 256 of the fleet lanes), in a process of
its own beside the card's phases (`--host-checks`, HostChecks): the main
process writes the cut's inputs and the kernel's outputs to build/, the
side process runs the plain version on the CPU and writes its verdict,
and a mismatch, a missing verdict or a dead side process fails the run.
The same side process takes the fuzz cases' oracle snapshots first. Every
check that is host work alone against a referee (the sweep lanes' sequential
referee, the oracle parities, the fleet lanes' and the decisions phase's
oracle) runs in a child forked off the main process (HostChecks.fork: the
objects as they are, no rebuild), beside the card's phases; its verdict is
read at the end like the side process's.

- K1 typeok_screen on the headline's class rows, the c6 mix's tier rows,
  the full-size screens world's class rows and a 2048-type catalog's;
- K2 scan_step on three small problems and a 2048-pod prefix of the
  headline round (the whole round is timed too), and with the relax tier
  loop on three small tiered problems (one overflows mid-ladder) and the
  first 1000 positions of the 1000-pod preference round, with its ladders
  and with one trip a pod (the whole round is timed);
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
  carry a zone spread (every position of every lane);
- K7 scan_lanes as the fleet launch (each lane's pod rows its own) on the
  first 256 positions of 8 fleet lanes of 2000 pods, relax off and on;
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

After the K3 checks, the runs-path stall case (`fixtures.runs_stall_case`:
the c6 mix's 50 pods over 40 KWOK types, and the two pods `fuzz.shrink` left
of it), on which a walk that dropped a bulk head's exclusions spun: K3
relax off and on, each launch given STALL_LAUNCH_SECONDS before the run
fails, held bit for bit to the plain walk with its stall counter 0, and
solve_in_process on the card equal to the port's oracle. Then the fuzz
phase: FUZZ_SEEDS seeded cases, the corpus of tests/fuzz_corpus and the
shrunk stall case through the port's `fuzz.check_parity` on the card (the
kernel path, a forced scan solve, a tight claim-slot pool, relax off)
against the side process's oracle snapshots, and every case through
`fuzz.solve_hybrid` with no invariant or odometer violation.

Then it drives the provisioning solve end to end, each path with the launch
counts set to 0 just before and read just after: the headline
(make_diverse_pods(10000) against 500 KWOK instance types on one default
NodePool) through the runs path; the scan path (`debug_force_scan`) at 1000
pods, whose decisions must equal the runs path's; the c6 realistic mix
(bench.py `pods_realistic(10000)`: 98% diverse, a 2% tail of preference
pods) through the runs path with the tier loop, whose odometer must equal
the JAX package's; and the 1000-pod preference round through the scan path
with the tier loop; then BASELINE.json's provisioning configs at full width
(`baseline_phase`, karpenter_tpu_torch/testing/configs.py: c1 500 pods of
requests only on 50 types, c2 10000 pods with zone nodeSelectors and a
toleration under a default and a tainted NodePool, c3 5000 pods half zone
spread and half hostname anti-affinity under a three-zone NodePool, c5 50000
pods of the diverse mix on 1000 types), each solve equal to the JAX
package's (BASELINE_JAX: path, claims, errors, odometer and the decisions'
digest, recorded by tools/reference_configs.py), also through
solve_in_process and with every launch table in device memory, c1's and
c2's partitions equal to the port's oracle and K5 on the decodes of c3 and
c5 equal to its plain version in the side process, each config's median
pods/s, host phases and peak device bytes; then the provisioning entry
point: Provisioner.reconcile()
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
cost; and a fault segment: the port's FaultyProxy between a
ResilientSolver and a server on the card, a 1000-pod c6 mix a solve
(K1, K4, K3, K5), each fault once (a blackhole and a delay past the
client's deadline, a truncated and a corrupted answer, the server stopped
with a solve in flight), each followed by a clean solve from the sidecar
equal to the in-process solve, the breaker opening and closing again; the
whole phase runs under the port's race witness (no lock-order inversion,
no thread exception, the long holds printed with their creation sites)
and protocol recorder, whose trace must refine the port's protocol model
(karpenter_tpu_torch/analysis/proto.py); last, a solve with every free
byte of the card held
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
(equal claims, first Command and final nodes); process A's prewarm also
launches K7 at each fleet lane bucket, and a 2-lane fleet window after it
needs no nvcc, library load or new allocator segment. Then the gates phase
(`gates_phase`): the paths that ran only on the CPU before, at full width,
each held to a referee — a consolidation replace Command on a 2000-node
fleet through K8, K6, K6's singleton lanes and the kernel route, vetoed by
the Validator's re-simulation on the kernels once pending pods need more
new claims than it replaces, then carried through by the lifecycle and
termination controllers; Drift, Emptiness and the Validator's emptiness
veto on a fleet of the c4 shape, StaticDrift's reservations; the Operator
with all five feature gates on (a static pool drifted and scaled down, a
price and a capacity NodeOverlay, pods that request the extended resource,
nodes repaired) against the oracle's Operator in a process of its own; and
the table cache across an overlay change. Then the runtime budgets
(phase 14c, karpenter_tpu_torch/analysis/runtime.py against
torch_budgets.json): every CPU-scope entry measured on the card, where it
must read what it reads on the CPU, and every `cuda:` entry: a profiled
window around each entry's repeat whose hand-kernel records equal the
wrappers' count, the headline and the c6 mix re-solved under the profiler,
each kernel's ptxas resources; one {"budgets": ...} line, and any finding
fails the run. The side process that runs the deep plain checks also runs
the analysis's AST and race tiers (`python -m karpenter_tpu_torch.analysis
--ast`, `--race`) over the shipped tree: a finding outside their baselines
fails the run. It checks decisions against the port's oracle on twelve
problems, and prints:

- the card's name and power limit (nvidia-smi),
- one JSON line {"kernels": [...]} with each kernel's launches on its path
  (and on the consolidation, sidecar, Operator, prewarm and gates paths, and
  apart those of the sidecar's fault segment), its
  agreement with the plain version, and its times,
- as the last line, {"ok": true, "device": {...}}.

Any failed phase exits non-zero without the last line. Without a CUDA
device, or outside the repository, it exits non-zero at once.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import time
from typing import NamedTuple, Optional

HEADLINE_PODS = 10000
HEADLINE_TYPES = 500
PARITY_PODS = 1000
# headline pods K2 is held against its plain version on (the side process's
# check: HostChecks)
K2_PREFIX = 2048
C6_PODS = 10000
C6_PARITY_PODS = 2000  # c6 pods solved by the oracle too
PREF_PODS = 1000  # the preference round (every pod tiered)
# positions of the preference round K2+relax is held to its plain version on
# (the plain tier loop takes about 50 ms a position; the side process's check)
PREF_CHECK_POSITIONS = 1000
# The JAX package's kernel odometer for the c6 solve (bench.py
# build_universe(500) + make_problem(10000, its, pods_realistic), the same
# construction as c6_world): recorded with `JAX_PLATFORMS=cpu python3
# tools/reference_odometer.py` on a CPU. Structure counts, not speeds.
C6_JAX_ODOMETER = {
    "steps": 1709, "bulk_steps": 1019, "tier_steps": 1290, "tier_hist": [690, 200, 200, 200, 0, 0, 0, 0],
    "dispatches": 2, "overflow_signals": 1, "regrows": 1, "claims_opened": 1962, "claim_slots": 2048,
}
# the baseline configs phase (baseline_phase): BASELINE.json's provisioning
# configs at their full widths (karpenter_tpu_torch.testing.configs), each
# held to the JAX package's solve of the same problem, recorded with
# `JAX_PLATFORMS=cpu python3 tools/reference_configs.py` on a CPU: the path,
# the claim and error counts, the odometer's structure counts and the
# decisions' digest (`fuzz.snapshot_digest` of `fuzz.results_snapshot`)
BASELINE_JAX = {
    "c1_500x50_requests_only": {
        "runs_path": True, "relax": False, "claims": 61, "errors": 0,
        "odometer": {"steps": 95, "bulk_steps": 95, "tier_steps": 0, "tier_hist": [0, 0, 0, 0, 0, 0, 0, 0],
                     "dispatches": 1, "overflow_signals": 0, "regrows": 0, "claims_opened": 61, "claim_slots": 64},
        "digest": "ff25145c1488aecafc30934bd9602e3a69e83a5bf581f05be6e50770f8990bbb",
    },
    "c2_10kx500_selector_taints": {
        "runs_path": True, "relax": False, "claims": 68, "errors": 0,
        "odometer": {"steps": 1271, "bulk_steps": 1271, "tier_steps": 0, "tier_hist": [0, 0, 0, 0, 0, 0, 0, 0],
                     "dispatches": 1, "overflow_signals": 0, "regrows": 0, "claims_opened": 68, "claim_slots": 1024},
        "digest": "c8c118b517ee5184e206fee19042a74bc5407876e6ba114df3707fed072e4602",
    },
    "c3_5k_topology_heavy": {
        "runs_path": True, "relax": False, "claims": 2500, "errors": 0,
        "odometer": {"steps": 656, "bulk_steps": 293, "tier_steps": 0, "tier_hist": [0, 0, 0, 0, 0, 0, 0, 0],
                     "dispatches": 4, "overflow_signals": 3, "regrows": 3, "claims_opened": 2500, "claim_slots": 4096},
        "digest": "f6368f2d1ab56a8f17480e56b45d32b040b2ef3940f2e4e792beaa242232976d",
    },
    "c5_50kx1k_mixed": {
        "runs_path": True, "relax": False, "claims": 10000, "errors": 0,
        "odometer": {"steps": 3107, "bulk_steps": 1512, "tier_steps": 0, "tier_hist": [0, 0, 0, 0, 0, 0, 0, 0],
                     "dispatches": 3, "overflow_signals": 2, "regrows": 2, "claims_opened": 10000,
                     "claim_slots": 16384},
        "digest": "8cfa1f7e187fd030e478c0b06d0de024df350155c10df97b0e2848184d1cbda1",
    },
}
# the configs whose full-width solve the port's oracle referees in the side
# process (the others' oracle takes longer than the run: their referee is
# the JAX package's digest)
BASELINE_ORACLE = ("c1_500x50_requests_only", "c2_10kx500_selector_taints")
BASELINE_TIMED = 1  # timed solves a config (the median's): one, for the run's clock
# past this many seconds of the run, the largest config takes one timed solve
BASELINE_LATE_S = 1000.0
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
# version (the plain version takes about half a second a position; the
# side process's check)
LANE_CHECK_POSITIONS = 64
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
# version with relax on takes about half a second a position; the side
# process's check)
FLEET_CHECK_POSITIONS = 256
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
# (of its 2048; the plain version takes about 9 ms a position; the side
# process's check)
FULL_K2_CHECK_POSITIONS = 2048
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
ENTRY_TIMED = 1  # timed entry-point reconciles (each on a fresh 10100-pod cluster)
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
    "run_step+relax": ("run_step_relax",),
}
# the sidecar phase runs under the port's race witness (its holds past
# SIDECAR_LONG_HOLD_MS printed with their creation sites) and protocol
# recorder, whose trace the port's judge reads (proto.check_refinement)
SIDECAR_LONG_HOLD_MS = 50.0
# its fault segment (sidecar_faults): the port's FaultyProxy between a
# ResilientSolver and a SolverServer on the card, c6_world(FAULT_PODS) a
# solve (above tpu_min_pods: K1, K4, K3), each fault of FAULT_SCHEDULE once
# and a clean solve after each; the decode's dedup goes through K5 here
# (`_DEDUP_DECODE_MIN` lowered: these solves open about 200 claims)
FAULT_PODS = 1000
FAULT_SCHEDULE = ("blackhole", "truncate", "corrupt", "delay", "stop")
FAULT_WIRE_TIMEOUT = 5.0  # the client's deadline: a clean solve takes about 1 s over the wire
FAULT_COOLDOWN = 30.0  # the breaker's cooldown, on the segment's own clock
FAULT_BUDGET_S = 60.0  # the segment's time on the main process
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
PREWARM_FLEET_BUCKETS = (2, 8)  # the lane buckets of A's prewarm (a fleet-serving sidecar's K7 combos)
OPERATOR_TICKS = 24  # the tick budget of each half of the Operator's run
# (c)'s oracle side runs in a process of its own from the end of the build
# (about 320 s of host on the card's machine: each provisioning round
# re-solves every pending pod against the in-flight nodes on the oracle);
# the seconds (c) then waits for it at most
OPERATOR_ORACLE_TIMEOUT = 600.0
OPERATOR_CLAIM_SEQ0 = 50000  # (c)'s claims are named from here on both sides
OPERATOR_FLEET_NODES = 200  # the under-utilized fleet whose consolidation runs the sweeps
OPERATOR_STILL_TICKS = 10  # ticks the node set holds still to end the run
# the gates phase (gates_phase, after phase 14): (a) a replace Command on a
# fleet of REPLACE_FLEETS[0]'s shape (tests/test_torch_consolidation.py) at
# SWEEP_NODES nodes, vetoed by the Validator's re-simulation once
# GATES_VETO_PODS pending pods of GATES_VETO_REQUESTS (hostname
# anti-affinity among them) need more new claims than it replaces, then
# carried through by the lifecycle and termination controllers, a tick of
# GATES_TICK_S at a time, at most GATES_ROUND_TRIP_TICKS; (b) Drift and
# Emptiness (GATES_EMPTIED nodes emptied) on a fleet of the c4 shape, and
# StaticDrift's reservations at replicas 2 by nodes limit, pinned as the
# CPU test pins them
GATES_FLEET = {"seed": 11, "rider_requests": {"cpu": "1200m", "memory": "256Mi"},
               "seed_requests": {"cpu": "1500m", "memory": "512Mi"}}
GATES_VETO_PODS = 2
GATES_VETO_REQUESTS = {"cpu": "6", "memory": "1Gi"}
GATES_TICK_S = 2.0
GATES_ROUND_TRIP_TICKS = 20
GATES_EMPTIED = 10
STATIC_DRIFT_PINS = {None: 2, "3": 1, "2": 0}
# (c) the Operator with every feature gate on at DECISIONS_PODS, beside a
# static pool of GATED_STATIC[0] replicas scaled to GATED_STATIC[1], a
# NodeOverlay of GATED_PRICE on one instance family (then changed, for the
# table cache), and one giving GATED_GPU (family, resource, count a node)
# to another (then GATED_GPU_AFTER), requested by every GATED_GPU_EVERY-th
# c6 pod; every GATED_REPAIR_EVERY-th node of the dynamic pool goes
# Ready=False; after the settle each step ticks GATED_TICK_S seconds at
# most GATED_TICKS times; its oracle side (`--gates-oracle`) runs in a
# process of its own from the end of the build
GATED_STATIC = (8, 4)
GATED_PRICE = ("c", "-50%", "-40%")
GATED_GPU = ("m", "example.com/gpu", 4)
GATED_GPU_AFTER = 8
GATED_GPU_EVERY = 100
GATED_REPAIR_EVERY = 20
GATED_TICK_S = 16.0
GATED_TICKS = 60
GATES_CLAIM_SEQ0 = 70000  # (c)'s claims are named from here on both sides
GATES_STATIC_SEQ0 = 7000  # and its static claims and drift replacements from here
# the side process (HostChecks, `--host-checks`): the oracle's snapshots of
# the fuzz cases, then the plain versions of the five deep checks on the CPU
# against the card's outputs; its torch threads, and the seconds the main
# process waits for its verdicts at the end at most
HOST_CHECK_THREADS = 2
HOST_CHECKS_TIMEOUT = 600.0
# the referee checks forked off the main process (HostChecks.fork): at most
# this many children at once (each a copy-on-write image of the main
# process's heap)
FORK_LIMIT = 2
# the fuzz phase (fuzz_phase): seeds from fuzz.fuzz_seed_base(), the corpus
# of tests/fuzz_corpus and the shrunk runs-path stall case
FUZZ_SEEDS = 64  # 64 seeds, for the run's clock
# the stall phase (stall_phase): the seconds a K3 launch on the stall case
# may take before the run fails
STALL_LAUNCH_SECONDS = 60.0
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
    from karpenter_tpu_torch.testing import configs

    return configs.build_universe(n_types)


class World(NamedTuple):
    """One problem as a caller hands it to the scheduler."""

    pools: list
    ibp: dict
    pods: list
    views: Optional[list]
    options: object
    topo: object


def baseline_world(name: str) -> World:
    """A BASELINE.json config at its full width (testing/configs.py)."""
    from karpenter_tpu_torch.testing import configs

    pools, ibp, pods, topo = configs.build(name)
    return World(pools, ibp, pods, None, None, topo)


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

    return fixtures.c6_pods(n_pods)


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


def oracle_mismatches(world: World, *gots) -> list[str]:
    """The port's oracle on a world against solves' snapshots of it: the
    ones that differ (by position)."""
    from karpenter_tpu_torch.solver.oracle import Scheduler

    oracle = Scheduler(world.pools, world.ibp, world.topo, world.views, None, world.options)
    want = results_snapshot(oracle.solve(world.pods), world.pods)
    return [f"solve {k} differs from the oracle's" for k, got in enumerate(gots) if got != want]


def oracle_parity(world: World, dev, host: "HostChecks", label: str) -> tuple[int, bool]:
    """Solve a world with TorchScheduler on `dev`, and hand the port's
    oracle's solve of a deep copy of it to a forked check
    (`oracle parity, <label>`); (the solve's claim count, whether it took
    the runs path)."""
    twin = copy.deepcopy(world)
    sched, pods = scheduler_for(world, dev)
    got = results_snapshot(sched.solve(pods), pods)
    host.fork(f"oracle parity, {label}", oracle_mismatches, twin, got)
    return len(got[0]), sched.last_used_runs


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
    """Field names where two solve_runs results differ (the counter block
    holds the overflow flag, ptr, the odometer and the stall counter)."""
    import torch

    bad = state_mismatches(got[0], want[0])
    for i, name in ((1, "seq"), (2, "next_seq"), (3, "kinds"), (4, "slots"), (5, "counters")):
        if not torch.equal(got[i], want[i]):
            bad.append(name)
    return bad


class RunsStatus(NamedTuple):
    over: bool
    ptr: int
    stalled: bool
    steps: int
    bulk_steps: int
    tier_steps: int


def runs_status(got) -> RunsStatus:
    """The counter block of a solve_runs result, fetched once."""
    from karpenter_tpu_torch.solver import tpu_kernel as K

    over, ptr, stalled, odo = K.counter_fields(got[5].tolist())
    return RunsStatus(over, ptr, stalled, odo["steps"], odo["bulk_steps"], odo["tier_steps"])


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
        st, seq, nseq, got_k, got_s, counters = KR.solve_runs(tb, st, rx, seq, nseq, len(batch), relax)
        over, ptr, _, _ = K.counter_fields(counters.tolist())
        n_done = ptr if over else len(batch)
        kinds[batch[:n_done]] = got_k[:n_done].cpu().numpy()
        slots[batch[:n_done]] = got_s[:n_done].cpu().numpy()
        if over:
            st, seq = sched._grow(problem, st, seq, N)
            N *= 2
            offset += n_done
        mark("run_step_dispatches_regrow")
        if not over:
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
        rs = runs_status(got)
        out["steps"].append([rs.steps, rs.bulk_steps, rs.tier_steps])
        done = rs.ptr if rs.over else len(batch)
        out["kinds"] += got[3][:done].cpu().tolist()
        if not rs.over:
            out["held_bits"] = int(D.popcount(got[0].held).sum())
            break
        st, seq = rr.sched._grow(rr.problem, got[0], got[1], N)
        N, offset, nseq = 2 * N, offset + done, got[2]
    out.update(relax=rr.relax, E=rr.st.eavail.shape[0], N0=rr.st.active.shape[0], HPW=rr.st.hp_used.shape[1],
               NRES=rr.st.rescap.shape[0], I=rr.tb.ialloc.shape[0], O=rr.tb.otype.shape[0],
               TW=rr.tb.va.full_mask.shape[0])
    return out


def scan_checked(world: World, dev, n_slots: int, device_tables: bool = False, prefix: Optional[int] = None,
                 host: Optional["HostChecks"] = None, name: str = "") -> dict:
    """K2 over a world's first round (its first `prefix` pods, or all) with
    `n_slots` claim slots (the tier loop on when the round has tiers), held
    bit for bit to its plain version (with `host`, the side process's check
    `name`, and plain_ms None); with `device_tables` a second launch reads
    every table from device memory and is held to the same result."""
    import torch

    from karpenter_tpu_torch.solver import tpu_kernel as K

    tb, st, xs = step_inputs(world, dev, prefix=prefix, N=n_slots)
    relax = bool((xs.ntiers > 1).any())
    got = K.solve_scan(tb, st, xs, relax=relax)
    layout = K.last_layout("scan_step")
    if host is not None:
        host.submit(name, "solve_scan", (tb, st, xs), got, relax=relax)
        want, plain_ms, bad = got, None, []
    else:
        t0 = time.monotonic()
        want = K.solve_scan_plain(tb, st, xs, relax=relax)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        bad = scan_mismatches(got, want)
    layout0 = None
    if device_tables:
        got0, layout0 = device_tables_launch("scan_step", lambda: K.solve_scan(tb, st, xs, relax=relax))
        bad += [f"{f} (tables in device memory)" for f in scan_mismatches(got0, want)]
    return {
        "bad": bad, "layout0": layout0, "relax": relax, "P": xs.valid.shape[0], "N": n_slots,
        "over": bool(got[3]), "tier_steps": int(got[4].tier_steps), "layout": layout,
        "ms": cuda_ms(lambda: K.solve_scan(tb, st, xs, relax=relax), 2), "plain_ms": plain_ms,
    }


def full_size_phase(dev, host: "HostChecks") -> Optional[dict]:
    """The screens the headline bypasses at full size, with the solves'
    decisions equal to the port's oracle: the screens world (pool limit,
    reservations, minValues; the bulk gates send its solve down the scan
    path) through K2 (the round's first FULL_K2_CHECK_POSITIONS pods, its
    plain version in the side process) and
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
                          prefix=FULL_K2_CHECK_POSITIONS, host=host, name="K2 full-size screens") if screens else None
        if k2:
            log(
                f"K2 scan_step full-size {label} (P={k2['P']}, N={k2['N']}, relax={k2['relax']}, over={k2['over']}, "
                f"tier_steps={k2['tier_steps']}): kernel {k2['ms']:.3f} ms, plain in the side process, "
                f"tables {k2['layout']}, again with tables {k2['layout0']} (against the first launch), "
                f"mismatches={k2['bad'] or 'none'}"
            )
            if k2["bad"] or k2["over"] or any(k2["layout0"]["shared"].values()):
                return None
        if k3["bad"] or kinds.count(K.KIND_EXISTING) == 0 or kinds.count(K.KIND_NEW) == 0:
            return None
        if screens and any(k3["layout0"]["shared"].values()):
            return None
        gots = []
        for force in (False,) if screens else (False, True):
            sched, pods = scheduler_for(full_world(screens), dev)
            sched.debug_force_scan = force
            reset_launches()
            got = results_snapshot(sched.solve(pods), pods)
            gots.append(got)
            launches = {k: v for c in (K.LAUNCHES, KR.LAUNCHES) for k, v in c.items() if v}
            log(
                f"full-size {label}{' (forced scan)' if force else ''} on the card: {len(got[0])} claims, "
                f"{len(got[1])} existing nodes used, {len(got[2])} errors; runs path={sched.last_used_runs}, "
                f"relax={sched.last_relax}, launches {launches}"
            )
            runs = not (screens or force)
            kernel = ("run_step" if runs else "scan_step") + ("_relax" if sched.last_relax else "")
            if sched.last_used_runs != runs or not launches.get(kernel):
                return None
        host.fork(f"oracle parity, full-size {label}", oracle_mismatches, full_world(screens), *gots)
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


def fast_fleet_checks(dev, w, cands, tag: str, seed: int, rows_out: list, profiled: list, host: "HostChecks",
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

    # ---- the referee, forked off ----
    for singleton in (False, True):
        lanes = referee_lanes(verdicts[singleton], seeded, seed=seed + singleton, edges=not c0_differs)
        rows = [(k, [j == k if singleton else j <= k for j in range(len(cands))]) for k in lanes]
        host.fork(f"referee{tag} ({'singleton' if singleton else 'prefix'}, {len(rows)} lanes)", referee_mismatches,
                  w, cands, rows, verdicts[singleton])
    lanes = referee_lanes(set_verdicts, seeded, seed=seed + 2, edges=not c0_differs)
    host.fork(f"referee{tag} (sets, {len(lanes)} lanes)", referee_mismatches, w, cands,
              [(k, member[k]) for k in lanes], set_verdicts)
    return True


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


def spread_referee_check(dev, w, host: "HostChecks") -> bool:
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
    host.fork(f"referee, small spread world (prefix, every lane of {len(cands)})", referee_mismatches, w, cands,
              [(k, [j <= k for j in range(len(cands))]) for k in range(len(cands))], v)
    return True


def sweep_phase(dev, worlds: Optional[list], host: "HostChecks") -> Optional[list]:
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
    here when None). K7's plain version runs in the side process `host`
    (the K7 row's plain_ms then comes from its verdicts).
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
    if not fast_fleet_checks(dev, w, cands, "", 7, rows_out, profiled, host):
        return None
    w = worlds.pop(0)
    cands = sweep_candidates(w, SWEEP_CANDIDATES)
    log(f"leftover world: {SWEEP_NODES} nodes with riders of {LEFTOVER_RIDER}, {len(cands)} candidates, "
        f"{SWEEP_PENDING} pending pods of {LEFTOVER_PENDING}")
    if not fast_fleet_checks(dev, w, cands, LEFTOVER_TAG, 17, rows_out, profiled, host):
        return None
    w = worlds.pop(0)
    cands = sweep_candidates(w, SWEEP_CANDIDATES)
    log(f"c0 world: {SWEEP_NODES} nodes with riders of {LEFTOVER_RIDER}, every {C0_EVERY}rd holding {C0_HEAVY} "
        f"instead, {len(cands)} candidates")
    if not fast_fleet_checks(dev, w, cands, C0_TAG, 27, rows_out, profiled, host, C0_REFEREE_SEEDED,
                             c0_differs=True):
        return None
    del w, cands

    # ---- the full-state lane path (K7) ----
    w2 = worlds.pop(0)
    cands2 = sweep_candidates(w2, LANE_CANDIDATES)
    log(f"lane world: {SWEEP_NODES} nodes, riders with a zone spread (max skew {RIDER_SPREAD}), "
        f"{len(cands2)} candidates")
    k7_ms, k7_launch, nb, ops = 0.0, 0, 0, 0
    plain_jobs: list = []  # the side process's K7 checks
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
        job = f"K7 sweep lanes ({'singleton' if singleton else 'prefix'})"
        host.submit(job, "scan_lanes", (u2.tb, st_b, xs_c, valid_c, relax), got_c)
        plain_jobs.append(job)
        log(f"{job}: B={valid_b.shape[0]}, P={valid_b.shape[1]}, E={st_b.eavail.shape[1]}, "
            f"N={st_b.active.shape[1]}, relax={relax}; its plain version on the first {LANE_CHECK_POSITIONS} "
            f"positions in the side process")
        k7_ms += cuda_ms(lambda: K.scan_lanes(u2.tb, st_b, xs, valid_b, relax), 3)
        # (the K7 row is appended after both lane kinds, at this index)
        profiled.append((len(rows_out), lambda a=(u2.tb, st_b, xs, valid_b, relax): K.scan_lanes(*a), 3,
                         ("scan_lanes_kernel",)))
        # each lane reads the shared tables and batch and reads and writes
        # its own State once
        nb += nbytes(u2.tb, xs, valid_b) + 2 * nbytes(st_b) + nbytes(got[1], got[2])
        ops += int(valid_b.sum()) * st_b.eavail.shape[1] * (u2.tb.va.full_mask.shape[0] + u2.tb.va.num_keys)
        if singleton:
            lanes = list(range(len(cands2)))
        else:
            # every prefix lane up to PAST_EDGE past the last verdict change
            # (a deep prefix lane's referee call is long), and seeded ones
            v = lane_verdicts
            edge = max([k for k in range(1, len(v)) if v[k] != v[k - 1]], default=0)
            lanes = sorted(set(range(min(len(v), edge + 1 + PAST_EDGE))) | set(referee_lanes(v, 4, seed=11)))
        rows = [(k, [j == k if singleton else j <= k for j in range(len(cands2))]) for k in lanes]
        host.fork(f"referee, lane world ({'singleton' if singleton else 'prefix'}, {len(rows)} lanes)",
                  referee_mismatches, w2, cands2, rows, lane_verdicts)
    b_ms, b_by = bound(nb, ops)
    log(f"K7 scan_lanes prefix + singleton: kernel {k7_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by})")
    rows_out.append(dict(row("scan_lanes", "scan_lanes.cu", "karpenter_tpu/controllers/disruption/sweep.py:690",
                             k7_launch, 0, k7_ms, None, b_ms, b_by),
                         plain_positions=LANE_CHECK_POSITIONS, plain_jobs=plain_jobs))

    if not spread_referee_check(dev, worlds.pop(0), host):
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
    order, decision, each replacement's instance type names in order (a
    StaticDrift replacement, a bare NodeClaim, by its name)."""
    return (
        tuple(c.name for c in cmd.candidates), cmd.decision,
        tuple(tuple(it.name for it in r.instance_type_options) if hasattr(r, "instance_type_options")
              else (r.metadata.name,) for r in cmd.replacements),
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


def command_key(cmd) -> tuple:
    """A Command as the referees compare it: command_view and its
    savings."""
    from karpenter_tpu_torch.controllers.disruption.types import command_savings

    return command_view(cmd), command_savings(cmd)


def commands_differ(got: list, want: list) -> list[str]:
    """Two lists of command_key: equal views, savings within 1e-12."""
    if [g[0] for g in got] != [w[0] for w in want] or any(abs(g[1] - w[1]) > 1e-12 for g, w in zip(got, want)):
        return [f"card {got} / referee {want}"]
    return []


def referee_commands(got: list, method) -> list[str]:
    """A forked referee: `method`'s Commands (a force_oracle method) against
    the card's command_keys."""
    return commands_differ(got, [command_key(c) for c in method.compute_commands()])


def counted_path(total: dict, label: str, fn):
    """fn() as one main path of a phase: the launch counts set to 0 just
    before and read just after (added to `total`), the host seconds and
    the launches logged after `label`. Returns (fn's result, its
    launches)."""
    import torch

    reset_launches()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    counts = launch_counts()
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    log(f"{label}: {dt:.3f}s host, launches={counts}")
    return out, counts


def show_command(label: str, cmd) -> None:
    """Log a Command after `label`: decision, reason, nodes, replacements
    and their types, savings."""
    from karpenter_tpu_torch.controllers.disruption.types import command_savings

    log(f"{label}: {cmd.decision} ({cmd.reason}), {len(cmd.candidates)} nodes, "
        f"{len(cmd.replacements)} replacement(s) of {[len(r.instance_type_options) for r in cmd.replacements]} "
        f"types, {command_savings(cmd):.6f} $/h saved")


def consolidation_phase(dev, w, digest, w_single, host: "HostChecks") -> Optional[dict]:
    """The consolidation controllers on the card at the c4 width, on the
    sweep phase's c4 fleet `w` (held unchanged to `digest`, its state
    before the sweep phase): 2000 nodes, 100 candidates, 20 pending pods.

    (a) MultiNodeConsolidation(sweep="sets"): a Command, K8 launched, its
        removal feasible for the referee, its savings >= the batched rung's;
    (b) the batched rung (K6) against the binary search on the oracle
        (forked off with `host`);
    (c) SingleNodeConsolidation against its force_oracle sequential walk,
        on `w` (2000 candidates: no sweep) and on `w_single`
        (single_node_world(): one K6 singleton launch over every
        candidate);
    (d) (a)'s Command rebuilt by compute_consolidation with
        Options(tpu_min_pods=0), the simulation on K1, K3 or K2, K4 and K5
        (K5 runs from _DEDUP_DECODE_MIN claim slots up: lowered to 1 here),
        against the default route's;
    (e) a DisruptionController round trip: propose; validate after the TTL
        and start; with the replacements initialized by hand (this phase
        drives the controller alone, without the lifecycle controller that
        the gates phase's (a5) runs), delete the originals. The cluster
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

    if fleet_digest(w) != digest:
        log("consolidation phase: the sweep phase changed the c4 fleet")
        return None
    args = (w.kube, w.cluster, w.cloud, w.clock)

    # (a) the sets rung (K8)
    cmds, n = counted_path(total, "consolidation (a) MultiNodeConsolidation(sweep='sets')",
                           CN.MultiNodeConsolidation(*args, sweep="sets", device=dev).compute_commands)
    log(f"consolidation (a) last_search_stats: {json.dumps(SS.last_search_stats)}")
    if not cmds or n.get("set_sweep", 0) < 1:
        log("consolidation (a): no Command, or K8 not launched")
        return None
    cmd_a = cmds[0]
    show_command("consolidation (a)", cmd_a)
    t0 = time.monotonic()
    sim = simulate_scheduling(w.kube, w.cluster, w.cloud, cmd_a.candidates, force_oracle=True)
    referee_ok = sim.all_pods_scheduled() and len(sim.non_empty_new_claims()) <= 1
    log(f"consolidation (a) referee: removal {'feasible' if referee_ok else 'INFEASIBLE'} "
        f"({time.monotonic() - t0:.1f}s host)")
    if not referee_ok:
        bad.append("(a) referee")

    # (b) the batched rung (K6) against the binary search on the oracle
    cmds_b, n = counted_path(total, "consolidation (b) MultiNodeConsolidation(sweep='batched')",
                             CN.MultiNodeConsolidation(*args, sweep="batched", device=dev).compute_commands)
    host.fork("consolidation (b) batched vs the binary search on the oracle", referee_commands,
              [command_key(c) for c in cmds_b], CN.MultiNodeConsolidation(*args, sweep="binary", force_oracle=True))
    if not cmds_b or n.get("fast_sweep", 0) < 1:
        bad.append("(b) batched: no Command, or K6 not launched")
    else:
        show_command("consolidation (b) batched", cmds_b[0])
        if command_savings(cmd_a) < command_savings(cmds_b[0]):
            bad.append("(a) savings below the batched rung's")

    # (c) single-node against the sequential walk: on the c4 fleet (more
    # candidates than lanes: no sweep), then one singleton launch
    for label, world, lanes in (("c4 fleet", w, 0), (f"{SINGLE_NODES}-node fleet", w_single, 1)):
        a = (world.kube, world.cluster, world.cloud, world.clock)
        cmds_c, n = counted_path(total, f"consolidation (c) SingleNodeConsolidation, {label}",
                                 CN.SingleNodeConsolidation(*a, device=dev).compute_commands)
        t0 = time.monotonic()
        cmds_seq = CN.SingleNodeConsolidation(*a, force_oracle=True).compute_commands()
        log(f"consolidation (c) sequential walk on the oracle, {label}: {time.monotonic() - t0:.1f}s host")
        if n.get("fast_sweep_singleton", 0) != lanes or not cmds_c or [command_view(c) for c in cmds_c] != [
            command_view(c) for c in cmds_seq
        ]:
            bad.append(f"(c) single-node against the sequential walk, {label}")
        else:
            show_command(f"consolidation (c) single-node = sequential, {label}", cmds_c[0])

    # (d) (a)'s Command with the simulation on the kernels
    kernels_route = CN.MultiNodeConsolidation(*args, options=Options(tpu_min_pods=0), device=dev)
    dedup_min = T._DEDUP_DECODE_MIN
    T._DEDUP_DECODE_MIN = 1
    try:
        cmd_d, n = counted_path(total, "consolidation (d) compute_consolidation, tpu_min_pods=0",
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
    counted_path(total, "consolidation (e) reconcile 1 (propose)", ctrl.reconcile)
    proposal = ctrl._pending_validation[1] if ctrl._pending_validation else None
    if proposal is None or command_view(proposal) != command_view(cmd_a):
        bad.append("(e) proposal")
        log(f"consolidation phase: {time.monotonic() - t_phase:.1f}s; failed: {', '.join(bad)}")
        return None
    w.clock.advance(VALIDATION_TTL_SECONDS)
    started, _ = counted_path(total, "consolidation (e) reconcile 2 (validate, start)", ctrl.reconcile)
    if started is None or command_view(started) != command_view(cmd_a):
        bad.append("(e) validation")
        log(f"consolidation phase: {time.monotonic() - t_phase:.1f}s; failed: {', '.join(bad)}")
        return None
    new_claims = list(ctrl.queue.in_flight[0].replacement_names)
    # the lifecycle controller's part, done by hand here (the gates
    # phase's (a5) runs the controller): the replacements launch,
    # register and initialize
    for name in new_claims:
        claim = w.kube.get("NodeClaim", name)
        claim.status.conditions[COND_INITIALIZED] = "True"
        w.kube.update("NodeClaim", claim)
    w.clock.advance(2.0)
    counted_path(total, "consolidation (e) reconcile 3 (delete the originals)", ctrl.reconcile)
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


def fleet_phase(dev, its, host: "HostChecks") -> Optional[dict]:
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
    kernels' clock breakdowns there. The fleet launch's plain version runs
    in the side process `host` (the row's plain_ms then comes from its
    verdicts). Returns the kernels-line row, or None when a check
    failed."""
    import torch

    from karpenter_tpu_torch.solver import fleet as F
    from karpenter_tpu_torch.solver import tpu_kernel as K

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
                host.fork(f"fleet lane {k} of {label} vs the oracle", oracle_mismatches,
                          fleet_world(its, f"{k + 1}00m", FLEET_PODS), outcomes[k][0])

    # the fleet launch against its plain version, B=8, relax off and on
    ms_cut, cut_bound, cut_args = 0.0, None, None
    relax_worlds = [fleet_world(its, f"{k + 1}00m", FLEET_PODS, FLEET_PREF_PODS) for k in range(FLEET_CHECK_LANES)]
    for tb, st_b, xs_b, relax in (inputs_b8, fleet_inputs(relax_worlds, dev)):
        xs_c = cut_positions(xs_b, FLEET_CHECK_POSITIONS)
        got = K.solve_scan_lanes(tb, st_b, xs_c, relax)
        job = f"K7 fleet lanes (relax {'on' if relax else 'off'})"
        host.submit(job, "solve_scan_lanes", (tb, st_b, xs_c, relax), got)
        k_ms = cuda_ms(lambda: K.solve_scan_lanes(tb, st_b, xs_c, relax), 3)
        log(f"{job}: B={xs_c.valid.shape[0]}, first {FLEET_CHECK_POSITIONS} positions, N={st_b.active.shape[1]}, "
            f"tier_steps={got[4].tier_steps.tolist()}: kernel {k_ms:.3f} ms; its plain version in the side process")
        if not relax:
            plain_job, ms_cut, cut_bound, cut_args = job, k_ms, fleet_bound(tb, st_b, xs_c), (tb, st_b, xs_c, relax)
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
        row("fleet_lanes", "scan_lanes.cu", "karpenter_tpu/solver/fleet.py:164", total_launches, 0,
            ms_cut, None, *cut_bound),
        device_ms=device_ms(lambda: K.solve_scan_lanes(*cut_args), 3, ("scan_lanes_kernel",)), windows=windows,
        k7_b1_vs_k2={"k7_ms": k7_one, "k2_ms": k2_one, "k7_device_ms": k7_one_dev, "k2_device_ms": k2_one_dev,
                     "in_turns_device_ms": sweep, "breakdown": breakdowns},
    )
    out["plain_jobs"] = [plain_job]
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
    # no warm-up reconcile: the kernels and the solve path are warm from the
    # headline and c6 phases
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


def partition_oracle_mismatches(twin, card: tuple) -> list[str]:
    """The oracle on a twin cluster's partition (solve_partitioned_oracle)
    against the card's partition view."""
    want = partition_view(solve_partitioned_oracle(*twin.scheduler_inputs(twin.get_pending_pods())),
                          twin.kube.list("Pod"))
    return partition_mismatches(card, want)


def decisions_phase(dev, its, host: "HostChecks") -> bool:
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
    host.fork(f"decisions, {n} c6 + {n_pvc} PVC pods, vs the oracle on its partition", partition_oracle_mismatches,
              entry_cluster(n, n_pvc, its, dev, force_oracle=True), card)
    h = prov.last_scheduler
    ok = prov.last_solver_used == "tpu" and h.fallback_kind == "partition_continuation"
    ok = ok and len(result.created_claims) == n_claims and len(card[1]) == n_pvc
    ok = ok and all(z == (ENTRY_ZONE,) for z in card[1].values()) and not tpu_errors()
    log(f"decisions, {n} c6 + {n_pvc} PVC pods: card Provisioner ({prov.last_solver_used}, {h.fallback_kind}, "
        f"{card_s:.2f}s, {len(result.created_claims)} NodeClaims, {len(card[0])} claims); the oracle on its "
        f"partition forked off; phase {time.monotonic() - t_phase:.1f}s")
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
        wire id;
    (g) the fault segment (sidecar_faults): each fault of FAULT_SCHEDULE
        once through the port's FaultyProxy, a clean solve after each.

    The whole phase runs under the port's race witness (racert; 0
    lock-order inversions and 0 thread exceptions, the holds past
    SIDECAR_LONG_HOLD_MS printed with their creation sites) and protocol
    recorder (protorec), whose trace must refine the port's protocol model
    (proto.check_refinement: 0 violations). No solve degrades to the oracle
    on the server. Returns {launches, seconds, upload_bytes, phases,
    faults, witness}, or None when a check failed."""
    import shutil
    import tempfile
    import threading

    import torch

    from karpenter_tpu_torch import tracing
    from karpenter_tpu_torch.analysis import proto, protorec, racert
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
    faults = None
    # the witness and the recorder before the servers make their locks
    witness = racert.instrument(hold_ms=SIDECAR_LONG_HOLD_MS)
    recorder = protorec.install()
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

        # (g) the fault segment
        faults = sidecar_faults(dev, its, sock_dir, bad)
    finally:
        srv.stop()
        if fleet_srv is not None:
            fleet_srv.stop()
        protorec.uninstall()
        racert.uninstrument()
        srv.table_cache.clear()
        shutil.rmtree(sock_dir, ignore_errors=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    # the port's judge on the phase's whole trace, and the witness
    events = recorder.snapshot()
    violations = proto.check_refinement(events)
    report = witness.report()
    holds = [f"{h['site']} {h['held_ms']} ms [{h['thread']}]" for h in report["long_holds"]]
    log(f"sidecar protocol trace: {len(events)} events, {len(violations)} violations of the port's model "
        f"{violations[:3] or ''}")
    log(f"sidecar witness: {report['acquires']} acquires, {len(report['edges'])} lock-order edges, "
        f"{len(report['inversions'])} inversions, {len(report['thread_exceptions'])} thread exceptions; "
        f"holds past {SIDECAR_LONG_HOLD_MS:.0f} ms ({len(holds)}): {json.dumps(holds)}")
    if violations:
        bad.append("the trace does not refine the protocol model")
    if report["inversions"]:
        log(witness.render_inversions())
        bad.append("lock-order inversions")
    if report["thread_exceptions"]:
        bad.append(f"thread exceptions {report['thread_exceptions']}")
    seconds = time.monotonic() - t_phase
    log(f"sidecar phase: {seconds:.1f}s; {'failed: ' + ', '.join(bad) if bad else 'ok'}")
    if bad:
        return None
    launches = dict(launches_a)
    launches.update({k: v for k, v in launches_d.items() if k.startswith("fleet_lanes")})
    return {"launches": launches, "seconds": seconds, "upload_bytes": upload_a, "phases": phases,
            "faults": faults, "witness": {"events": len(events), "long_holds": len(holds)}}


def decision_view(r, pods) -> tuple:
    """fuzz.results_snapshot's picture of a Results answered by the sidecar
    (its RemoteNodeClaims carry the launchable NodeClaim, not a template)
    or solved here: each claim's pods by name, its NodePool, the instance
    types its NodeClaim may launch and its requests; the existing-node
    placements; the failed pods; the timeout flag."""
    from karpenter_tpu_torch.api import labels as wk

    name = {p.uid: p.name for p in pods}
    claims = []
    for c in r.new_node_claims:
        if not c.pods:
            continue
        nc = c.to_node_claim({})
        types = next((tuple(sorted(q.values)) for q in nc.requirements if q.key == wk.INSTANCE_TYPE_LABEL_KEY), ())
        claims.append((tuple(sorted(name[p.uid] for p in c.pods)), c.nodepool_name, types,
                       tuple(sorted((k, int(v)) for k, v in c.requests.items()))))
    existing = sorted((n.name, tuple(sorted(name[p.uid] for p in n.pods))) for n in r.existing_nodes if n.pods)
    return sorted(claims), existing, tuple(sorted(name[u] for u in r.pod_errors)), bool(r.timed_out)


def sidecar_faults(dev, its, sock_dir: str, bad: list) -> dict:
    """Sidecar check (g), the fault segment: the port's FaultyProxy
    (testing/faults.py) between a ResilientSolver (breaker threshold 1, a
    cooldown on its own clock) and a SolverServer on the card, a fresh
    c6_world(FAULT_PODS) a solve. Each fault of FAULT_SCHEDULE once —
    `blackhole` and `delay` past the client's deadline (which must trip),
    `truncate`, `corrupt`, then the server's `stop()` while a solve is in
    flight (the drain must flush its RESULT; a new server then takes the
    socket) — and after each a clean solve, answered by the sidecar with
    the breaker closed and equal (fuzz.results_snapshot) to
    solve_in_process on the card. A fault solve that failed opened the
    breaker and degraded in-process to the card (equal too); its clean
    solve is the half-open probe after the cooldown. Returns {launches,
    seconds, outcomes}; a failed check is appended to `bad`."""
    import threading

    import torch

    from karpenter_tpu_torch.solver import epochs as E
    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver.hybrid import ResilientSolver, solve_in_process
    from karpenter_tpu_torch.solver.service import SolverServer
    from karpenter_tpu_torch.testing import fuzz
    from karpenter_tpu_torch.testing.faults import FaultyProxy

    t0 = time.monotonic()
    path = os.path.join(sock_dir, "faults.sock")

    def server():
        srv_ = SolverServer(path, device=dev, table_cache=E.DeviceTableCache(), epoch_store=E.EpochStore(),
                            admission=E.AdmissionGate(max_inflight=8))
        srv_.start()
        return srv_

    dedup_min = T._DEDUP_DECODE_MIN
    T._DEDUP_DECODE_MIN = 1
    srv = server()
    proxy = FaultyProxy(os.path.join(sock_dir, "proxy.sock"), path)
    now = [0.0]
    rs = ResilientSolver(proxy.listen_path, failure_threshold=1, cooldown_seconds=FAULT_COOLDOWN,
                         request_timeout_seconds=FAULT_WIRE_TIMEOUT, clock=lambda: now[0], device=dev)
    outcomes = []
    try:
        w = c6_world(FAULT_PODS, its)
        local, _ = solve_in_process(w.pools, w.ibp, w.pods, device=dev)
        want = {"snapshot": fuzz.results_snapshot(local, w.pods), "view": decision_view(local, w.pods)}
        torch.cuda.synchronize()
        reset_launches()

        def solve():
            """(who answered, equal to the in-process solve): a degraded
            answer by its fuzz.results_snapshot, the sidecar's by its
            decision_view."""
            w_ = c6_world(FAULT_PODS, its)
            got = rs.solve(w_.pools, w_.ibp, w_.pods)
            if rs.last_used == "sidecar":
                return rs.last_used, decision_view(got, w_.pods) == want["view"]
            return rs.last_used, fuzz.results_snapshot(got, w_.pods) == want["snapshot"]

        solve()  # the segment's first solve: a snapshot that sets up the client's epoch
        for mode in FAULT_SCHEDULE:
            t1 = time.monotonic()
            if mode == "stop":
                # the solve reaches the server's solver, the drain starts, then
                # the solve goes on: it is in flight across stop()
                started, proceed = threading.Event(), threading.Event()
                inner = srv._solve_decoded

                def held(*a, **k):
                    started.set()
                    proceed.wait(FAULT_WIRE_TIMEOUT)
                    return inner(*a, **k)

                srv._solve_decoded = held
                out: list = []
                solver = threading.Thread(target=lambda: out.append(solve()), daemon=True)
                solver.start()
                stopper = None
                if started.wait(FAULT_WIRE_TIMEOUT):
                    stopper = threading.Thread(target=srv.stop, daemon=True)
                    stopper.start()
                    while not srv._stop.is_set():
                        time.sleep(0.001)
                proceed.set()
                solver.join(timeout=4 * FAULT_WIRE_TIMEOUT)
                if stopper is not None:
                    stopper.join(timeout=4 * FAULT_WIRE_TIMEOUT)
                got = out[0] if out else ("none", False)
                srv.stop()
                srv = server()  # the sidecar comes back on the same socket
            else:
                # the proxy arms a fault for its next connection: the client
                # dials afresh for the faulted solve
                proxy.set_fault(mode, once=True, delay=FAULT_WIRE_TIMEOUT + 1.0)
                rs.client.close()
                got = solve()
            state = rs.breaker.state
            if state != "closed":
                now[0] += FAULT_COOLDOWN + 1.0  # the cooldown elapses: the next solve is the probe
            clean = solve()
            rec = {"fault": mode, "answered_by": got[0], "equal": got[1], "breaker": state,
                   "clean": clean[0], "clean_equal": clean[1], "breaker_after": rs.breaker.state,
                   "s": round(time.monotonic() - t1, 3)}
            outcomes.append(rec)
            log(f"sidecar (g) fault {mode}: {json.dumps(rec)}")
            failed = got[0] != "sidecar"
            holds = [got[1], clean[1], clean[0] == "sidecar", rec["breaker_after"] == "closed",
                     state == ("open" if failed else "closed"), not failed or got[0] == "tpu"]
            if mode in ("blackhole", "delay"):
                holds.append(failed)  # the client's deadline trips
            if mode == "stop":
                holds.append(not failed)  # the drain flushes the in-flight RESULT
            if not all(holds):
                bad.append(f"(g) {mode}")
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        T._DEDUP_DECODE_MIN = dedup_min
        proxy.stop()
        srv.stop()
    seconds = time.monotonic() - t0
    missing = [k for k in ("typeok_screen", "run_arrays", "dedup_rows") if not launches.get(k)]
    if not launches.get("run_step", 0) + launches.get("run_step_relax", 0):
        missing.append("run_step")
    log(f"sidecar (g) fault segment: {seconds:.1f}s (budget {FAULT_BUDGET_S:.0f}s); launches {launches}; "
        f"missing launches: {missing or 'none'}")
    if missing:
        bad.append("(g) launches")
    if seconds > FAULT_BUDGET_S:
        bad.append("(g) past its budget")
    return {"launches": launches, "seconds": seconds, "outcomes": outcomes}


def cold_start_run(mode: str, dev) -> dict:
    """One fresh process's first headline solve (phase 14a): with
    mode "prewarm", `aot.prewarm()` on `dev` first, its fleet lanes
    included, and after the solve prewarmed_fleet_window. Returns its
    seconds, the prewarm's record, the launches, the decisions' digest and
    each library's build seconds as `_build.build_all` saw them here (0:
    no nvcc)."""
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
        pw = aot.prewarm(device=dev, include_fleet=True, fleet_lane_buckets=PREWARM_FLEET_BUCKETS)
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
    if mode == "prewarm":
        out["fleet_window"] = prewarmed_fleet_window(dev)
    out["build"] = {} if dev.type != "cuda" else {k: v["seconds"] for k, v in _build.build_all().items()}
    return out


def prewarmed_fleet_window(dev) -> dict:
    """After the prewarm's fleet lanes: a FleetCoalescer window of two
    concurrent scan-path lanes (analysis/runtime.py's fleet lane, the
    runtime budgets' problem) in one DeviceWindow. Returns the K7 launches
    (its LAUNCHES), the nvcc runs and library loads the window read
    (`second_solve_builds`, `second_solve_library_loads`), the allocator
    segments it added and whether the lanes coalesced."""
    import threading

    import torch

    from karpenter_tpu_torch.analysis import runtime as R
    from karpenter_tpu_torch.solver import epochs
    from karpenter_tpu_torch.solver.fleet import FleetCoalescer

    lanes: list = []
    errors: list = []

    def window(_) -> None:
        coalescer = FleetCoalescer(window_seconds=FLEET_WINDOW_SECONDS, max_lanes=2)
        cache = epochs.DeviceTableCache()
        lanes[:] = [R._fleet_lane(dev, cache, coalescer) for _ in range(2)]

        def run(sched, pods) -> None:
            try:
                sched.solve(pods)
            except BaseException as e:  # raised below, never swallowed
                errors.append(e)

        threads = [threading.Thread(target=run, args=lane, daemon=True) for lane in lanes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=FLEET_JOIN_SECONDS)
        if errors:
            raise errors[0]

    windows = R.Windows(dev)
    torch.cuda.synchronize()
    segments = R._segments(dev)
    reset_launches()
    windows.run("prewarmed fleet window", window)
    m = windows.metrics["prewarmed fleet window"]
    return {"launches": launch_counts(), "builds": m["second_solve_builds"],
            "library_loads": m["second_solve_library_loads"], "new_segments": R._segments(dev) - segments,
            "coalesced": all(s.last_used_fleet for s, _ in lanes), "windows_discarded":
            len(windows.detail["prewarmed fleet window"]["discarded"])}


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


def prewarm_fleet_checks(a: dict) -> list[str]:
    """The prewarm's fleet lanes in cold_start_run("prewarm")'s record `a`:
    the manifest holds a K7 combo with its first-launch ms and build
    seconds for each lane bucket of PREWARM_FLEET_BUCKETS, and the 2-lane
    window after it coalesced onto K7 with no nvcc, no library load and no
    new allocator segment. The failures' names."""
    k7 = {B: {k: v for k, v in a["combos"].items() if k.startswith("fleet_solve_scan[") and f"@B={B}," in k}
          for B in PREWARM_FLEET_BUCKETS}
    fw = a["fleet_window"]
    log(f"cold start A's fleet lanes: K7 combos by lane bucket (first-launch ms, build s) {json.dumps(k7)}; "
        f"a 2-lane window after the prewarm {json.dumps(fw)}")
    bad = []
    if not all(k7.values()) or any(set(v) < {"first_launch_ms", "build_seconds"} for c in k7.values()
                                   for v in c.values()):
        bad.append("the prewarm's K7 combos")
    if (not fw["coalesced"] or fw["builds"] or fw["library_loads"] or fw["new_segments"]
            or fw["launches"].get("fleet_lanes", 0) < 1):
        bad.append("the fleet window after the prewarm")
    return bad


def cold_start_phase(dev, its, steady_s: float) -> Optional[dict]:
    """Phase 14a. Two fresh processes on the card after this one built the
    kernels: A runs `aot.prewarm()` (with the fleet lanes of
    PREWARM_FLEET_BUCKETS) then the headline's first solve and a 2-lane
    fleet window, B the same first solve without a prewarm. Neither may
    invoke nvcc, A's prewarm must complete, A's decisions must equal B's,
    and A's fleet lanes must pass prewarm_fleet_checks. A's first solve is
    printed beside B's and the headline phase's steady median.
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
    bad += prewarm_fleet_checks(a)
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


def operator_cluster(n_pods: int, n_pvc: int, its, dev, force_oracle: bool = False, probe_port=None, gates=None):
    """The port's Operator over a KWOK provider holding `its`, with one
    default NodePool that consolidates at once (consolidateAfter 0, a 100%
    budget) and entry_cluster's pending pods (the c6 mix at n_pods, n_pvc
    PVC pods in ENTRY_ZONE); Options(tpu_min_pods=0, feature_gates=gates)
    on `dev`, or the oracle's with force_oracle."""
    from karpenter_tpu_torch.api.objects import Budget
    from karpenter_tpu_torch.controllers.kube import FakeClock
    from karpenter_tpu_torch.controllers.operator import Operator
    from karpenter_tpu_torch.options import FeatureGates, Options
    from karpenter_tpu_torch.testing import fixtures

    opts = Options(tpu_min_pods=0, probe_port=probe_port, feature_gates=gates or FeatureGates())
    op = Operator(clock=FakeClock(), options=opts, force_oracle=force_oracle, device=None if force_oracle else dev)
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
    candidates' state goes with their nodes; no savings for a StaticDrift
    Command, whose replacement is a bare NodeClaim)."""
    from karpenter_tpu_torch.controllers.disruption.types import command_savings

    return {"view": command_view(cmd), "nodes": [c.name for c in cmd.candidates], "reason": cmd.reason,
            "decision": cmd.decision, "replacements": len(cmd.replacements),
            "usd_per_hour": round(command_savings(cmd), 6)
            if all(hasattr(r, "instance_type_options") for r in cmd.replacements) else None}


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


class SideProcess:
    """`python3 chip_smoke.py ARGS` in a process of its own, beside the
    card's phases: its output in build/LOG (a pipe nobody reads until the
    end would fill), `threads` torch threads when set, stopped by `close`
    on any way out."""

    def __init__(self, args: tuple, log_name: str, threads: Optional[int] = None):
        self.args, self.log_name, self.threads = args, log_name, threads
        self.proc = None
        self.log = None
        self.t_start = 0.0

    def start(self) -> None:
        os.makedirs("build", exist_ok=True)
        self.log = open(os.path.join("build", self.log_name), "w+")
        env = dict(os.environ)
        if self.threads is not None:
            env["OMP_NUM_THREADS"] = str(self.threads)
        self.t_start = time.monotonic()
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), *self.args],
                                     cwd=os.path.dirname(os.path.abspath(__file__)), stdout=self.log,
                                     stderr=subprocess.STDOUT, text=True, env=env)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def wait(self, timeout: float) -> tuple:
        """(seconds waited, its whole log) once it has ended, killed after
        `timeout` seconds."""
        t0 = time.monotonic()
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        waited = time.monotonic() - t0
        self.log.seek(0)
        return waited, self.log.read()

    def log_tail(self, what: str) -> None:
        self.log.seek(0)
        log(f"{what}; {self.log.read()[-2000:]}")

    def close(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self.log is not None:
            self.log.close()


class RecordProcess(SideProcess):
    """`python3 chip_smoke.py FLAG` in a process of its own, whose record is
    the one line it prints (FLAG's name in capitals, then JSON): phase 14
    (c)'s oracle side (operator_oracle_worker, the default), the gates
    phase's (c) oracle side (`--gates-oracle`, gates_oracle_worker), both
    host work alone and started as soon as the kernels are built, and the
    gates phase's (c) card side (`--gates-card`, gates_card_worker)."""

    def __init__(self, flag: str = "--operator-oracle", what: str = "operator (c)"):
        super().__init__((flag,), f"{flag[2:]}.log")
        self.tag, self.what = flag[2:].replace("-", "_").upper() + " ", what

    def result(self) -> Optional[dict]:
        """Its record (the line its worker prints), waited for at most
        OPERATOR_ORACLE_TIMEOUT seconds; None (and its log's tail printed)
        when it failed."""
        if self.proc is None:
            log(f"{self.what} oracle process: never started")
            return None
        waited, text = self.wait(OPERATOR_ORACLE_TIMEOUT)
        line = next((ln for ln in text.splitlines() if ln.startswith(self.tag)), None)
        if self.proc.returncode != 0 or line is None:
            self.log_tail(f"{self.what} oracle process: exit {self.proc.returncode}")
            return None
        rec = json.loads(line[len(self.tag):])
        rec["waited_s"] = waited
        rec["started_s"] = self.t_start - _T0
        return rec


# ---------------------------------------------------------------------------
# the side process: the fuzz cases' oracle snapshots and the deep plain checks


# the side processes of a run (RecordProcess, HostChecks), stopped on
# every way out
_CHILDREN: list = []


def abort_run(code: int) -> None:
    """End the run at once, side processes stopped: a kernel that spins
    would hold the interpreter's own shutdown."""
    for child in _CHILDREN:
        child.close()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def fuzz_cases() -> list:
    """(label, fuzz.FuzzCase) of the fuzz phase: FUZZ_SEEDS seeds from
    fuzz.fuzz_seed_base(), the corpus of tests/fuzz_corpus (read as data)
    and the shrunk runs-path stall case."""
    from karpenter_tpu_torch.testing import fixtures, fuzz

    base = fuzz.fuzz_seed_base()
    cases = [(f"seed {s}", fuzz.generate_case(s)) for s in range(base, base + FUZZ_SEEDS)]
    cases += [(f"corpus {fn}", fuzz.corpus_case(entry)) for fn, entry in fuzz.load_corpus()]
    return cases + [("runs stall (shrunk)", fixtures.runs_stall_case(shrunk=True))]


def to_cpu(tree):
    """A copy of a tree of tensors (NamedTuples, tuples, lists, dicts) with
    every tensor on the CPU."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, tuple):
        items = [to_cpu(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, list):
        return [to_cpu(x) for x in tree]
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree


def baseline_oracle_view(name: str) -> tuple:
    """The port's oracle on a baseline config at its full width, as a
    `partition_view` (every pod of these configs rides the kernels, so the
    kernel route's referee is the oracle on the whole batch)."""
    from karpenter_tpu_torch.solver.oracle import Scheduler

    w = baseline_world(name)
    return partition_view(Scheduler(w.pools, w.ibp, w.topo).solve(w.pods), w.pods)


def plain_check(fn: str):
    """(the plain version, the mismatch function) of a deep check's kind."""
    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver import tpu_kernel as K

    return {
        "solve_scan": (K.solve_scan_plain, scan_mismatches),
        "scan_lanes": (K.scan_lanes_plain, lanes_mismatches),
        "solve_scan_lanes": (K.solve_scan_lanes_plain, lanes_mismatches),
        "dedup_columns": (T.dedup_columns_plain, dedup_mismatches),
        "oracle_partition": (baseline_oracle_view, partition_mismatches),
    }[fn]


STATIC_TIERS = "static tiers (--ast, --race)"


def static_tiers() -> dict:
    """The analysis's AST and race tiers (`python -m
    karpenter_tpu_torch.analysis --ast` and `--race`) over the shipped
    tree, as a verdict: every finding outside torch_graftlint.baseline.json
    and torch_graftlint.race.baseline.json, every stale or unjustified
    entry and every file that does not parse is a disagreement. Needs no
    card."""
    from karpenter_tpu_torch.analysis import locks
    from karpenter_tpu_torch.analysis.engine import run_analysis

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    bad, tiers = [], {}
    for tier, run in (("ast", run_analysis), ("race", locks.run_race_analysis)):
        rep = run(root)
        bad += [f"{tier}: {f.render()}" for f in rep["findings"]]
        bad += [f"{tier}: stale baseline entry [{e.get('rule')}] {e.get('path')}: {e.get('text')!r}" for e in rep["stale"]]
        bad += [f"{tier}: unjustified baseline entry [{e.get('rule')}] {e.get('path')}" for e in rep["unjustified"]]
        bad += [f"{tier}: {e}" for e in rep["errors"]]
        tiers[tier] = {"findings": len(rep["findings"]), "baselined": rep["total"] - len(rep["findings"])}
    return {"name": STATIC_TIERS, "bad": bad, "plain_ms": (time.monotonic() - t0) * 1e3, "tiers": tiers}


def host_checks_worker(dirpath: str) -> int:
    """`python3 chip_smoke.py --host-checks DIR`: first the port's oracle
    snapshots of every kernel-supported fuzz case (`fuzz.oracle_snapshots`,
    pickled to DIR/oracle.pkl), then the static tiers (`static_tiers`, to
    DIR/static.json), then each deep check the main process
    writes to DIR (job-*.pt: the cut's inputs and the kernel's outputs, on
    the CPU) through its plain version on the CPU, a verdict (job-*.json:
    the fields that differ, the plain version's ms) for each, until DIR/done
    lists the jobs and every one has its verdict. Needs no card."""
    import pickle

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(HOST_CHECK_THREADS)
    from karpenter_tpu_torch.testing import fuzz

    t0 = time.monotonic()
    snaps = {}
    for label, case in fuzz_cases():
        if fuzz.kernel_supported(case):
            snaps[label] = fuzz.oracle_snapshots(case)
    with open(os.path.join(dirpath, "oracle.pkl.tmp"), "wb") as f:
        pickle.dump(snaps, f)
    os.replace(os.path.join(dirpath, "oracle.pkl.tmp"), os.path.join(dirpath, "oracle.pkl"))
    print(f"HOST_CHECKS oracle {len(snaps)} cases {time.monotonic() - t0:.1f}s", flush=True)
    verdict = static_tiers()
    with open(os.path.join(dirpath, "static.json.tmp"), "w") as f:
        json.dump(verdict, f)
    os.replace(os.path.join(dirpath, "static.json.tmp"), os.path.join(dirpath, "static.json"))
    print(f"HOST_CHECKS static tiers {json.dumps(verdict['tiers'])}: {verdict['bad'] or 'clean'} "
          f"({verdict['plain_ms']:.0f} ms)", flush=True)
    done = set()
    while True:
        listed = None
        if os.path.exists(os.path.join(dirpath, "done")):
            with open(os.path.join(dirpath, "done")) as f:
                listed = set(json.load(f))
        pending = sorted(fn[4:-3] for fn in os.listdir(dirpath) if fn.startswith("job-") and fn.endswith(".pt"))
        todo = [j for j in pending if j not in done]
        for job in todo:
            spec = torch.load(os.path.join(dirpath, f"job-{job}.pt"), weights_only=False)
            plain, mismatches = plain_check(spec["fn"])
            t1 = time.monotonic()
            want = plain(*spec["args"], **spec["kwargs"])
            verdict = {"name": spec["name"], "bad": mismatches(spec["got"], want),
                       "plain_ms": (time.monotonic() - t1) * 1e3}
            with open(os.path.join(dirpath, f"job-{job}.json.tmp"), "w") as f:
                json.dump(verdict, f)
            os.replace(os.path.join(dirpath, f"job-{job}.json.tmp"), os.path.join(dirpath, f"job-{job}.json"))
            print(f"HOST_CHECKS job {spec['name']}: {verdict['bad'] or 'equal'} ({verdict['plain_ms']:.0f} ms)",
                  flush=True)
            done.add(job)
        if listed is not None and listed <= done:
            break
        if not todo:
            time.sleep(0.5)
    print(f"HOST_CHECKS cpu_s {time.process_time():.1f} wall_s {time.monotonic() - t0:.1f}", flush=True)
    return 0


class HostChecks(SideProcess):
    """The side process (host_checks_worker), started as soon as the kernels
    are built, with HOST_CHECK_THREADS torch threads. The main process hands
    it each deep check (`submit`), reads the fuzz cases' oracle snapshots
    from it (`oracle_snapshots`), forks each host-only referee check off
    itself (`fork`: the sweep referee, the oracle parities, the fleet
    lanes' and the decisions phase's oracle), and at the end waits for
    every verdict (`finish`): a mismatch, a missing verdict or a dead
    process fails the run."""

    def __init__(self):
        self.dir = os.path.join("build", f"host-checks-{os.getpid()}")
        super().__init__(("--host-checks", self.dir), "host-checks.log", HOST_CHECK_THREADS)
        self.jobs: dict = {}  # job id -> the check's name
        self.forks: dict = {}  # fork job id -> (the check's name, its pid, or None once reaped)

    def start(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        super().start()

    def submit(self, name: str, fn: str, args: tuple, got, **kwargs) -> None:
        """One deep check: the plain version `fn` (plain_check) on `args`
        against the kernel's outputs `got`, all copied to the CPU."""
        import torch

        job = f"{len(self.jobs):03d}"
        spec = {"name": name, "fn": fn, "args": to_cpu(args), "kwargs": kwargs, "got": to_cpu(got)}
        tmp = os.path.join(self.dir, f"job-{job}.tmp")
        torch.save(spec, tmp)
        os.replace(tmp, os.path.join(self.dir, f"job-{job}.pt"))
        self.jobs[job] = name
        log(f"host checks: {name} handed to the side process")

    def fork(self, name: str, fn, *args) -> None:
        """A referee check that is host work alone, `fn(*args)` -> the
        disagreements (none: it holds), in a child of this process: it reads
        the objects as they are now (no rebuild, no pickling) while the main
        process goes on with the card's phases. The child never touches the
        card, runs with the garbage collector off (a collection would write
        every object's header and copy the whole heap), writes its verdict
        beside the side process's and leaves with os._exit. At most
        FORK_LIMIT children run at once; `finish` waits for every verdict."""
        import gc
        import warnings

        while sum(self._reap(job) for job in self.forks) >= FORK_LIMIT:
            time.sleep(0.05)
        job = f"fork-{len(self.forks):03d}"
        sys.stdout.flush()
        sys.stderr.flush()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)  # fork() in a process with threads
            pid = os.fork()
        if pid == 0:  # the child: never returns into the caller
            try:
                gc.disable()
                t0 = time.monotonic()
                try:
                    verdict = {"name": name, "bad": [str(b) for b in fn(*args)]}
                except BaseException as e:  # the verdict carries it: the main process fails the run
                    verdict = {"name": name, "bad": [f"raised {e!r}"]}
                verdict["plain_ms"] = (time.monotonic() - t0) * 1e3
                path = os.path.join(self.dir, f"{job}.json")
                with open(path + ".tmp", "w") as f:
                    json.dump(verdict, f)
                os.replace(path + ".tmp", path)
            finally:
                os._exit(0)
        self.forks[job] = (name, pid)
        log(f"host checks: {name} forked off (pid {pid})")

    def _reap(self, job: str) -> int:
        """1 while a forked check is still running, else 0 (reaped)."""
        name, pid = self.forks[job]
        if pid is None:
            return 0
        done, _ = os.waitpid(pid, os.WNOHANG)
        if done:
            self.forks[job] = (name, None)
        return int(not done)

    def oracle_snapshots(self, timeout: float = HOST_CHECKS_TIMEOUT) -> Optional[dict]:
        import pickle

        path = os.path.join(self.dir, "oracle.pkl")
        deadline = time.monotonic() + timeout
        while not os.path.exists(path):
            if not self.alive() or time.monotonic() > deadline:
                self.log_tail("host checks: oracle snapshots never came")
                return None
            time.sleep(0.2)
        with open(path, "rb") as f:
            return pickle.load(f)

    def finish(self) -> Optional[dict]:
        """Every job's verdict by name, with the side's own numbers; None
        (its log's tail printed) when a verdict is missing or the process
        failed. The job directory is removed once its verdicts are read."""
        with open(os.path.join(self.dir, "done"), "w") as f:
            json.dump(sorted(self.jobs), f)
        waited, text = self.wait(HOST_CHECKS_TIMEOUT)
        t0 = time.monotonic()
        while sum(self._reap(job) for job in self.forks) and time.monotonic() - t0 < HOST_CHECKS_TIMEOUT:
            time.sleep(0.1)
        out = {"waited_s": waited, "forks_waited_s": time.monotonic() - t0, "started_s": self.t_start - _T0,
               "verdicts": {}}
        paths = {name: f"job-{job}.json" for job, name in self.jobs.items()}
        paths.update({name: f"{job}.json" for job, (name, _) in self.forks.items()})
        paths[STATIC_TIERS] = "static.json"
        for name, fn in paths.items():
            path = os.path.join(self.dir, fn)
            if os.path.exists(path):
                with open(path) as f:
                    out["verdicts"][name] = json.load(f)
        self._kill_forks()
        shutil.rmtree(self.dir, ignore_errors=True)
        cpu = [ln.split() for ln in text.splitlines() if ln.startswith("HOST_CHECKS cpu_s ")]
        if self.proc.returncode != 0 or len(out["verdicts"]) != len(paths) or not cpu:
            self.log_tail(f"host checks: exit {self.proc.returncode}, "
                          f"{len(out['verdicts'])} of {len(paths)} verdicts")
            return None
        out["cpu_s"], out["wall_s"] = float(cpu[-1][2]), float(cpu[-1][4])
        return out

    def _kill_forks(self) -> None:
        import signal

        for job, (name, pid) in self.forks.items():
            if pid is not None:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
                self.forks[job] = (name, None)

    def close(self) -> None:
        """The side process and any forked check still running stopped, the
        job directory removed."""
        super().close()
        self._kill_forks()
        shutil.rmtree(self.dir, ignore_errors=True)


def case_world(case) -> World:
    """A fuzz case as a World (fresh objects)."""
    from karpenter_tpu_torch.solver.topology import Topology

    pools, ibp, pods, views, _daemons, options, source = case.materialize()
    topo = Topology(pools, ibp, pods, cluster=source, state_node_views=views,
                    ignore_preferences=options.ignore_preferences)
    return World(pools, ibp, pods, views, options, topo)


def finished_within(seconds: float) -> bool:
    """Whether the work queued on the current stream ends within `seconds`
    (an event polled on the host: a kernel that spins does not wedge the
    run's host)."""
    import torch

    ev = torch.cuda.Event()
    ev.record()
    deadline = time.monotonic() + seconds
    while not ev.query():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


def stall_phase(dev) -> Optional[dict]:
    """The runs-path stall case on the card: `fixtures.runs_stall_case`
    (the c6 mix's 50 pods over 40 KWOK types, and its shrunk two pods),
    whose walk retries a bulk head after a step that commits nothing. K3
    relax off and on, each launch given STALL_LAUNCH_SECONDS (a K3 that
    spins ends the run at once), held bit for bit to the plain walk:
    kinds, slots, state, the odometer and the counter block with its
    stall counter 0; then solve_in_process on the card against the port's
    oracle, on the kernel route through K3. None on a failed check."""
    import torch

    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver import tpu_runs as KR
    from karpenter_tpu_torch.solver.hybrid import solve_in_process
    from karpenter_tpu_torch.testing import fixtures, fuzz

    t0 = time.monotonic()
    out = {"launches": {}}
    for shrunk in (False, True):
        label = "shrunk" if shrunk else "c6_pods(50)"
        case = fixtures.runs_stall_case(shrunk)
        rr = runs_round(case_world(case), dev)
        n = len(rr.order)
        for relax in (False, True):
            args = (rr.tb, rr.st, rr.rx, rr.seq, torch.zeros((), dtype=torch.int32, device=dev), n, relax)
            got = KR.solve_runs(*args)
            if not finished_within(STALL_LAUNCH_SECONDS):
                log(f"stall phase: K3 on the {label} stall case (relax={relax}) still runs after "
                    f"{STALL_LAUNCH_SECONDS:.0f}s: it spins")
                abort_run(1)
            want = KR.solve_runs_plain(*args)
            bad = runs_mismatches(got, want)
            rs = runs_status(got)
            stall = int(rs.stalled)
            log(f"stall phase: K3 run_step on the {label} case (P={rr.rx.is_head.shape[0]}, n={n}, "
                f"N={rr.st.active.shape[0]}, relax={relax}): steps={rs.steps} "
                f"bulk_steps={rs.bulk_steps} ptr={rs.ptr} over={rs.over} stall counter={stall}; "
                f"mismatches={bad or 'none'}")
            if bad or stall or rs.ptr != n:
                return None
        pools, ibp, pods, views, daemons, options, source = case.materialize()
        reset_launches()
        r, h = solve_in_process(pools, ibp, pods, views, daemons, options, cluster=source, device=dev)
        got_snap = fuzz.results_snapshot(r, pods)
        launches = {k: v for c in (K.LAUNCHES, KR.LAUNCHES) for k, v in c.items() if v}
        pools, ibp, pods, views, daemons, options, source = case.materialize()
        ro, _ = solve_in_process(pools, ibp, pods, views, daemons, options, cluster=source, force_oracle=True,
                                 device=dev)
        same = got_snap == fuzz.results_snapshot(ro, pods)
        log(f"stall phase: solve_in_process on the {label} case: used_tpu={h.used_tpu} "
            f"fallback={h.fallback_kind} runs path={h.tpu.last_used_runs} launches {launches}; against the "
            f"port's oracle: {'equal' if same else 'DIFFERENT'}")
        if not (same and h.used_tpu and h.fallback_kind is None and h.tpu.last_used_runs):
            return None
        if not launches.get("run_step", 0) + launches.get("run_step_relax", 0):
            return None
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    out["seconds"] = time.monotonic() - t0
    log(f"stall phase: {out['seconds']:.1f}s")
    return out


def fuzz_phase(dev, host: HostChecks) -> Optional[dict]:
    """The fuzz cases (fuzz_cases) on the card: each kernel-supported case
    through the port's fuzz.check_parity (its kernel path, the forced scan
    path after a runs-path solve, a tight claim-slot pool and the relax-off
    solve, with K1 and K4) against the side process's oracle snapshots, and
    every case through fuzz.solve_hybrid with no invariant or odometer
    violation. Returns the counts, or None on any violation (each logged
    with its repro command)."""
    from karpenter_tpu_torch.testing import fuzz

    t0 = time.monotonic()
    cases = fuzz_cases()
    t_cases = time.monotonic()
    snaps = host.oracle_snapshots()
    if snaps is None:
        return None
    t_wait = time.monotonic() - t_cases
    reset_launches()
    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver import tpu_runs as KR

    supported, violations, fallbacks = 0, [], {}
    errors_before = tpu_errors()
    for label, case in cases:
        found = []
        if fuzz.kernel_supported(case):
            supported += 1
            want, want_ni = snaps[label]
            found += fuzz.check_parity(case, device=dev, want_snap=want, want_snap_relax_off=want_ni)
        r, pods, h = fuzz.solve_hybrid(case, device=dev)
        found += fuzz.invariant_violations(case, r, pods) + fuzz.odometer_violations(h)
        kind = h.fallback_kind or ("none" if h.used_tpu else "oracle")
        fallbacks[kind] = fallbacks.get(kind, 0) + 1
        if kind == "tpu_error":
            # the guard re-solved on the oracle, whose answer passes every
            # invariant: the kernel path's error is the finding
            found.append(f"the kernel path raised and the hybrid fell back to the oracle: {h.fallback_reason}")
        for v in found:
            violations.append(v)
            repro = (fuzz.repro_command(case.seed) if label.startswith("seed")
                     else f"{label} (replay it with corpus_case)" if label.startswith("corpus")
                     else "fixtures.runs_stall_case(shrunk=True)")
            log(f"fuzz phase: VIOLATION on {label}: {v[:600]}; repro: {repro}")
    launches = {k: v for c in (T.LAUNCHES, K.LAUNCHES, KR.LAUNCHES) for k, v in c.items() if v}
    errors = tpu_errors() - errors_before
    out = {"cases": len(cases), "supported": supported, "fallbacks": fallbacks, "tpu_errors": errors,
           "violations": len(violations), "launches": launches,
           "seconds": time.monotonic() - t0, "cases_s": t_cases - t0, "oracle_wait_s": t_wait}
    log(f"fuzz phase: {json.dumps(out)}")
    if violations or errors or supported == 0 or not launches.get("run_step") or not launches.get("scan_step"):
        return None
    return out


def baseline_mismatches(sched, res, pods, want: dict) -> list[str]:
    """Where a solve differs from the JAX package's (a BASELINE_JAX record):
    path, relax, claims, errors, odometer structure counts, digest."""
    from karpenter_tpu_torch.testing import fuzz

    odo = sched.last_odometer or {}
    got = {"runs_path": sched.last_used_runs, "relax": sched.last_relax, "claims": len(res.new_node_claims),
           "errors": len(res.pod_errors), "digest": fuzz.snapshot_digest(fuzz.results_snapshot(res, pods))}
    bad = [f"{k} {got[k]} != {v}" for k, v in want.items() if k != "odometer" and got[k] != v]
    return bad + [f"odometer {k} {odo.get(k)} != {v}" for k, v in want["odometer"].items() if odo.get(k) != v]


def baseline_uses(name: str) -> int:
    """The fresh worlds baseline_phase takes of a config: the warm-up, the
    counted solve, solve_in_process, the timed solves past the counted
    one (none for the last config: they wait for the end of the run) and
    the host phases."""
    return 4 + (0 if name == list(BASELINE_JAX)[-1] else BASELINE_TIMED - 1)


def baseline_worlds() -> dict:
    """Each baseline config's worlds, as many as baseline_phase takes (host
    work only: main builds them while nvcc runs)."""
    return {name: [baseline_world(name) for _ in range(baseline_uses(name))] for name in BASELINE_JAX}


def baseline_solve(name: str, dev, world: Optional[World] = None) -> float:
    """One timed TorchScheduler.solve of a baseline config in a fresh world
    (host clock to a device sync; the world's build and a collection of
    the last world's garbage before the clock starts): its seconds."""
    import gc

    import torch

    sched, pods = scheduler_for(world or baseline_world(name), dev)
    gc.collect()
    t0 = time.monotonic()
    sched.solve(pods)
    torch.cuda.synchronize()
    return time.monotonic() - t0


def baseline_phase(dev, host: HostChecks, worlds: Optional[dict] = None) -> Optional[dict]:
    """BASELINE.json's provisioning configs at full width on the card, one
    fresh world alive at a time: a warm-up solve with every launch table
    in device memory (equal to the JAX package's too); a TorchScheduler.solve
    with the launch counts set to 0 just before, equal to the JAX package's
    (BASELINE_JAX: path, relax, claims, errors, odometer, digest), every pod
    placed or errored, no kernel-route error, its peak device bytes and
    where K3 kept its tables; the same problem through solve_in_process (no
    fallback of any kind, the same digest); BASELINE_TIMED
    timed solves, the counted one first, and the host phases of one. The
    last config's further timed solves wait for the end of the run
    (baseline_late_timing). Worlds come from `worlds` (baseline_worlds)
    while it has them, else are built here. The oracle referees BASELINE_ORACLE's
    partitions, and K5's plain version the decode of each config that
    dedups its claims, in the side process. Returns each config's record
    and the launches by kernel summed, or None on any failure."""
    import gc

    import torch

    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver import tpu_runs as KR
    from karpenter_tpu_torch.solver.hybrid import solve_in_process
    from karpenter_tpu_torch.testing import fuzz

    t_phase = time.monotonic()
    counted = (T.LAUNCHES, K.LAUNCHES, KR.LAUNCHES)
    out, total = {}, {}
    last = list(BASELINE_JAX)[-1]
    for name, want in BASELINE_JAX.items():
        t_cfg = time.monotonic()
        ready = (worlds or {}).pop(name, [])

        def take():
            return ready.pop() if ready else baseline_world(name)

        # the warm-up: the solve with every launch table in device memory,
        # which must decide as the JAX package does too
        sched, pods = scheduler_for(take(), dev)
        t0 = time.monotonic()
        res_d, layout_d = device_tables_launch("run_step", lambda: sched.solve(pods))
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        bad_d = baseline_mismatches(sched, res_d, pods, want)
        log(f"baseline {name} warm-up with every table in device memory ({layout_d}): {warm_s:.3f}s, "
            f"{bad_d or 'equal'}")
        if bad_d or any(layout_d["shared"].values()):
            return None
        del res_d, sched, pods

        world = take()
        n_pods, n_types = len(world.pods), len(next(iter(world.ibp.values())))
        sched, pods = scheduler_for(world, dev)
        errors_before = tpu_errors()
        decoded = []  # K5's call in this solve: (the final state's columns, n2, its output)
        dedup = T.dedup_decode_state

        def captured(st, n2):
            got = dedup(st, n2)
            decoded.append((T.decode_columns(st), n2, got))
            return got

        T.dedup_decode_state = captured
        try:
            for counts in counted:
                for k in counts:
                    counts[k] = 0
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # earlier phases' tensors still alive
            t0 = time.monotonic()
            res = sched.solve(pods)
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
        finally:
            T.dedup_decode_state = dedup
        launches = {k: v for counts in counted for k, v in counts.items() if v}
        peak = torch.cuda.max_memory_allocated()
        layout = K.last_layout("run_step")
        bad = baseline_mismatches(sched, res, pods, want)
        placed = sum(len(c.pods) for c in res.new_node_claims) + sum(len(n.pods) for n in res.existing_nodes)
        if placed + len(res.pod_errors) != n_pods:
            bad.append(f"{placed} placed + {len(res.pod_errors)} errors of {n_pods} pods")
        if tpu_errors() != errors_before:
            bad.append("a kernel-route error")
        if min(launches.get(k, 0) for k in ("typeok_screen", "run_step", "run_arrays")) < 1:
            bad.append("a kernel of the runs path never launched")
        if (len(decoded) == 1) != (launches.get("dedup_rows", 0) == 1):
            bad.append(f"K5 launched {launches.get('dedup_rows', 0)} times for {len(decoded)} decode dedups")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        odo = sched.last_odometer
        log(
            f"baseline {name} on {torch.cuda.get_device_name(0)}: {n_pods} pods x {n_types} types in {dt:.3f}s "
            f"(warm-up {warm_s:.3f}s); runs path={sched.last_used_runs} relax={sched.last_relax} "
            f"claims={len(res.new_node_claims)} placed={placed} errors={len(res.pod_errors)} "
            f"odometer={json.dumps({k: odo.get(k) for k in want['odometer']})} launches={launches} "
            f"peak device bytes={peak} ({peak - held} above the {held} held before) K3 tables {layout}; "
            f"vs the JAX package: {bad or 'equal'}"
        )
        if bad:
            return None
        if name in BASELINE_ORACLE:
            host.submit(f"oracle {name}", "oracle_partition", (name,), partition_view(res, pods))
        if decoded:
            cols, n2, got = decoded[0]
            host.submit(f"K5 {name} decode", "dedup_columns", (cols, n2), got)
        del decoded, res, sched, pods, world

        # the entry route: the same problem through solve_in_process
        w = take()
        t0 = time.monotonic()
        sip_res, h = solve_in_process(w.pools, w.ibp, w.pods, device=dev)
        torch.cuda.synchronize()
        sip_s = time.monotonic() - t0
        sip_digest = fuzz.snapshot_digest(fuzz.results_snapshot(sip_res, w.pods))
        log(f"baseline {name} through solve_in_process: {sip_s:.3f}s, used_tpu={h.used_tpu} "
            f"fallback_kind={h.fallback_kind} digest {'equal' if sip_digest == want['digest'] else 'DIFFERENT'}")
        if not h.used_tpu or h.fallback_kind is not None or sip_digest != want["digest"]:
            return None
        del sip_res, h, w

        # the timed solves (the counted one first) and the host phases of one
        times = [dt]
        while len(times) < (1 if name == last else BASELINE_TIMED):
            times.append(baseline_solve(name, dev, take()))
        phases = phase_breakdown(take(), dev)
        out[name] = {"pods": n_pods, "types": n_types, "seconds": times, "peak_bytes": peak,
                     "solve_peak_bytes": peak - held, "launches": launches,
                     "phases": phases, "layout": layout, "solve_in_process_s": sip_s,
                     "config_s": time.monotonic() - t_cfg}
        log(f"baseline {name} solve seconds: {[round(x, 4) for x in times]}; phases (s): "
            f"{json.dumps({k: round(v, 4) for k, v in phases.items()})}; {time.monotonic() - t_cfg:.1f}s for the config")
    log(f"baseline configs phase: {time.monotonic() - t_phase:.1f}s; launches {json.dumps(total)}")
    return {"configs": out, "launches": total, "seconds": time.monotonic() - t_phase}


def baseline_late_timing(baseline: dict, dev, t_start: float) -> None:
    """At the end of the run: the last baseline config's further timed
    solves, up to BASELINE_TIMED, while the run is under BASELINE_LATE_S
    (past it, that config keeps its one timed solve, and the log says so);
    then each config's median pods/s."""
    last = list(BASELINE_JAX)[-1]
    rec = baseline["configs"][last]
    while len(rec["seconds"]) < BASELINE_TIMED:
        if time.monotonic() - t_start > BASELINE_LATE_S:
            log(f"baseline {last}: the run is past {BASELINE_LATE_S:.0f}s, {len(rec['seconds'])} timed solve(s)")
            break
        rec["seconds"].append(baseline_solve(last, dev))
    for name, r in baseline["configs"].items():
        r["median_s"] = sorted(r["seconds"])[len(r["seconds"]) // 2]
        r["pods_per_s"] = r["pods"] / r["median_s"]
        log(f"baseline {name} solve seconds (n={len(r['seconds'])}): {[round(x, 4) for x in r['seconds']]}; "
            f"median {r['median_s']:.4f}s = {r['pods_per_s']:.1f} pods/s")


def operator_phase(dev, its, oracle: RecordProcess) -> Optional[dict]:
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


# ---------------------------------------------------------------------------
# the gates phase (gates_phase): the paths that ran only on the CPU before,
# on the card


def gates_worlds() -> dict:
    """The gates phase's fleets (host work: main builds them while nvcc
    runs): (a)'s replace fleet at SWEEP_NODES and at SINGLE_NODES, and
    (b)'s fleet of the c4 shape."""
    from karpenter_tpu_torch.testing.fixtures import underutilized_world

    return {
        "replace": underutilized_world(SWEEP_NODES, n_pending=SWEEP_PENDING, **GATES_FLEET),
        "replace_single": underutilized_world(SINGLE_NODES, n_pending=SWEEP_PENDING, **GATES_FLEET),
        "c4": underutilized_world(SWEEP_NODES, seed=7, n_pending=SWEEP_PENDING),
    }


def gates_options(**kw):
    """The gates phase's Options: the spot-to-spot gate on (the KWOK
    catalog launches spot, so a replace of spot nodes needs it)."""
    from karpenter_tpu_torch.options import FeatureGates, Options

    return Options(feature_gates=FeatureGates(spot_to_spot_consolidation=True), **kw)


def referee_verdict(got: bool, validator, cmd) -> list[str]:
    """A forked referee: the force_oracle Validator's verdict on `cmd`
    against the card's."""
    want = validator.validate(cmd)
    return [] if want == got else [f"card {got} / oracle {want}"]


def removal_referee(w, cmd, opts) -> list[str]:
    """A forked referee: the oracle's simulation of removing the Command's
    candidates places every pod with at most one new claim."""
    from karpenter_tpu_torch.controllers.disruption.helpers import simulate_scheduling

    sim = simulate_scheduling(w.kube, w.cluster, w.cloud, cmd.candidates, opts, force_oracle=True)
    return [] if sim.all_pods_scheduled() and len(sim.non_empty_new_claims()) <= 1 else ["removal infeasible"]


def gates_replace(dev, host: "HostChecks", w, w_single, total: dict, bad: list):
    """(a): a replace Command at the c4 width, on gates_worlds()'s replace
    fleet `w` (REPLACE_FLEETS[0] of tests/test_torch_consolidation.py at
    SWEEP_NODES nodes) with the spot-to-spot gate on.

    (a1) the DisruptionController's first reconcile proposes
         MultiNodeConsolidation(sweep="sets")'s Command: a replace, K8
         launched; the oracle's simulation of the removal feasible
         (forked);
    (a2) the batched rung (K6) against the binary search on the oracle
         (forked);
    (a3) SingleNodeConsolidation on `w_single` (one K6 singleton launch)
         against its sequential walk on the oracle (forked);
    (a4) (a1)'s Command rebuilt by compute_consolidation with
         tpu_min_pods=0 (K1, K3 or K2, K4, K5 with _DEDUP_DECODE_MIN
         lowered to 1) equal to the default route's: candidates, decision,
         each replacement's types in order, savings to 1e-12;
    the Validator's re-simulation on the kernels: (a1)'s Command passes on
         the fleet as it is and is vetoed once GATES_VETO_PODS pending pods
         need more new claims than its replacements, each verdict equal to
         the force_oracle Validator's (forked);
    (a5) the round trip of (a1)'s proposal (gates_round_trip).
    Appends each failure to `bad`."""
    from karpenter_tpu_torch.controllers import provisioning as P
    from karpenter_tpu_torch.controllers.disruption import consolidation as CN
    from karpenter_tpu_torch.controllers.disruption import setsweep as SS
    from karpenter_tpu_torch.controllers.disruption.controller import DisruptionController
    from karpenter_tpu_torch.controllers.disruption.queue import Validator
    from karpenter_tpu_torch.controllers.disruption.types import command_savings
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.solver import tpu as T

    opts = gates_options()
    args = (w.kube, w.cluster, w.cloud, w.clock)
    # the replacement is named after the fleet's claims
    P._claim_name_seq[0] = max([P._claim_name_seq[0]] + [int(n.rsplit("-", 1)[1]) for n in w.kube._store("NodeClaim")])
    prov = Provisioner(*args, opts, device=dev)
    ctrl = DisruptionController(*args[:3], prov, w.clock, opts, device=dev)
    before = live_nodes(w)
    _, n = counted_path(total, "gates (a1) DisruptionController.reconcile 1 (propose)", ctrl.reconcile)
    log(f"gates (a1) last_search_stats: {json.dumps(SS.last_search_stats)}")
    cmd_a = ctrl._pending_validation[1] if ctrl._pending_validation else None
    if cmd_a is None or cmd_a.decision != "replace" or cmd_a.reason != "underutilized" or n.get("set_sweep", 0) < 1:
        bad.append("(a1) no replace Command, or K8 not launched")
        return
    show_command("gates (a1)", cmd_a)
    host.fork("gates (a1) the removal on the oracle", removal_referee, w, cmd_a, opts)

    cmds_b, n = counted_path(total, "gates (a2) MultiNodeConsolidation(sweep='batched')",
                             CN.MultiNodeConsolidation(*args, options=opts, sweep="batched", device=dev).compute_commands)
    if not cmds_b or n.get("fast_sweep", 0) < 1:
        bad.append("(a2) no Command, or K6 not launched")
    else:
        show_command("gates (a2)", cmds_b[0])
        host.fork("gates (a2) batched vs the binary search on the oracle", referee_commands,
                  [command_key(c) for c in cmds_b], CN.MultiNodeConsolidation(*args, options=opts, sweep="binary",
                                                                            force_oracle=True))
        if command_savings(cmd_a) < command_savings(cmds_b[0]):
            bad.append("(a1) savings below the batched rung's")

    a1 = (w_single.kube, w_single.cluster, w_single.cloud, w_single.clock)
    cmds_c, n = counted_path(total, f"gates (a3) SingleNodeConsolidation, {SINGLE_NODES}-node fleet",
                             CN.SingleNodeConsolidation(*a1, options=opts, device=dev).compute_commands)
    if n.get("fast_sweep_singleton", 0) != 1:
        bad.append("(a3) not one K6 singleton launch")
    for c in cmds_c:
        show_command("gates (a3)", c)
    host.fork("gates (a3) single-node vs the sequential walk on the oracle", referee_commands,
              [command_key(c) for c in cmds_c], CN.SingleNodeConsolidation(*a1, options=opts, force_oracle=True))

    kernels = CN.MultiNodeConsolidation(*args, options=gates_options(tpu_min_pods=0), device=dev)
    dedup_min, T._DEDUP_DECODE_MIN = T._DEDUP_DECODE_MIN, 1
    try:
        cmd_d, n = counted_path(total, "gates (a4) compute_consolidation, tpu_min_pods=0",
                                lambda: kernels.compute_consolidation(cmd_a.candidates))
    finally:
        T._DEDUP_DECODE_MIN = dedup_min
    k_step = sum(n.get(k, 0) for k in ("run_step", "run_step_relax", "scan_step", "scan_step_relax"))
    same = not commands_differ([command_key(cmd_d)], [command_key(cmd_a)])
    log(f"gates (a4) the kernel route's Command vs the default route's: {'equal' if same else 'DIFFERENT'}")
    if not same:
        bad.append("(a4) the kernel route's Command")
    if min(n.get(k, 0) for k in ("typeok_screen", "run_arrays", "dedup_rows")) < 1 or not k_step:
        bad.append("(a4) kernel launches")

    # the Validator's re-simulation on the kernels: a pass, then a veto
    card = Validator(*args, gates_options(tpu_min_pods=0), device=dev)
    oracle = Validator(*args, opts, force_oracle=True)
    verdicts = {}
    for label in ("pass", "veto"):
        if label == "veto":
            veto_pods(w.kube)
        ok, n = counted_path(total, f"gates (a) Validator, {label}", lambda: card.validate(cmd_a))
        verdicts[label] = ok
        host.fork(f"gates (a) Validator {label} vs the oracle's", referee_verdict, ok, oracle, cmd_a)
        if not n.get("typeok_screen", 0) or not sum(n.get(k, 0) for k in ("run_step", "scan_step")):
            bad.append(f"(a) Validator {label}: the re-simulation not on the kernels")
    for p in veto_pods(None):
        w.kube.delete("Pod", p)
    log(f"gates (a) Validator verdicts on (a1)'s Command: {verdicts}")
    if verdicts != {"pass": True, "veto": False}:
        bad.append("(a) Validator verdicts")
    gates_round_trip(w, ctrl, prov, cmd_a, before, total, bad)


def veto_pods(kube) -> list:
    """(a)'s veto: GATES_VETO_PODS pending pods of GATES_VETO_REQUESTS with
    hostname anti-affinity among themselves (each needs a new claim of its
    own) created in `kube`; their names either way."""
    from karpenter_tpu_torch.api import labels as well_known
    from karpenter_tpu_torch.api.objects import LabelSelector, PodAffinityTerm
    from karpenter_tpu_torch.testing import fixtures

    names = [f"veto-{i}" for i in range(GATES_VETO_PODS)]
    if kube is not None:
        for name in names:
            kube.create("Pod", fixtures.pod(
                name=name, labels={"fleet": "veto"}, requests=dict(GATES_VETO_REQUESTS),
                pod_anti_requirements=[PodAffinityTerm(topology_key=well_known.HOSTNAME_LABEL_KEY,
                                                       label_selector=LabelSelector(match_labels={"fleet": "veto"}))]))
    return names


def gates_round_trip(w, ctrl, prov, cmd_a, before: set, total: dict, bad: list) -> None:
    """(a5): the DisruptionController `ctrl` that proposed (a1)'s Command
    (`before`: the live nodes then) validates it after the TTL and starts
    it (the replacement through its Provisioner `prov`); then, a tick of
    GATES_TICK_S at a time (at most
    GATES_ROUND_TRIP_TICKS), the KWOK provider registers nodes, the
    lifecycle controller launches, registers and initializes the
    replacement, the queue deletes the originals' claims and
    NodeTermination drains their nodes, until they are gone."""
    from karpenter_tpu_torch.api.objects import COND_INITIALIZED, COND_LAUNCHED, COND_REGISTERED
    from karpenter_tpu_torch.controllers.disruption.queue import VALIDATION_TTL_SECONDS
    from karpenter_tpu_torch.controllers.lifecycle import NodeClaimLifecycle
    from karpenter_tpu_torch.controllers.termination import NodeTermination

    lifecycle = NodeClaimLifecycle(w.kube, w.cluster, w.cloud, w.clock, ctrl.opts)
    termination = NodeTermination(w.kube, w.cluster, w.cloud, w.clock)
    t0 = time.monotonic()
    w.clock.advance(VALIDATION_TTL_SECONDS)
    started, _ = counted_path(total, "gates (a5) reconcile 2 (validate, start)", ctrl.reconcile)
    if started is None or command_key(started)[0] != command_key(cmd_a)[0]:
        bad.append("(a5) validation")
        return
    new_claims = list(ctrl.queue.in_flight[0].replacement_names)
    removed = {c.name for c in started.candidates}
    claims = {c.claim_name() for c in started.candidates}
    riders = {p.name for c in started.candidates for p in c.reschedulable_pods}

    def drive():
        for n in range(1, GATES_ROUND_TRIP_TICKS + 1):
            w.clock.advance(GATES_TICK_S)
            w.cloud.reconcile()
            lifecycle.reconcile_all()
            ctrl.queue.reconcile()
            termination.reconcile_all()
            if not ctrl.queue.busy and not (removed & set(w.kube._store("Node"))) and not (
                    claims & set(w.kube._store("NodeClaim"))):
                return n
        return GATES_ROUND_TRIP_TICKS

    ticks, _ = counted_path(total, "gates (a5) lifecycle, queue and termination", drive)
    conds = [tuple(w.kube.get("NodeClaim", name).status.conditions.get(k)
                   for k in (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED))
             if w.kube.try_get("NodeClaim", name) is not None else None for name in new_claims]
    after = live_nodes(w)
    waiting = {p.name for p in prov.get_pending_pods()}
    pods = w.kube.list("Pod")
    stray = [p.name for p in pods if p.node_name not in after and p.name not in waiting]
    evicted = riders - {p.name for p in pods if p.node_name}
    log(f"gates (a5): {len(before)} -> {len(after)} live nodes ({len(removed)} removed, replacement claim(s) "
        f"{new_claims} launched/registered/initialized {conds}), {len(evicted)} of {len(riders)} riders evicted, "
        f"{len(waiting)} pods for the next provisioning round, {len(stray)} stray; {ticks} ticks; "
        f"{time.monotonic() - t0:.1f}s for the round trip")
    if len(new_claims) != len(started.replacements) or any(c != ("True",) * 3 for c in conds):
        bad.append("(a5) the replacement not brought up by the lifecycle controller")
    if ctrl.queue.busy or after != (before - removed) | set(new_claims):
        bad.append("(a5) the originals not drained and removed")
    if stray or evicted != riders:
        bad.append("(a5) pods")


def gates_disruption(dev, host: "HostChecks", w, total: dict, bad: list) -> None:
    """(b) on gates_worlds()'s fleet of the c4 shape (SWEEP_NODES nodes):
    Drift — the NodePool's template label changed, every claim drifted
    (NodePoolHash, Hydration, NodeClaimDisruptionConditions), DriftConsolidation with
    tpu_min_pods=0 (its simulation on the kernels) against the
    force_oracle route's (forked); Emptiness — the pods of GATES_EMPTIED
    nodes deleted, EmptinessConsolidation's Command names exactly those
    nodes; the Validator's emptiness branch passes it, then vetoes it
    once a pod is bound to one of them, each verdict equal to the
    force_oracle Validator's. Appends each failure to `bad`."""
    from karpenter_tpu_torch.controllers.disruption import consolidation as CN
    from karpenter_tpu_torch.controllers.disruption.queue import Validator
    from karpenter_tpu_torch.controllers.nodeclaim_aux import Hydration, NodeClaimDisruptionConditions
    from karpenter_tpu_torch.controllers.nodepool_aux import NodePoolHash
    from karpenter_tpu_torch.testing import fixtures

    opts = gates_options(tpu_min_pods=0)
    args = (w.kube, w.cluster, w.cloud, w.clock)
    t0 = time.monotonic()
    # the fleet's claims carry no drift hash: Hydration stamps the pool's
    NodePoolHash(w.kube).reconcile_all()
    Hydration(w.kube).reconcile_all()
    pool = w.kube.get("NodePool", "default")
    pool.template.labels["fleet"] = "v2"
    w.kube.update("NodePool", pool)
    NodePoolHash(w.kube).reconcile_all()
    NodeClaimDisruptionConditions(*args).reconcile_all()
    drifted = sum(1 for c in w.kube._store("NodeClaim").values() if c.status.conditions.get("Drifted") == "True")
    log(f"gates (b) drift: {drifted} of {len(w.kube._store('NodeClaim'))} claims drifted "
        f"({time.monotonic() - t0:.1f}s host)")
    cmds, n = counted_path(total, "gates (b) DriftConsolidation, tpu_min_pods=0",
                           CN.DriftConsolidation(*args, options=opts, device=dev).compute_commands)
    for c in cmds:
        show_command("gates (b) drift", c)
    if drifted != SWEEP_NODES or not cmds or cmds[0].reason != "drifted":
        bad.append("(b) drift: no drifted Command")
    if not n.get("typeok_screen", 0) or not sum(n.get(k, 0) for k in ("run_step", "scan_step")):
        bad.append("(b) drift: the simulation not on the kernels")
    host.fork("gates (b) drift vs the oracle's", referee_commands, [command_key(c) for c in cmds],
              CN.DriftConsolidation(*args, options=opts, force_oracle=True))

    emptied = sorted(sn.name for sn in w.cluster.state_nodes() if sn.node is not None)[:GATES_EMPTIED]
    for name in emptied:
        for p in w.cluster.pods_on(name):
            w.kube.delete("Pod", p.name)
    cmds, _ = counted_path(total, "gates (b) EmptinessConsolidation",
                           CN.EmptinessConsolidation(*args, options=opts, device=dev).compute_commands)
    named = sorted(c.name for c in cmds[0].candidates) if cmds else []
    log(f"gates (b) emptiness: {len(emptied)} nodes emptied, the Command names {len(named)} "
        f"({'exactly those' if named == emptied else 'OTHERS'})")
    if named != emptied or cmds[0].reason != "empty" or cmds[0].decision != "delete":
        bad.append("(b) emptiness")
        return
    card = Validator(*args, opts, device=dev)
    oracle = Validator(*args, opts, force_oracle=True)
    verdicts = {}
    for label in ("pass", "veto"):
        if label == "veto":
            w.kube.create("Pod", fixtures.pod(name="intruder", requests={"cpu": "100m"}))
            w.kube.bind("intruder", emptied[0])
        verdicts[label] = (card.validate(cmds[0]), oracle.validate(cmds[0]))
    log(f"gates (b) Validator on the emptiness Command (card, oracle): {verdicts}")
    if verdicts != {"pass": (True, True), "veto": (False, False)}:
        bad.append("(b) Validator on the emptiness Command")


def gates_static_drift(dev, bad: list) -> None:
    """(b)'s StaticDrift: a static pool of 2 replicas under each `nodes`
    limit of STATIC_DRIFT_PINS, drifted; the Commands and their node-count
    reservations must be what tests/test_torch_consolidation.py pins for
    the same limits (one Command and one reserved node a replacement the
    limit grants, none at the replica count). StaticDrift runs no device
    code; the pool settles on an Operator on the card."""
    from karpenter_tpu_torch.controllers.disruption.staticdrift import StaticDrift
    from karpenter_tpu_torch.controllers.kube import FakeClock
    from karpenter_tpu_torch.controllers.operator import Operator
    from karpenter_tpu_torch.options import FeatureGates, Options
    from karpenter_tpu_torch.testing import fixtures

    got = {}
    for limit in STATIC_DRIFT_PINS:
        op = Operator(clock=FakeClock(), options=Options(feature_gates=FeatureGates(static_capacity=True)), device=dev)
        op.kube.create("NodePool", fixtures.node_pool(name="warm", replicas=2, limits={"nodes": limit} if limit else {}))
        op.run_until_settled(max_ticks=40)
        pool = op.kube.list("NodePool")[0]
        pool.template.labels["fleet"] = "v2"
        pool.disruption.budgets[0].nodes = "100%"
        op.kube.update("NodePool", pool)
        op.nodepool_hash.reconcile_all()
        op.claim_conditions.reconcile_all()
        cmds = StaticDrift(op.kube, op.cluster, op.cloud, op.clock).compute_commands()
        got[limit] = (len(cmds), sum(c.reserved_count for c in cmds), op.cluster.nodepool_state._reserved.get("warm", 0))
        op.stop()
    want = {limit: (n, n, n) for limit, n in STATIC_DRIFT_PINS.items()}
    log(f"gates (b) StaticDrift (Commands, reserved by the Commands, reserved in the pool's state) by nodes limit: "
        f"{got}; pinned {want}")
    if got != want:
        bad.append("(b) StaticDrift reservations")

def gated_operator(its, dev, force_oracle: bool = False):
    """(c)'s cluster: operator_cluster's dynamic pool and DECISIONS_PODS
    pending pods under an Operator with all five feature gates on, beside
    a static NodePool of GATED_STATIC[0] replicas (a 100% budget), a
    NodeOverlay that adjusts one instance family's prices (GATED_PRICE) and
    one that gives another family an extended resource (GATED_GPU), of
    which every GATED_GPU_EVERY-th c6 pod requests one. KWOK fabricates a
    node from its raw instance type, so a node of the capacity overlay's
    family comes up here with the resource on its capacity and allocatable,
    as its device plugin would advertise it: without that, a pod that
    requests the resource fits no registered node, and the Provisioner
    launches claims for it without end (in the JAX package too)."""
    from karpenter_tpu_torch.api.objects import Budget, NodeSelectorRequirement, ObjectMeta
    from karpenter_tpu_torch.api.objects import Operator as Op
    from karpenter_tpu_torch.cloudprovider.kwok import INSTANCE_FAMILY_LABEL_KEY
    from karpenter_tpu_torch.controllers.nodeoverlay import NodeOverlay
    from karpenter_tpu_torch.options import FeatureGates
    from karpenter_tpu_torch.testing import fixtures

    gates = FeatureGates(node_repair=True, reserved_capacity=True, spot_to_spot_consolidation=True,
                         node_overlay=True, static_capacity=True)
    op = operator_cluster(*DECISIONS_PODS, its, dev, force_oracle=force_oracle, gates=gates)
    op.kube.create("NodePool", fixtures.node_pool(name="static", replicas=GATED_STATIC[0],
                                                  budgets=[Budget(nodes="100%")]))
    (price_family, price, _), (gpu_family, gpu, gpu_count) = GATED_PRICE, GATED_GPU
    for name, family, patch in (("price", price_family, {"price_adjustment": price}),
                                ("gpu", gpu_family, {"capacity": {gpu: gpu_count * 1000}})):
        op.kube.create("NodeOverlay", NodeOverlay(
            metadata=ObjectMeta(name=name),
            requirements=[NodeSelectorRequirement(INSTANCE_FAMILY_LABEL_KEY, Op.IN, [family])], **patch))
    for i in range(0, DECISIONS_PODS[0], GATED_GPU_EVERY):
        p = op.kube.get("Pod", f"c6-{i}")
        p.requests[gpu] = 1000
        op.kube.update("Pod", p)
    raw_create = op.raw_cloud.create

    def create(claim):
        out = raw_create(claim)
        if out.metadata.labels.get(INSTANCE_FAMILY_LABEL_KEY) == gpu_family:
            node = op.raw_cloud._pending_nodes[-1][1]
            for rl in (out.status.capacity, out.status.allocatable, node.capacity, node.allocatable):
                rl[gpu] = gpu_count * 1000
        return out

    op.raw_cloud.create = create
    return op


def gated_run(op) -> dict:
    """(c)'s scenario on gated_operator(): run_until_settled; then Ready=False
    on every GATED_REPAIR_EVERY-th node of the dynamic pool (by name) and
    a tick past the repair policy's toleration, then ticks of 2 s until
    settled with every pod of those nodes re-created after its eviction
    (as its workload would: the same spec, unbound) and placed again;
    then the static pool's template drifted, then its replicas cut to
    GATED_STATIC[1], each followed by ticks of GATED_TICK_S until the pool
    holds its replicas on the new template with nothing deleting (at most
    GATED_TICKS). Returns what (c) compares and shows: the claims after
    provisioning (claims_view), every Command started, the nodes repaired,
    the final node set, the families the extended-resource pods run on,
    the repaired nodes' pods evicted, re-created and placed again with the
    launches of that settle, the ticks of each step and the host seconds,
    JSON as the oracle's process prints it."""
    from karpenter_tpu_torch.api import labels as well_known
    from karpenter_tpu_torch.api.objects import PodPhase
    from karpenter_tpu_torch.cloudprovider.kwok import INSTANCE_FAMILY_LABEL_KEY
    from karpenter_tpu_torch.controllers import nodepool_aux

    commands: list = []
    reconcile = op.disruption.reconcile

    def recorded():
        cmd = reconcile()
        if cmd is not None:
            commands.append(command_record(cmd))
        return cmd

    op.disruption.reconcile = recorded
    gpu = GATED_GPU[1]
    ticks: dict = {}
    host: dict = {}

    def static_nodes() -> list:
        return [n for n in op.kube._store("Node").values()
                if n.metadata.labels.get(well_known.NODEPOOL_LABEL_KEY) == "static"]

    def until(label: str, done) -> None:
        t0 = time.monotonic()
        n = 0
        while n < GATED_TICKS and not done():
            op.step(GATED_TICK_S)
            n += 1
        ticks[label], host[label] = n, time.monotonic() - t0

    t0 = time.monotonic()
    ticks["settle"] = op.run_until_settled(max_ticks=OPERATOR_TICKS)
    host["settle"] = time.monotonic() - t0
    settled = op.settled()
    claims = claims_view(op.kube.list("NodeClaim"))
    nodes_provisioned = len(op.kube._store("Node"))
    # the repair: Ready=False past the toleration
    toleration = max(p.toleration_seconds for p in op.cloud.repair_policies())
    dynamic = sorted(n.name for n in op.kube._store("Node").values()
                     if n.metadata.labels.get(well_known.NODEPOOL_LABEL_KEY) == "default")
    broken = dynamic[::GATED_REPAIR_EVERY]
    # their pods, which their workload re-creates (unbound, under the same
    # names) once the drain has deleted them
    evictees = {p.name: copy.deepcopy(p) for p in op.kube._store("Pod").values() if p.node_name in broken}
    recreated: set = set()

    def step(advance: float) -> None:
        op.step(advance)
        for name, pod in evictees.items():
            if name not in op.kube._store("Pod"):
                fresh = copy.deepcopy(pod)
                fresh.node_name, fresh.phase, fresh.terminating = "", PodPhase.PENDING, False
                fresh.metadata.creation_timestamp = 0.0
                op.kube.create("Pod", fresh)
                recreated.add(name)

    for name in broken:
        node = op.kube.get("Node", name)
        node.conditions["Ready"] = "False"
        node.ready = False
        op.kube.update("Node", node)
    repaired0 = nodepool_aux.NODES_REPAIRED.value({"condition": "Ready"})
    launches0 = launch_counts()
    t0 = time.monotonic()
    step(GATED_TICK_S)
    step(toleration + 1.0)
    repaired = nodepool_aux.NODES_REPAIRED.value({"condition": "Ready"}) - repaired0
    host["repair"] = time.monotonic() - t0
    t0 = time.monotonic()
    n = 0
    while n < GATED_TICKS and not (n and op.settled() and recreated == set(evictees)):
        step(2.0)
        n += 1
    ticks["repair_settle"], host["repair_settle"] = n, time.monotonic() - t0
    launches_repair = {k: v - launches0.get(k, 0) for k, v in launch_counts().items() if v != launches0.get(k, 0)}
    pods = op.kube._store("Pod")
    replaced = sum(1 for name in evictees if pods[name].node_name and pods[name].node_name not in broken)
    # StaticDrift: a new template label, then the scale-down
    pool = op.kube.get("NodePool", "static")
    pool.template.labels["fleet"] = "v2"
    op.kube.update("NodePool", pool)

    def static_holds(n: int):
        def holds() -> bool:
            claims = [c for c in op.kube._store("NodeClaim").values() if c.nodepool_name == "static"]
            return len(claims) == len(static_nodes()) == n and all(
                c.metadata.deletion_timestamp is None and c.metadata.labels.get("fleet") == "v2" for c in claims)
        return holds

    until("static_drift", static_holds(GATED_STATIC[0]))
    pool = op.kube.get("NodePool", "static")
    pool.replicas = GATED_STATIC[1]
    op.kube.update("NodePool", pool)
    until("static_scale_down", static_holds(GATED_STATIC[1]))
    op.disruption.reconcile = reconcile
    nodes = op.kube._store("Node")
    gpu_families = sorted({nodes[p.node_name].metadata.labels.get(INSTANCE_FAMILY_LABEL_KEY)
                           if p.node_name in nodes else None
                           for p in op.kube._store("Pod").values() if p.requests.get(gpu)})
    return {"claims": claims, "settled": settled, "nodes_provisioned": nodes_provisioned,
            "commands": json.loads(json.dumps(commands)), "broken": broken, "repaired": repaired,
            "evicted": len(evictees), "recreated": len(recreated), "replaced": replaced,
            "launches_repair": launches_repair,
            "nodes": sorted(nodes), "static_nodes": sorted(n.name for n in static_nodes()),
            "gpu_families": gpu_families, "pending": len(op.kube.pending_pods()), "ticks": ticks, "host_s": host}


def gates_oracle_run() -> dict:
    """(c)'s oracle side: gated_run on the port's Operator(force_oracle=True)
    under the PartitionReferee, its claims named from GATES_CLAIM_SEQ0 and
    its static claims and drift replacements from GATES_STATIC_SEQ0 like the
    card's."""
    t0 = time.monotonic()
    gated_names()
    op = gated_operator(build_universe(HEADLINE_TYPES), None, force_oracle=True)
    with PartitionReferee():
        rec = gated_run(op)
    op.stop()
    rec["seconds"] = time.monotonic() - t0
    return rec


def gated_names() -> None:
    """Both sides of (c) name their claims from the same counters."""
    from karpenter_tpu_torch.controllers import provisioning as P
    from karpenter_tpu_torch.controllers import static as ST
    from karpenter_tpu_torch.controllers.disruption import staticdrift as SD

    P._claim_name_seq[0] = GATES_CLAIM_SEQ0
    ST._static_seq[0] = SD._replacement_seq[0] = GATES_STATIC_SEQ0


def gates_oracle_worker() -> int:
    """`python3 chip_smoke.py --gates-oracle`: gates_oracle_run in this
    process (the oracle alone: no card), printed as one GATES_ORACLE line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    print("GATES_ORACLE " + json.dumps(gates_oracle_run()), flush=True)
    return 0

def gates_table_cache(dev, op) -> dict:
    """(c)'s table cache: solve_in_process with one DeviceTableCache on the
    gated Operator's default pool and its overlaid instance types, the c6
    mix at DECISIONS_PODS[0] with (c)'s extended-resource pods: a first
    solve (a miss), the same solve again (a hit, no K1), again after the
    price overlay's adjustment changes to GATED_PRICE[2] (a hit: no device
    table holds a price; the decode prices the claims on the host from the
    overlaid types) and after the capacity overlay gives GATED_GPU_AFTER a
    node (a miss: the problem's fingerprint follows the capacities), each
    of the last two against the port's oracle on its partition. Returns
    each solve's cache outcome, K1 launches and route, the referee's
    disagreements and the launches."""
    import torch

    from karpenter_tpu_torch.solver import epochs
    from karpenter_tpu_torch.solver.hybrid import solve_in_process
    from karpenter_tpu_torch.solver.oracle import SchedulerOptions

    pool = op.kube.get("NodePool", "default")
    cache = epochs.DeviceTableCache()
    opts = SchedulerOptions(tpu_min_pods=0)
    pods = c6_pods(DECISIONS_PODS[0])
    for p in pods[::GATED_GPU_EVERY]:
        p.requests[GATED_GPU[1]] = 1000
    changes = {"price changed": ("price", {"price_adjustment": GATED_PRICE[2]}),
               "capacity changed": ("gpu", {"capacity": {GATED_GPU[1]: GATED_GPU_AFTER * 1000}})}
    out: dict = {"outcomes": {}, "referee": {}, "launches": {}}
    for label in ("first", "again", *changes):
        if label in changes:
            name, patch = changes[label]
            ov = op.kube.get("NodeOverlay", name)
            for k, v in patch.items():
                setattr(ov, k, v)
            op.kube.update("NodeOverlay", ov)
            op.node_overlay.reconcile_all()
        ibp = {pool.name: op.cloud.get_instance_types(pool)}
        before = {k: epochs.TABLE_CACHE.value({"outcome": k}) for k in ("hit", "miss")}
        reset_launches()
        res, sched = solve_in_process([pool], ibp, pods, options=opts, table_cache=cache, device=dev)
        torch.cuda.synchronize()
        n = launch_counts()
        for k, v in n.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        out["outcomes"][label] = {k: int(epochs.TABLE_CACHE.value({"outcome": k}) - v) for k, v in before.items()}
        out["outcomes"][label].update(typeok_screen=n.get("typeok_screen", 0), used_tpu=bool(sched.used_tpu))
        if label in changes:
            want = partition_view(solve_partitioned_oracle([pool], ibp, pods, None, None, opts, None), pods)
            out["referee"][label] = partition_mismatches(partition_view(res, pods), want)
    return out


def gates_card_run(dev) -> dict:
    """(c)'s card side, in a process of its own on the card `dev` (`python3
    chip_smoke.py --gates-card`, beside the main process's phase 14):
    gated_run on gated_operator() with Options(tpu_min_pods=0), its claims
    named as the oracle side's, then gates_table_cache on its cluster.
    Returns gated_run's record with the run's launches (counted from 0),
    the route of the last provisioning round, the table cache's record,
    the tpu_error fallbacks and the seconds."""
    import torch

    t0 = time.monotonic()
    gated_names()
    op = gated_operator(build_universe(HEADLINE_TYPES), dev)
    try:
        reset_launches()
        rec = gated_run(op)
        torch.cuda.synchronize()
        rec["launches"] = launch_counts()
        rec["route"] = op.provisioner.last_solver_used
        rec["table_cache"] = gates_table_cache(dev, op)
    finally:
        op.stop()
    rec["tpu_errors"] = tpu_errors()
    rec["seconds"] = time.monotonic() - t0
    return rec


def gates_card_worker() -> int:
    """`python3 chip_smoke.py --gates-card`: gates_card_run on the card in
    this process, printed as one GATES_CARD line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    print("GATES_CARD " + json.dumps(gates_card_run(torch.device("cuda"))), flush=True)
    return 0


def gates_operator(card: "RecordProcess", oracle: "RecordProcess", total: dict, bad: list) -> None:
    """(c): the card side (`card`, gates_card_run, started before phase 14)
    held to the port's Operator(force_oracle=True) on the same scenario
    under the PartitionReferee (`oracle`, started at the end of the build):
    equal claims after provisioning, Commands, repaired count, pods placed
    again, final nodes and ticks. On the card alone: settled, nothing
    pending, the route the kernels (K1, K3, K4), every repaired node
    counted and its pods placed again on the kernels, the
    extended-resource pods on the capacity overlay's family, every static
    node replaced by StaticDrift and the pool at GATED_STATIC[1], the table
    cache's outcomes and its solves equal to the oracle's partition, no
    tpu_error. The card side's launches go into `total`."""
    rec = card.result()
    if rec is None:
        bad.append("(c) the card's Operator")
        return
    n, tc = rec["launches"], rec["table_cache"]
    for counts in (n, tc["launches"]):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    drifts = [c for c in rec["commands"] if c["reason"] == "drifted"]
    host_s = {k: round(v, 2) for k, v in rec["host_s"].items()}
    log(f"gates (c) card (its own process, started at {rec['started_s']:.1f}s, waited {rec['waited_s']:.1f}s for): "
        f"{rec['seconds']:.1f}s; ticks {json.dumps(rec['ticks'])}, host s {json.dumps(host_s)}; launches {n}; "
        f"{len(rec['claims'])} claims, {rec['nodes_provisioned']} -> {len(rec['nodes'])} nodes; {len(rec['broken'])} "
        f"nodes Ready=False, {rec['repaired']:g} repaired, their {rec['evicted']} pods evicted, {rec['recreated']} "
        f"re-created, {rec['replaced']} placed again (launches {json.dumps(rec['launches_repair'])}); "
        f"{len(drifts)} StaticDrift Commands, static nodes {len(rec['static_nodes'])}; extended-resource pods on "
        f"{rec['gpu_families']}; Commands {json.dumps(show_commands(rec['commands']))}")
    log(f"gates (c) table cache: {json.dumps(tc['outcomes'])}; the solves after the changes vs the oracle on "
        f"their partition: {json.dumps({k: v or 'equal' for k, v in tc['referee'].items()})}; launches {tc['launches']}")
    k_runs = n.get("run_step", 0) + n.get("run_step_relax", 0)
    if rec["route"] != "tpu" or min(n.get(k, 0) for k in ("typeok_screen", "run_arrays")) < 1 or not k_runs:
        bad.append("(c) the kernel route")
    if not rec["settled"] or rec["pending"] or not rec["broken"] or rec["repaired"] != len(rec["broken"]):
        bad.append("(c) settle and repair")
    lr = rec["launches_repair"]
    if not rec["evicted"] == rec["recreated"] == rec["replaced"] > 0 or not lr.get("typeok_screen") or not (
            lr.get("run_step", 0) + lr.get("run_step_relax", 0)):
        bad.append("(c) the repaired nodes' pods not placed again on the kernels")
    if rec["gpu_families"] != [GATED_GPU[0]]:
        bad.append("(c) the extended-resource pods' family")
    if len(drifts) != GATED_STATIC[0] or len(rec["static_nodes"]) != GATED_STATIC[1]:
        bad.append("(c) StaticDrift and the scale-down")
    if rec["tpu_errors"]:
        bad.append("(c) tpu_error")
    hit, miss = (1, 0), (0, 1)
    want = {"first": miss, "again": hit, "price changed": hit, "capacity changed": miss}
    got = tc["outcomes"]
    if {k: (v["hit"], v["miss"]) for k, v in got.items()} != want or any(
            bool(v["typeok_screen"]) != (want[k] == miss) or not v["used_tpu"] for k, v in got.items()):
        bad.append("(c) table cache outcomes")
    if any(tc["referee"].values()):
        bad.append("(c) table cache: a solve against the oracle's partition")
    orc = oracle.result()
    if orc is None:
        bad.append("(c) the oracle's Operator")
        return
    log(f"gates (c) oracle (its own process, started at {orc['started_s']:.1f}s, waited {orc['waited_s']:.1f}s for): "
        f"{orc['seconds']:.1f}s, ticks {json.dumps(orc['ticks'])}")
    keys = ("claims", "commands", "repaired", "replaced", "nodes", "ticks")
    same = {k: rec[k] == orc[k] for k in keys}
    log("gates (c) card vs the oracle's Operator: "
        + ", ".join(f"{k} {'equal' if v else 'DIFFERENT'}" for k, v in same.items()))
    if not all(same.values()):
        bad.append("(c) card against the oracle")
        if not same["commands"]:
            log(f"gates (c) Commands: card {json.dumps(show_commands(rec['commands']))} / oracle "
                f"{json.dumps(show_commands(orc['commands']))}")
        if not same["nodes"]:
            log(f"gates (c) final nodes only the card kept: {sorted(set(rec['nodes']) - set(orc['nodes']))[:20]}, "
                f"only the oracle: {sorted(set(orc['nodes']) - set(rec['nodes']))[:20]}")


def gates_phase(dev, host: "HostChecks", card: "RecordProcess", oracle: "RecordProcess",
                worlds: dict) -> Optional[dict]:
    """The paths that ran only on the CPU before, through the port's own
    controllers on the card at full width, each held to a referee: (a) a
    replace Command at the c4 width (gates_replace), (b) Drift, Emptiness,
    the Validator's emptiness veto and StaticDrift's reservations
    (gates_disruption, gates_static_drift), (c) the Operator with all five
    feature gates on and the table cache across an overlay change
    (gates_operator: its card side `card` and its oracle side `oracle` run
    in processes of their own). `worlds` is gates_worlds(), built while
    nvcc ran.
    Each main path with its launch counts reset just before and read just
    after; a tpu_error fallback anywhere fails the phase. Returns
    {"launches": totals over the main paths, "seconds"}, or None when a
    check failed."""
    t_phase = time.monotonic()
    total: dict = {}
    bad: list = []
    t0 = time.monotonic()
    gates_replace(dev, host, worlds["replace"], worlds["replace_single"], total, bad)
    log(f"gates (a): {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    gates_disruption(dev, host, worlds["c4"], total, bad)
    gates_static_drift(dev, bad)
    log(f"gates (b): {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    gates_operator(card, oracle, total, bad)
    log(f"gates (c): {time.monotonic() - t0:.1f}s")
    if tpu_errors():
        bad.append("tpu_error")
    seconds = time.monotonic() - t_phase
    log(f"gates phase: {seconds:.1f}s; launches on its main paths {json.dumps(total)}; "
        f"{'failed: ' + ', '.join(bad) if bad else 'ok'}")
    return None if bad else {"launches": total, "seconds": seconds}

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


# the window of the full-state lane scan's counted fetch (K7 on the sweep
# path), whose census phase 14c prints on a line of its own
LANE_WINDOW = "cuda:sweep_lanes[runtime]"


def budgets_phase(dev, its, smi: str) -> Optional[dict]:
    """Phase 14c: the port's runtime budgets (karpenter_tpu_torch/analysis/
    runtime.py against torch_budgets.json). Every CPU-scope entry measured
    on the card, where it must read what it reads on the CPU, and every
    `cuda:` entry: a profiled window around each entry's repeat (the hand
    kernels' records held to the wrappers' count), the headline and the c6
    mix re-solved at full width under the profiler, each kernel's ptxas
    resources; each counted seam of rules_kernel.COUNTED_SEAMS must sync
    inside the window of the entry it names (runtime.seam_issues). Prints
    one {"budgets": ...} line with every measured value, the census behind
    each window and the card, then the lane scan's window (LANE_WINDOW:
    host syncs, D2H copies, hand launches, sync sites) on a line of its
    own; None on any finding."""
    from karpenter_tpu_torch.analysis import budgets as B
    from karpenter_tpu_torch.analysis import runtime as R

    t0 = time.monotonic()
    worlds = {
        "headline": lambda: scheduler_for(headline_world(HEADLINE_PODS, its), dev),
        "c6": lambda: scheduler_for(c6_world(C6_PODS, its), dev),
    }
    try:
        cpu, cuda, detail = R.measure_cuda_scope(dev, worlds)
    except Exception as e:  # noqa: BLE001 - a measurement that raised fails the phase
        log(f"budgets: the measurement raised {type(e).__name__}: {e}")
        return None
    manifest = B.BudgetManifest.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), B.DEFAULT_MANIFEST))
    cmp = manifest.check(cpu, cuda)
    issues = [i.render() for i in cmp.issues + R.seam_issues(detail)]
    slack = [i.render() for i in cmp.improvements]
    seconds = time.monotonic() - t0
    print(json.dumps({"budgets": {
        "card": smi, "seconds": round(seconds, 3), "measured": {**cpu, **cuda}, "issues": issues, "slack": slack,
        "detail": detail,
    }}, sort_keys=True), flush=True)
    log(f"budgets: {len(cpu)} CPU-scope and {len(cuda)} cuda: entries on the card in {seconds:.1f}s, "
        f"{len(issues)} findings, {len(slack)} under their ceilings")
    census = {k: cuda.get(LANE_WINDOW, {}).get(k) for k in ("host_syncs", "d2h_copies", "launches_hand")}
    census["sync_sites"] = detail.get(LANE_WINDOW, {}).get("sync_sites")
    log(f"budgets {LANE_WINDOW} window: {json.dumps(census, sort_keys=True)}")
    for line in issues:
        log(f"  budget finding: {line}")
    return None if issues else {"seconds": seconds}


def gates_oracle() -> RecordProcess:
    """The gates phase's (c) oracle side (`--gates-oracle`)."""
    return RecordProcess("--gates-oracle", "gates (c)")


def gates_card() -> RecordProcess:
    """The gates phase's (c) card side (`--gates-card`)."""
    return RecordProcess("--gates-card", "gates (c) card")


def main() -> int:
    oracle, g_oracle, g_card, host = RecordProcess(), gates_oracle(), gates_card(), HostChecks()
    _CHILDREN.extend((oracle, g_oracle, g_card, host))
    try:
        return _main(oracle, g_oracle, g_card, host)
    finally:
        for child in _CHILDREN:
            child.close()


def _main(oracle: RecordProcess, g_oracle: RecordProcess, g_card: RecordProcess, host: HostChecks) -> int:
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
        t1 = time.monotonic()
        baseline_ready = baseline_worlds()
        log(f"baseline configs' worlds built on the host while nvcc runs: {time.monotonic() - t1:.1f}s")
        t1 = time.monotonic()
        gates_ready = gates_worlds()
        log(f"gates phase's fleets built on the host while nvcc runs: {time.monotonic() - t1:.1f}s")
        built = building.result()
    oracle.start()  # phase 14 (c)'s oracle side: host work alone, beside the card's phases
    g_oracle.start()  # the gates phase's (c) oracle side, the same
    host.start()  # the fuzz cases' oracle snapshots, then the deep plain checks
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
    # version, about 11 ms a pod, runs in the side process), and over the
    # whole round for speed
    tb_h, st_h, xs_h = step_inputs(headline_world(HEADLINE_PODS, its), dev, prefix=K2_PREFIX)
    P_h = xs_h.valid.shape[0]
    k2_ms = cuda_ms(lambda: K.solve_scan(tb_h, st_h, xs_h), 3)
    got_h = K.solve_scan(tb_h, st_h, xs_h)
    st_k, kinds_k, slots_k, over_k, odo_k = got_h
    k2_layout = K.last_layout("scan_step")
    host.submit("K2 headline prefix", "solve_scan", (tb_h, st_h, xs_h), got_h)
    log(
        f"K2 scan_step headline prefix (P={P_h}, N={st_h.active.shape[0]}): kernel {k2_ms:.3f} ms, "
        f"tables {k2_layout}; its plain version in the side process"
    )
    # at the headline's shapes every type table lives in shared memory
    if not all(k2_layout["shared"].values()):
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
        rs = runs_status(got)
        kinds = got[3].cpu().tolist()
        log(
            f"K3 run_step {label}: P={rr.rx.is_head.shape[0]} n={n} E={rr.st.eavail.shape[0]} "
            f"N={rr.st.active.shape[0]} steps={rs.steps} bulk_steps={rs.bulk_steps} "
            f"over={rs.over} ptr={rs.ptr} kinds(existing/claim/new/fail)={[kinds.count(k) for k in range(4)]} "
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
    rs1 = runs_status(got1)
    if not rs1.over:
        bad.append("no overflow in the first dispatch")
    ptr1 = rs1.ptr
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
    rs2 = runs_status(got2)
    k3_ms = cuda_ms(lambda: KR.solve_runs(*first_args), 3) + cuda_ms(lambda: KR.solve_runs(*cont_args), 3)
    k3_layout = K.last_layout("run_step")
    log(
        f"K3 run_step headline: dispatch 1 N={N1} stops at ptr={ptr1} (steps={rs1.steps}, "
        f"bulk_steps={rs1.bulk_steps}); dispatch 2 N={2 * N1} over {len(batch)} pods "
        f"(steps={rs2.steps}, bulk_steps={rs2.bulk_steps}, over={rs2.over}); "
        f"kernel {k3_ms:.3f} ms, plain {k3_plain_ms:.1f} ms, tables {k3_layout}, mismatches={bad or 'none'}"
    )
    if bad or not all(k3_layout["shared"].values()):
        return 1
    k3_iters = rs1.steps + rs2.steps
    R_h = rr.tb.ialloc.shape[1]
    # every input read once, state and outputs written once; each
    # iteration's feasibility screen over the claim slots (fits: R
    # compares, type screen: IW words)
    k3_bound, k3_by = bound(
        nbytes(rr.tb, rr.st, rr.rx) + nbytes(st2) + nbytes(rx2) + 2 * 4 * (n + len(batch)),
        rs1.steps * N1 * (R_h + IW) + rs2.steps * 2 * N1 * (R_h + IW),
    )

    # ---- 5b. the runs-path stall case (K3 under a wall-clock limit), then
    # the fuzz cases on the card against the side process's oracle ----
    if stall_phase(dev) is None:
        return 1
    fuzz_out = fuzz_phase(dev, host)
    if fuzz_out is None:
        return 1

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
        n_claims, used_runs = oracle_parity(make(), dev, host, label)
        log(f"oracle parity, {label}: the card's solve {n_claims} claims, runs path={used_runs}")

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
    # the kernel on the round's first PREF_CHECK_POSITIONS positions, with
    # its tier ladders and with one trip a pod, each against the plain
    # version in the side process
    xs_pc, xs_onec = (cut_positions(x, PREF_CHECK_POSITIONS, axis=0) for x in (xs_p, xs_one))
    host.submit("K2+relax preference round", "solve_scan", (tb_p, st_p, xs_pc),
                K.solve_scan(tb_p, st_p, xs_pc, relax=True), relax=True)
    host.submit("K2+relax preference round, one trip a pod", "solve_scan", (tb_p, st_p, xs_onec),
                K.solve_scan(tb_p, st_p, xs_onec, relax=True), relax=True)
    P_p, N_p = xs_p.valid.shape[0], st_p.active.shape[0]
    n_valid_p = int(xs_p.valid.sum())
    pref_trips = int(got_p[4].tier_steps)
    pref_hist = got_p[4].tier_hist.tolist()
    log(
        f"K2 scan_step+relax preference round (P={P_p}, {n_valid_p} pods, N={N_p}): kernel {k2r_ms:.3f} ms "
        f"(one trip a pod: {k2one_ms:.3f} ms); the plain version on the first {PREF_CHECK_POSITIONS} positions in "
        f"the side process; over={bool(got_p[3])} tier_steps={pref_trips} tier_hist={pref_hist}"
    )
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
        rs = runs_status(got)
        ptr_s = rs.ptr
        log(
            f"K3 run_step+relax {label}: P={rr_s.rx.is_head.shape[0]} n={n_s} N={rr_s.st.active.shape[0]} "
            f"steps={rs.steps} bulk_steps={rs.bulk_steps} tier_steps={rs.tier_steps} "
            f"over={rs.over} ptr={ptr_s} (ntiers there: {int(rr_s.rx.x.ntiers[min(ptr_s, n_s - 1)])}) "
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
    rs61 = runs_status(got61)
    ptr61 = rs61.ptr
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
    rs62 = runs_status(got62)
    k3r_ms = cuda_ms(lambda: KR.solve_runs(*first6), 3) + cuda_ms(lambda: KR.solve_runs(*cont6), 3)
    c6_trips = rs61.tier_steps + rs62.tier_steps
    log(
        f"K3 run_step+relax c6: dispatch 1 N={N61} stops at ptr={ptr61} (steps={rs61.steps}, "
        f"bulk_steps={rs61.bulk_steps}, tier_steps={rs61.tier_steps}); dispatch 2 N={2 * N61} over "
        f"{len(batch6)} pods (steps={rs62.steps}, bulk_steps={rs62.bulk_steps}, "
        f"tier_steps={rs62.tier_steps}, over={rs62.over}); kernel {k3r_ms:.3f} ms, "
        f"plain {k3r_plain_ms:.1f} ms, mismatches={bad or 'none'}"
    )
    if bad or not rs61.over:
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
        rs61.steps * N61 * (R6 + IW) + rs62.steps * 2 * N61 * (R6 + IW),
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
        n_claims, used_runs = oracle_parity(make(), dev, host, label)
        log(f"oracle parity, {label}: the card's solve {n_claims} claims, runs path={used_runs}")

    # ---- 11 (last). BASELINE.json's provisioning configs at full width,
    # held to the JAX package's solves ----
    baseline = baseline_phase(dev, host, baseline_ready)
    del baseline_ready
    if baseline is None:
        return 1

    # ---- 11a. the provisioning entry point: Provisioner.reconcile at full
    # width, its decisions against the oracle's, the small-batch crossover ----
    entry = entry_point_phase(dev, its)
    if entry is None or not decisions_phase(dev, its, host):
        return 1
    crossover = crossover_phase(dev, its)
    if crossover is None:
        return 1

    # ---- 11b. existing nodes, host ports, limits, reservations and
    # minValues at full size; a catalog past the shared-memory budget ----
    full = full_size_phase(dev, host)
    if full is None:
        return 1

    # ---- 12. the consolidation sweeps (K6, K7, K8) ----
    c4_fleet = fleets[0]
    c4_digest = fleet_digest(c4_fleet)
    sweep_rows = sweep_phase(dev, fleets, host)
    del fleets
    if sweep_rows is None:
        return 1

    # ---- 12b. the consolidation controllers on the c4 fleet ----
    consolidation = consolidation_phase(dev, c4_fleet, c4_digest, snc_fleet, host)
    del c4_fleet, snc_fleet
    if consolidation is None:
        return 1

    # ---- 13. fleet lanes (K7 with each lane's own pod rows) ----
    fleet_row = fleet_phase(dev, its, host)
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
    # the gates phase's (c) card side: host work mostly, beside phase 14
    # (after the cold start, whose first solves it would slow down)
    g_card.start()
    operator = operator_phase(dev, its, oracle)
    if operator is None:
        return 1

    # ---- the gates phase (after phase 14, before 14c): the paths that ran
    # only on the CPU before: a replace Command, drift, emptiness, the
    # Validator's vetoes, StaticDrift, the Operator with every feature
    # gate on ----
    gates = gates_phase(dev, host, g_card, g_oracle, gates_ready)
    del gates_ready
    if gates is None:
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

    # ---- 14c. the runtime budgets (torch_budgets.json) on the card ----
    if budgets_phase(dev, its, smi) is None:
        return 1

    # ---- 14d. the side process's verdicts on the deep plain checks ----
    checks = host.finish()
    if checks is None:
        return 1
    verdicts = checks.pop("verdicts")
    log(f"host checks: {json.dumps({n: (v['bad'] or 'equal', round(v['plain_ms'], 1)) for n, v in verdicts.items()})}; "
        f"side process {json.dumps(checks)}")
    if any(v["bad"] for v in verdicts.values()):
        return 1
    k2_plain_ms = verdicts["K2 headline prefix"]["plain_ms"]
    k2r_plain_ms = verdicts["K2+relax preference round"]["plain_ms"]
    k2one_plain_ms = verdicts["K2+relax preference round, one trip a pod"]["plain_ms"]

    # ---- 14e. the last baseline config's further timed solves, while the
    # run's clock allows; each config's median ----
    baseline_late_timing(baseline, dev, t_start)

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
        # the rows whose plain version ran in the side process, on the CPU
        jobs = r.pop("plain_jobs", None)
        if jobs:
            r["plain_ms"] = sum(verdicts[j]["plain_ms"] for j in jobs)
        if jobs or r["name"] in ("scan_step", "scan_step+relax", "relax_step"):
            r["plain_device"] = "cpu (side process)"
        r["launches_fuzz"] = sum(fuzz_out["launches"].get(k, 0) for k in ROW_COUNTERS.get(r["name"], ()))
        r["launches_baseline"] = sum(baseline["launches"].get(k, 0) for k in ROW_COUNTERS.get(r["name"], ()))
        r.update(apart.get(r["name"], {}))
        if r["name"] in CONSOLIDATION_ROWS:
            r["launches_consolidation"] = sum(consolidation["launches"].get(k, 0) for k in CONSOLIDATION_ROWS[r["name"]])
        r["launches_sidecar"] = sum(sidecar["launches"].get(k, 0) for k in SIDECAR_ROWS.get(r["name"], ()))
        r["launches_sidecar_faults"] = sum(
            sidecar["faults"]["launches"].get(k, 0) for k in SIDECAR_ROWS.get(r["name"], ()))
        r["launches_operator"] = sum(operator["launches"].get(k, 0) for k in ROW_COUNTERS.get(r["name"], ()))
        r["launches_prewarm"] = sum(cold["launches_prewarm"].get(k, 0) for k in ROW_COUNTERS.get(r["name"], ()))
        r["launches_gates"] = sum(gates["launches"].get(k, 0) for k in ROW_COUNTERS.get(r["name"], ()))
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
    if len(sys.argv) == 2 and sys.argv[1] == "--gates-oracle":
        sys.exit(gates_oracle_worker())
    if len(sys.argv) == 2 and sys.argv[1] == "--gates-card":
        sys.exit(gates_card_worker())
    if len(sys.argv) == 3 and sys.argv[1] == "--host-checks":
        sys.exit(host_checks_worker(sys.argv[2]))
    sys.exit(main())
