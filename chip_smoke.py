#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (karpenter_tpu_torch).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the five CUDA kernels from csrc/ and holds each against its plain
PyTorch version on the card, bit for bit:

- K1 typeok_screen on the headline's tables;
- K2 scan_step on three small problems and a 2048-pod prefix of the
  headline round (the whole round is timed too);
- K3 run_step on three small problems (one overflows its 64 claim slots)
  and on the headline's two dispatches (up to the claim-slot overflow,
  then the rest after the state grows);
- K4 run_arrays on the headline round;
- K5 dedup_rows on the headline's final claim rows and on 16384 synthetic
  rows with many duplicates.

Then it drives the provisioning solve end to end at the headline size
(make_diverse_pods(10000) against 500 KWOK instance types on one default
NodePool) through the runs path, with the launch counts set to 0 just
before and read just after; drives the scan path (`debug_force_scan`) the
same way at 1000 pods and checks its decisions equal the runs path's;
checks decisions against the port's oracle on four problems; and prints:

- the card's name and power limit (nvidia-smi),
- one JSON line {"kernels": [...]} with each kernel's launches on its path,
  its agreement with the plain version, and its times,
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
K2_PREFIX = 2048  # headline pods K2 is held against its plain version on
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
CORE_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (fp32 figure)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def mixed_world() -> World:
    """Existing nodes (one holding a host port), a tainted pool, a pool
    with a cpu limit, tolerating pods and host-port pods."""
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


def mixed_bulk_world() -> World:
    """Existing nodes (one holding a host port) and a tainted pool beside
    the headline mix, with no pool limit: the runs path with its
    existing-node windows, and host-port pods on the exact step."""
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
    return World(pools, ibp, pods, views, None, Topology(pools, ibp, pods, state_node_views=views))


def scheduler_for(world: World, dev):
    from karpenter_tpu_torch.solver.tpu import TorchScheduler

    sched = TorchScheduler(world.pools, world.ibp, world.topo, world.views, None, world.options, device=dev)
    return sched, world.pods


def step_inputs(world: World, dev, prefix=None, in_order=False):
    """(tb, st, xs) of a world's first requeue round, built by the port:
    the pods in FFD order (or as given, like `__graft_entry__._small_problem`),
    with the scan path's claim-slot count."""
    from karpenter_tpu_torch.solver.tpu_problem import _pow2, encode_problem

    sched, pods = scheduler_for(world, dev)
    problem = encode_problem(sched.oracle, pods)
    order = sched._order_pods(problem)
    if in_order:
        order = list(range(len(pods)))
    tb = sched._tables(problem)
    sched._upload_pod_tables(problem)
    N = min(_pow2(max(64, (len(pods) + 3) // 4)), _pow2(len(pods)))
    st = sched._init_state(problem, N)
    xs = sched._pod_xs(problem, order[:prefix] if prefix else order)
    return tb, st, xs


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


def runs_round(world: World, dev, claim_slot_div: Optional[int] = None) -> RunsRound:
    """(tb, state, seq, RunX) of a world's first runs-path dispatch, built
    the way TorchScheduler.solve builds it (the run arrays through K4 on
    the card)."""
    import torch

    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver.tpu_problem import _pow2, encode_problem

    sched, pods = scheduler_for(world, dev)
    problem = encode_problem(sched.oracle, pods)
    order = sched._order_pods(problem)
    tb = sched._tables(problem)
    sched._upload_pod_tables(problem)
    sched._bulk_flags_c = T._bulk_class_flags(problem, T._bulk_gates(problem))
    if not sched._bulk_flags_c.any():
        raise RuntimeError("runs_round: no pod class passes the bulk gates")
    sched._set_runflags_dev()
    div = claim_slot_div or max(1, int(sched.opts.claim_slot_div))
    N = min(_pow2(max(64, (len(pods) + div - 1) // div)), _pow2(len(pods)))
    xs, idx_d = sched._pod_xs_with_idx(problem, order)
    rx = sched._run_x(xs, idx_d, len(order))
    seq = torch.zeros(N, dtype=torch.int32, device=dev)
    return RunsRound(sched, problem, order, tb, sched._init_state(problem, N), seq, rx)


def runs_mismatches(got, want) -> list[str]:
    """Field names where two solve_runs results differ."""
    import torch

    bad = state_mismatches(got[0], want[0])
    for i, name in ((1, "seq"), (2, "next_seq"), (3, "kinds"), (4, "slots"), (5, "overflow"), (7, "ptr")):
        if not torch.equal(got[i], want[i]):
            bad.append(name)
    for f in ("steps", "bulk_steps"):
        if int(getattr(got[6], f)) != int(getattr(want[6], f)):
            bad.append(f)
    return bad


def dedup_mismatches(got, want) -> list[str]:
    import torch

    return [name for name, a, b in zip(("n_uniq", "inv", "compact"), got, want) if not torch.equal(a, b)]


def phase_breakdown(world, dev) -> dict:
    """Host-clock seconds of each phase of one runs-path solve, re-run
    phase by phase with a device sync after each. The dispatch loop is the
    scheduler's (overflow -> grow -> go on from the overflowing pod); it
    needs a solve that finishes in one requeue round, as the headline does."""
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
        st, seq, nseq, got_k, got_s, over, _, ptr = KR.solve_runs(tb, st, rx, seq, nseq, len(batch))
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


def bound(nbytes_: int, ops: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the two least times."""
    tb_, to_ = nbytes_ / HBM_BYTES_PER_S, ops / CORE_OPS_PER_S
    return max(tb_, to_) * 1e3, "bytes" if tb_ >= to_ else "operations"


def main() -> int:
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

    # ---- 1. build ----
    t0 = time.monotonic()
    built = _build.build_all()
    log(f"build: {time.monotonic() - t0:.1f}s wall for {len(built)} libraries (parallel nvcc)")
    for name, info in built.items():
        log(f"  {name}: {info['seconds']:.1f}s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"    {line.strip()}")

    # ---- 2. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")

    its = build_universe(HEADLINE_TYPES)

    # ---- 3. K1 typeok_screen vs its plain version, headline tables ----
    sched, pods = scheduler_for(headline_world(HEADLINE_PODS, its), dev)
    from karpenter_tpu_torch.device import to_tensor
    from karpenter_tpu_torch.ops.encode import Reqs
    from karpenter_tpu_torch.solver.tpu_problem import _pow2, encode_problem

    t0 = time.monotonic()
    problem = encode_problem(sched.oracle, pods)
    log(f"headline encode: {time.monotonic() - t0:.2f}s (host)")
    tb = sched._tables(problem)
    IW = max(1, (problem.num_types + 31) // 32)
    rows = Reqs(*(to_tensor(a[sched._cr_padded(problem)], dev) for a in problem.preq_c))
    got = T.typeok_screen(tb.ireq, tb.va, rows, IW)
    want = T.typeok_plain(tb.ireq, tb.va, rows, IW)
    torch.cuda.synchronize()
    k1_mism = int((got != want).sum())
    log(
        f"K1 typeok_screen: [{rows.mask.shape[0]}, {IW}] words (TW={tb.va.full_mask.shape[0]}, "
        f"K={tb.va.num_keys}, I={tb.ialloc.shape[0]}): {k1_mism} mismatched words vs plain"
    )
    if k1_mism:
        return 1
    k1_ms = cuda_ms(lambda: T.typeok_screen(tb.ireq, tb.va, rows, IW), 200)
    k1_plain_ms = cuda_ms(lambda: T.typeok_plain(tb.ireq, tb.va, rows, IW), 20)
    B, I, TWn, Kn = rows.mask.shape[0], tb.ialloc.shape[0], tb.va.full_mask.shape[0], tb.va.num_keys
    k1_bound, k1_by = bound(nbytes(tb.ireq, rows, tb.va.word2key) + B * IW * 4, B * I * (TWn + 2 * Kn))

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
    log(
        f"K2 scan_step headline prefix (P={P_h}, N={st_h.active.shape[0]}): kernel {k2_ms:.3f} ms, "
        f"plain {k2_plain_ms:.1f} ms, mismatches={bad or 'none'}"
    )
    if bad:
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
    log(
        f"K3 run_step headline: dispatch 1 N={N1} stops at ptr={ptr1} (steps={int(got1[6].steps)}, "
        f"bulk_steps={int(got1[6].bulk_steps)}); dispatch 2 N={2 * N1} over {len(batch)} pods "
        f"(steps={int(got2[6].steps)}, bulk_steps={int(got2[6].bulk_steps)}, over={bool(got2[5])}); "
        f"kernel {k3_ms:.3f} ms, plain {k3_plain_ms:.1f} ms, mismatches={bad or 'none'}"
    )
    if bad:
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

    # ---- 6. K4 run_arrays vs its plain version, headline round ----
    cls_d = rr.sched._dev_tables["cls"]
    bulk_d, aff_d = rr.sched._runflags_dev
    _, idx_h = rr.sched._pod_xs_with_idx(rr.problem, rr.order)
    k4_args = (cls_d, bulk_d, aff_d, idx_h, n)
    k4_mism = sum(int(not torch.equal(a, b)) for a, b in zip(T.run_arrays(*k4_args), T.run_arrays_plain(*k4_args)))
    k4_ms = cuda_ms(lambda: T.run_arrays(*k4_args), 200)
    k4_plain_ms = cuda_ms(lambda: T.run_arrays_plain(*k4_args), 50)
    P_r = idx_h.shape[0]
    k4_bound, k4_by = bound(P_r * 4 + P_r * 4 + bulk_d.numel() + aff_d.numel() + P_r * (3 + 4), P_r * 8)
    log(f"K4 run_arrays headline round (P={P_r}): kernel {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms, mismatched arrays={k4_mism}")
    if k4_mism:
        return 1

    # ---- 7. K5 dedup_rows vs its plain version ----
    st_final = got2[0]
    n_cl = int(st_final.n_claims)
    n2 = min(_pow2(max(n_cl, 1), floor=64), st_final.active.shape[0])
    drows = T.decode_rows(st_final, n2)
    k5_got, k5_want = T.dedup_rows(drows), T.dedup_rows_plain(drows)
    torch.cuda.synchronize()
    k5_bad = dedup_mismatches(k5_got, k5_want)
    gen = torch.Generator(device="cpu").manual_seed(5)
    pool = torch.randint(-(1 << 31), (1 << 31) - 1, (512, drows.shape[1]), generator=gen, dtype=torch.int64)
    synth = pool[torch.randint(0, 512, (16384,), generator=gen)].to(torch.int32).to(dev)
    k5_big_got, k5_big_want = T.dedup_rows(synth), T.dedup_rows_plain(synth)
    torch.cuda.synchronize()
    k5_bad += [f"synthetic {b}" for b in dedup_mismatches(k5_big_got, k5_big_want)]
    k5_ms = cuda_ms(lambda: T.dedup_rows(drows), 50)
    k5_plain_ms = cuda_ms(lambda: T.dedup_rows_plain(drows), 10)
    k5_lib_ms = cuda_ms(lambda: torch.unique(drows, dim=0, return_inverse=True), 10)
    k5_big_ms = cuda_ms(lambda: T.dedup_rows(synth), 10)
    C_d = drows.shape[1]
    k5_bound, k5_by = bound(2 * n2 * C_d * 4 + n2 * 4 + 4, 4 * n2 * C_d)
    log(
        f"K5 dedup_rows headline final state (n2={n2}, C={C_d}, claims={n_cl}, uniques={int(k5_got[0])}): "
        f"kernel {k5_ms:.4f} ms, plain {k5_plain_ms:.4f} ms, torch.unique {k5_lib_ms:.4f} ms; "
        f"synthetic 16384 rows (uniques={int(k5_big_got[0])}): kernel {k5_big_ms:.4f} ms; mismatches={k5_bad or 'none'}"
    )
    if k5_bad:
        return 1

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

    # ---- 10. the kernels line ----
    def row(name, source, replaces, nlaunch, mism, ms, plain_ms, bound_ms, bound_by, library_ms=None):
        return {
            "name": name, "route": "cuda", "source": f"karpenter_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": nlaunch, "mismatches": mism, "max_abs_err": 0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        }

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
    ]
    log(f"chip_smoke: {time.monotonic() - t_start:.1f}s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _small_types():
    from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types

    return construct_instance_types(sizes=[2, 8, 32])


if __name__ == "__main__":
    sys.exit(main())
