#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (karpenter_tpu_torch).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/, holds each kernel against its plain
PyTorch version on the card, drives the provisioning solve end to end at
the headline size (make_diverse_pods(10000) against 500 KWOK instance types
on one default NodePool), checks its decisions against the port's oracle at
about 1000 pods, and prints:

- the card's name and power limit (nvidia-smi),
- one JSON line {"kernels": [...]} with each kernel's launches on the main
  path, its agreement with the plain version, and its times,
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


def oracle_parity(world: World, dev) -> tuple[bool, int]:
    """Solve a world with TorchScheduler on `dev` and a deep copy of it
    with the port's oracle; (equal snapshots, the oracle's claim count)."""
    from karpenter_tpu_torch.solver.oracle import Scheduler

    twin = copy.deepcopy(world)
    sched, pods = scheduler_for(world, dev)
    got = results_snapshot(sched.solve(pods), pods)
    oracle = Scheduler(twin.pools, twin.ibp, twin.topo, twin.views, None, twin.options)
    want = results_snapshot(oracle.solve(twin.pods), twin.pods)
    return got == want, len(want[0])


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


def phase_breakdown(world, dev) -> dict:
    """Host-clock seconds of each phase of one solve, re-run phase by
    phase with a device sync after each (valid for a solve that finishes
    in one requeue round, as the headline does)."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver.tpu_problem import _pow2, encode_problem

    sched, pods = scheduler_for(world, dev)
    out = {}
    t0 = time.monotonic()

    def mark(name):
        nonlocal t0
        torch.cuda.synchronize()
        now = time.monotonic()
        out[name] = now - t0
        t0 = now

    problem = encode_problem(sched.oracle, pods)
    mark("encode")
    order = sched._order_pods(problem)
    mark("order")
    tb = sched._tables(problem)
    sched._upload_pod_tables(problem)
    mark("tables_typeok_upload")
    N = min(_pow2(max(64, (len(pods) + 3) // 4)), _pow2(len(pods)))
    st = sched._init_state(problem, N)
    xs = sched._pod_xs(problem, order)
    mark("state_pod_xs")
    st, kinds, slots, over, _ = K.solve_scan(tb, st, xs)
    kinds_h = np.full(len(pods), K.KIND_FAIL, np.int32)
    slots_h = np.full(len(pods), -1, np.int32)
    kinds_h[order] = kinds.cpu().numpy()[: len(pods)]
    slots_h[order] = slots.cpu().numpy()[: len(pods)]
    mark("scan_step_fetch")
    if bool(over) or (kinds_h == K.KIND_FAIL).any():
        raise RuntimeError("phase breakdown needs a one-round solve")
    sched._decode(problem, st, kinds_h, slots_h, False)
    mark("decode")
    return out


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
    except ImportError as e:
        print(f"chip_smoke: the karpenter_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if any(m == "jax" or m.startswith(("jax.", "karpenter_tpu.")) for m in sys.modules):
        print("chip_smoke: the port pulled in jax or the reference package", file=sys.stderr)
        return 1

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
    from karpenter_tpu_torch.solver.tpu_problem import encode_problem

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
    k1_bytes = nbytes(tb.ireq, rows, tb.va.word2key) + B * IW * 4
    k1_ops = B * I * (TWn + 2 * Kn)
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / CORE_OPS_PER_S) * 1e3
    k1_by = "bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops / CORE_OPS_PER_S else "operations"

    # ---- 4. K2 scan_step vs its plain version, on the card ----
    k2_mism = 0
    for label, world, in_order in (
        ("diverse-16", headline_world(16, _small_types()), True),
        ("mixed", mixed_world(), False),
        ("reserved", reserved_world(), False),
    ):
        tb_s, st_s, xs_s = step_inputs(world, dev, in_order=in_order)
        st_k, kinds_k, slots_k, over_k, steps_k = K.solve_scan(tb_s, st_s, xs_s)
        st_p, kinds_p, slots_p, over_p, steps_p = K.solve_scan_plain(tb_s, st_s, xs_s)
        torch.cuda.synchronize()
        bad = state_mismatches(st_k, st_p)
        if not torch.equal(kinds_k, kinds_p):
            bad.append("kinds")
        if not torch.equal(slots_k, slots_p):
            bad.append("slots")
        if bool(over_k) != bool(over_p) or steps_k != steps_p:
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

    # K2 at the main path's shapes: the headline's whole first round
    tb_h, st_h, xs_h = step_inputs(headline_world(HEADLINE_PODS, its), dev)
    P_h = xs_h.valid.shape[0]
    k2_ms = cuda_ms(lambda: K.solve_scan(tb_h, st_h, xs_h), 2)
    st_k, kinds_k, slots_k, over_k, steps_k = K.solve_scan(tb_h, st_h, xs_h)
    t0 = time.monotonic()
    st_p, kinds_p, slots_p, over_p, steps_p = K.solve_scan_plain(tb_h, st_h, xs_h)
    torch.cuda.synchronize()
    k2_plain_ms = (time.monotonic() - t0) * 1e3
    bad = state_mismatches(st_k, st_p)
    if not (torch.equal(kinds_k, kinds_p) and torch.equal(slots_k, slots_p)):
        bad.append("kinds/slots")
    if bool(over_k) != bool(over_p) or steps_k != steps_p:
        bad.append("overflow/steps")
    log(
        f"K2 scan_step headline round 1 (P={P_h}, N={st_h.active.shape[0]}): kernel {k2_ms:.3f} ms, "
        f"plain {k2_plain_ms:.1f} ms, mismatches={bad or 'none'}"
    )
    if bad:
        return 1
    # the least time for the same work: every input read once, the state
    # and the outputs written once, and the (pod, live claim) pairs the
    # screens must visit
    is_new = (kinds_k == K.KIND_NEW).to(torch.int64)
    k2_pairs = int((torch.cumsum(is_new, 0) - is_new)[xs_h.valid].sum())
    TWh, Kh = tb_h.va.full_mask.shape[0], tb_h.va.num_keys
    k2_bytes = nbytes(tb_h, st_h, xs_h) + nbytes(st_h) + 2 * 4 * P_h
    k2_ops = k2_pairs * (2 * TWh + 3 * Kh)
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / CORE_OPS_PER_S) * 1e3
    k2_by = "bytes" if k2_bytes / HBM_BYTES_PER_S >= k2_ops / CORE_OPS_PER_S else "operations"

    # ---- 5. the main path at full width ----
    def fresh():
        return scheduler_for(headline_world(HEADLINE_PODS, its), dev)

    sched, pods = fresh()
    t0 = time.monotonic()
    sched.solve(pods)
    torch.cuda.synchronize()
    log(f"warm-up headline solve: {time.monotonic() - t0:.2f}s")
    sched, pods = fresh()
    T.LAUNCHES["typeok_screen"] = 0
    K.LAUNCHES["scan_step"] = 0
    t0 = time.monotonic()
    res = sched.solve(pods)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = {"typeok_screen": T.LAUNCHES["typeok_screen"], "scan_step": K.LAUNCHES["scan_step"]}
    odo = sched.last_odometer
    placed = sum(len(c.pods) for c in res.new_node_claims)
    log(
        f"headline solve on {torch.cuda.get_device_name(0)}: {len(pods)} pods x {len(its)} types in "
        f"{dt:.3f}s = {len(pods) / dt:.1f} pods/s; claims={len(res.new_node_claims)} placed={placed} "
        f"errors={len(res.pod_errors)} steps={odo['steps']} dispatches={odo['dispatches']} "
        f"overflow_signals={odo['overflow_signals']} launches={launches}"
    )
    if min(launches.values()) < 1 or placed + len(res.pod_errors) != len(pods):
        return 1
    if len(res.new_node_claims) == 0:
        return 1
    # two more timed solves for the spread (launch counts are read above)
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

    # decision parity with the port's oracle, solved on the card: the
    # headline mix at about 1000 pods, then the small worlds (several
    # requeue rounds, existing nodes, host ports, limits, reservations)
    for label, make in (
        (f"headline-{PARITY_PODS}", lambda: headline_world(PARITY_PODS, its)),
        ("mixed", mixed_world),
        ("reserved", reserved_world),
    ):
        same, n_claims = oracle_parity(make(), dev)
        log(f"oracle parity, {label}: {'equal' if same else 'DIFFERENT'} ({n_claims} claims)")
        if not same:
            return 1

    # ---- 6. the kernels line ----
    kernels = [
        {
            "name": "typeok_screen", "route": "cuda", "source": "karpenter_tpu_torch/csrc/typeok.cu",
            "replaces": "karpenter_tpu/solver/tpu.py:61", "launches": launches["typeok_screen"],
            "mismatches": k1_mism, "max_abs_err": 0, "ms": k1_ms, "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
        },
        {
            "name": "scan_step", "route": "cuda", "source": "karpenter_tpu_torch/csrc/scan_step.cu",
            "replaces": "karpenter_tpu/solver/tpu_kernel.py:560", "launches": launches["scan_step"],
            "mismatches": k2_mism, "max_abs_err": 0, "ms": k2_ms, "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
        },
    ]
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
