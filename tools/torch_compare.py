#!/usr/bin/env python3
"""Two checkouts of the PyTorch/CUDA port, timed in turns on one card.

    python3 tools/torch_compare.py OTHER_CHECKOUT [--out build/torch_compare.json]

Runs one worker process per checkout (this repository and OTHER_CHECKOUT,
typically the parent commit unpacked with `git archive` into a directory
that .gitignore lists). Each worker builds its own checkout's kernels
(`_build.build_all`, both at once), builds the inputs with its own
checkout's code, then times the kernels when the main process asks, in turns:
other, this, this, other. Every time is device milliseconds from a
torch.profiler trace, summed per kernel name, per call:

- K2 `scan_step`: the headline's 2048-pod prefix, its whole round and the
  1000-pod preference round with the relax tier loop;
- K3 `run_step`: the headline's and the c6 mix's two dispatches;
- K7 `scan_lanes`: one lane (lane 0 of the 8-lane fleet window) beside K2
  on the same lane; the fleet windows' first rounds (lanes 0..1, 0..4,
  0..7 of that window, and a 4-lane window with preference ladders); the
  two full-state sweep launches (prefix and singleton lanes, 64
  candidates of a 2000-node fleet whose riders carry a zone spread);
- K6 `fast_sweep` (prefix, singleton) and K8 `set_sweep` (1024 removal
  sets) on the c4 and the leftover fleet, each launch split into its
  cache kernel and its lane kernel; K8 on the c4 fleet again with every
  launch table in device memory (`tpu_kernel.SMEM_CAP = 0`);
- K1 `typeok_screen` on the headline's class rows, the c6 mix's tier rows
  and the class rows of a 2048-type catalog (the rows each checkout's
  solve screens); K4 `run_arrays` on the
  headline's and the c6 mix's first round; K5 as the decode calls it,
  `dedup_decode_state` on the headline's final claim state, summed over
  every device kernel the call launches (a checkout that packs the claim
  columns or zeroes the output first pays for those kernels too), with
  the count of device kernels a call. For these three the worker also times the
  wrapper's host side: the wall time of 200 calls with no sync, divided
  by 200, the least of five such runs (`host`). Where the checkout has
  the empty kernel (`csrc/empty.cu`), the worker times it the same two
  ways (`floor`): the least any launch costs.

`--kernels K1,K4,K5` builds and times only those kernels' calls.

Where a checkout's K7 takes a `prof` buffer, its worker also prints K7's
per-phase clock breakdown at one lane beside K2's on the same lane. Each
worker prints its kernels' ptxas lines. The main process prints each time per
turn and the ratio of this checkout's mean to the other's, and writes
everything to --out. The inputs are chip_smoke.py's (the same module of
each checkout), so both sides time the same problems.

Without a CUDA device it exits 2. `--worker --device cpu --small` runs one
worker's input build and one turn on the CPU (host timers, no device
times) as a rehearsal.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the worker: one checkout's kernels and inputs


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


def device_split(fn, reps: int, names: tuple, dev, host: bool = False) -> dict:
    """Per-call device ms of each kernel whose name contains one of
    `names`, from a torch.profiler trace of `reps` calls after one
    warm-up, and with `host` the wrapper's host ms a call (`host_ms`).
    With no `names`, every device event of the trace by its own name,
    their sum ("all device kernels") and their count a call ("kernels a
    call"). On the CPU: {"host_ms": ...} instead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    if dev.type != "cuda":
        t0 = time.monotonic()
        for _ in range(reps):
            fn()
        return {"host_ms": (time.monotonic() - t0) * 1e3 / reps}
    out = {"host": host_ms(fn, reps)} if host else {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if not names and e.device_type == DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3 / reps
            out["all device kernels"] = out.get("all device kernels", 0.0) + us / 1e3 / reps
            out["kernels a call"] = out.get("kernels a call", 0.0) + e.count / reps
        for n in names:
            if n in e.key and us:
                out[n] = out.get(n, 0.0) + us / 1e3 / reps
    return out


def device_tables(fn):
    """fn() with the launch tables' shared-memory cap at 0."""
    from karpenter_tpu_torch.solver import tpu_kernel as K

    K.SMEM_CAP = 0
    try:
        return fn()
    finally:
        K.SMEM_CAP = None


KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")


def headline_dispatches(rr, dev) -> tuple[list, object]:
    """The argument tuples of a runs round's K3 dispatches (the first, and
    the rest after a claim-slot regrow), and the final state."""
    import torch

    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver import tpu_runs as KR

    n = len(rr.order)
    nseq0 = torch.zeros((), dtype=torch.int32, device=dev)
    first = (rr.tb, rr.st, rr.rx, rr.seq, nseq0, n, rr.relax)
    got = KR.solve_runs(*first)
    launches = [first]
    over, ptr1, _, _ = K.counter_fields(got[5].tolist())
    if over:  # the claim slots overflowed: the rest after the regrow
        st2, seq2 = rr.sched._grow(rr.problem, got[0], got[1], rr.st.active.shape[0])
        batch = rr.order[ptr1:]
        xs2, idx2 = rr.sched._pod_xs_with_idx(rr.problem, batch)
        launches.append((rr.tb, st2, rr.sched._run_x(xs2, idx2, len(batch)), seq2, got[2], len(batch), rr.relax))
        got = KR.solve_runs(*launches[-1])
    return launches, got[0]


def small_kernel_items(dev, small: bool, groups: set) -> list:
    """K1, K4 and K5 at the main path's shapes, and the empty kernel where
    the checkout has it; each item also times the wrapper's host side."""
    import chip_smoke as CS
    from karpenter_tpu_torch.device import to_tensor
    from karpenter_tpu_torch.ops.encode import Reqs
    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver.tpu_problem import _pow2, encode_problem

    n_types, pods, big_types, big_pods = (40, 50, 96, 30) if small else (
        CS.HEADLINE_TYPES, CS.HEADLINE_PODS, CS.LARGE_CATALOG_TYPES, CS.LARGE_CATALOG_PODS)
    its = CS.build_universe(n_types)
    items = []
    t0 = time.monotonic()
    if "K1" in groups:
        for label, world, tier in (
            ("K1 headline class rows", CS.headline_world(pods, its), False),
            ("K1 c6 tier rows", CS.c6_world(pods, its), True),
            (f"K1 {big_types}-type catalog class rows", CS.headline_world(big_pods, CS.build_universe(big_types)), False),
        ):
            sched, wpods = CS.scheduler_for(world, dev)
            problem = encode_problem(sched.oracle, wpods)
            tb = sched._tables(problem)
            IW = max(1, (problem.num_types + 31) // 32)
            # the rows the checkout's solve screens: its distinct class rows
            # where it has `_class_rows`, else the bucket-padded ones
            if tier:
                rows = sched._tier_rows(problem)
            elif hasattr(sched, "_class_rows"):
                rows = sched._class_rows(problem)
            else:
                rows = Reqs(*(to_tensor(a[sched._cr_padded(problem)], dev) for a in problem.preq_c))
            log(f"{label}: [{rows.mask.shape[0]}, {IW}] words")  # the two checkouts' row counts may differ
            items.append((label, lambda tb=tb, rows=rows, IW=IW: T.typeok_screen(tb.ireq, tb.va, rows, IW),
                          200, ("typeok_kernel",), True))
    if groups & {"K4", "K5"}:
        for label, world in (("headline", CS.headline_world(pods, its)), ("c6", CS.c6_world(pods, its))):
            rr = CS.runs_round(world, dev)
            if "K4" in groups:
                _, idx = rr.sched._pod_xs_with_idx(rr.problem, rr.order)
                args = (rr.sched._dev_tables["cls"], *rr.sched._runflags_dev, idx, len(rr.order))
                items.append((f"K4 {label} round [P={idx.shape[0]}]", lambda a=args: T.run_arrays(*a), 200,
                              ("run_arrays_kernel",), True))
            if "K5" in groups and label == "headline":
                _, st_final = headline_dispatches(rr, dev)
                n2 = min(_pow2(max(int(st_final.n_claims), 1), floor=64), st_final.active.shape[0])
                items.append((f"K5 dedup_decode_state, headline final state [n2={n2}]",
                               lambda s=st_final, n2=n2: T.dedup_decode_state(s, n2), 200, (), True))
    if hasattr(T, "empty_launch") and dev.type == "cuda":
        items.append(("floor (empty kernel)", lambda: T.empty_launch(dev), 200, ("empty_kernel",), True))
    log(f"K1/K4/K5 inputs: {time.monotonic() - t0:.1f}s")
    return items


def step_items(items: list, dev, small: bool, its, pods: int, prefix: int, pref_pods: int) -> None:
    """K2 and K3 on the headline, c6 and the preference round."""
    import chip_smoke as CS
    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver import tpu_runs as KR

    t0 = time.monotonic()
    a = CS.step_inputs(CS.headline_world(pods, its), dev, prefix=prefix)
    items.append(("K2 headline prefix", lambda a=a: K.solve_scan(*a), 3, ("scan_step_kernel",), False))
    a = CS.step_inputs(CS.headline_world(pods, its), dev)
    items.append(("K2 headline round", lambda a=a: K.solve_scan(*a), 1, ("scan_step_kernel",), False))
    a = CS.step_inputs(CS.preference_world(pref_pods, its), dev)
    items.append(("K2 relax round", lambda a=a: K.solve_scan(*a, relax=True), 3, ("scan_step_kernel",), False))
    worlds = [("K3 headline", CS.headline_world(pods, its))] + ([] if small else [("K3 c6", CS.c6_world(pods, its))])
    for label, world in worlds:
        launches, _ = headline_dispatches(CS.runs_round(world, dev), dev)
        items.append((label, lambda ls=launches: [KR.solve_runs(*x) for x in ls], 2, ("run_step_kernel",), False))
    log(f"step inputs: {time.monotonic() - t0:.1f}s")


def fleet_items(items: list, dev, its, fleet_pods: int) -> dict:
    """K7: the fleet windows' first rounds, one lane beside K2; returns
    the one-lane breakdown launches where the checkout's K7 takes `prof`."""
    import chip_smoke as CS
    from karpenter_tpu_torch.solver import tpu_kernel as K

    t0 = time.monotonic()
    tb, st_b, xs_b, relax = CS.fleet_inputs([CS.fleet_world(its, f"{k + 1}00m", fleet_pods) for k in range(8)], dev)

    def lanes(b):
        return tuple(K.stack_lanes([K.lane_slice(t, k) for k in range(b)]) for t in (st_b, xs_b))

    st1, xs1 = lanes(1)
    st0, xs0 = K.lane_slice(st_b, 0), K.lane_slice(xs_b, 0)
    items.append(("K7 one lane", lambda: K.solve_scan_lanes(tb, st1, xs1, relax), 3, ("scan_lanes_kernel",), False))
    items.append(("K2 same lane", lambda: K.solve_scan(tb, st0, xs0, relax), 3, ("scan_step_kernel",), False))
    for b in (2, 5, 8):
        sb, xb = lanes(b)
        items.append((f"K7 window {b}", lambda s=sb, x=xb: K.solve_scan_lanes(tb, s, x, relax), 2,
                      ("scan_lanes_kernel",), False))
    r = CS.fleet_inputs([CS.fleet_world(its, f"{k + 1}00m", fleet_pods, CS.FLEET_PREF_PODS) for k in range(4)], dev)
    items.append(("K7 window 4+relax", lambda r=r: K.solve_scan_lanes(*r), 2, ("scan_lanes_kernel",), False))
    log(f"fleet inputs: {time.monotonic() - t0:.1f}s")
    if "prof" not in inspect.signature(K.solve_scan_lanes).parameters:
        return {}
    return {
        "K7 one lane": ("scan_lanes", lambda p: K.solve_scan_lanes(tb, st1, xs1, relax, prof=p)),
        "K2 same lane": ("scan_step", lambda p: K.solve_scan(tb, st0, xs0, relax, prof=p)),
    }


def build_items(dev, small: bool, groups: set) -> tuple[list, dict]:
    """[(key, fn, reps, kernel names, host)] of the timed calls of the
    kernels in `groups` ("K1".."K8"), and the one-lane breakdown launches
    where the checkout's K7 takes `prof`."""
    import numpy as np

    import chip_smoke as CS
    from karpenter_tpu_torch.controllers.disruption import setsweep as SS
    from karpenter_tpu_torch.controllers.disruption import sweep as S
    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.testing.fixtures import underutilized_world

    n_types, pods, prefix, fleet_pods, pref_pods = (40, 50, 32, 40, 40) if small else (
        CS.HEADLINE_TYPES, CS.HEADLINE_PODS, CS.K2_PREFIX, CS.FLEET_PODS, CS.PREF_PODS)
    nodes, cands_n, lane_cands, set_lanes = (40, 10, 6, 32) if small else (
        CS.SWEEP_NODES, CS.SWEEP_CANDIDATES, CS.LANE_CANDIDATES, CS.SET_LANES)
    its = CS.build_universe(n_types)
    items = small_kernel_items(dev, small, groups) if groups & {"K1", "K4", "K5"} else []
    breakdown = {}
    if groups & {"K2", "K3"}:
        step_items(items, dev, small, its, pods, prefix, pref_pods)
    if "K7" in groups:
        breakdown = fleet_items(items, dev, its, fleet_pods)
        t0 = time.monotonic()
        w = underutilized_world(nodes, seed=7, rider_spread=CS.RIDER_SPREAD)
        cands = CS.sweep_candidates(w, lane_cands)
        u = S.build_union(w.kube, w.cluster, w.cloud, cands, device=dev)
        for singleton in (False, True):  # the full-state sweep's two launches
            st_l, xs_l, valid_b, _, rel = S.lane_scan_args(w.cluster, cands, u, singleton)
            items.append((f"K7 sweep {'singleton' if singleton else 'prefix'}",
                          lambda a=(u.tb, st_l, xs_l, valid_b, rel): K.scan_lanes(*a), 5, ("scan_lanes_kernel",), False))
        log(f"lane sweep fleet: {time.monotonic() - t0:.1f}s")
    if not groups & {"K6", "K8"}:
        return items, breakdown

    # K6 and K8 on the c4 and the leftover fleet
    split = ("sweep_cache_kernel", "fast_sweep_lanes", "set_sweep_lanes")
    for tag, kw in (("c4", {}), ("leftover", dict(rider_requests=CS.LEFTOVER_RIDER, pending_requests=CS.LEFTOVER_PENDING))):
        t0 = time.monotonic()
        w = underutilized_world(nodes, seed=7, n_pending=CS.SWEEP_PENDING, **kw)
        cands = CS.sweep_candidates(w, cands_n)
        u = S.build_union(w.kube, w.cluster, w.cloud, cands, device=dev)
        for singleton in (False, True):
            args = S.fast_sweep_args(u.sched, u.problem, cands, u.view_slot, u.order, u.pod_prefix, singleton)
            items.append((f"K6 {'singleton' if singleton else 'prefix'} {tag}",
                          lambda u=u, a=args, s=singleton: S.fast_sweep(u.tb, u.base, *a, singleton=s), 20, split,
                          False))
        ctx = SS.SetSweepContext.build(w.kube, w.cluster, w.cloud, cands, device=dev)
        proposer = SS.SetProposer(cands, seed=7, max_lanes=set_lanes)
        member = proposer.first_round()
        if len(member) < set_lanes:
            member = np.concatenate([member, proposer._dedup(proposer._random(4 * set_lanes))], axis=0)[:set_lanes]
        member = member[np.argsort(member.sum(axis=1), kind="stable")]
        args = ctx.kernel_args(member)
        items.append((f"K8 {tag}", lambda a=args: SS.set_sweep(*a), 20, split, False))
        if tag == "c4":  # every table (and, where the checkout has it, the lanes' availability) in device memory
            items.append(("K8 c4, device tables", lambda a=args: device_tables(lambda: SS.set_sweep(*a)), 20, split,
                          False))
        log(f"{tag} fleet: {time.monotonic() - t0:.1f}s")
    return items, breakdown


def worker(device: str, small: bool, groups: set) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        log("torch_compare: no CUDA device")
        return 2
    from karpenter_tpu_torch.solver import tpu_kernel as K

    ptxas = {}
    if dev.type == "cuda":
        import chip_smoke as CS
        from karpenter_tpu_torch import _build

        t0 = time.monotonic()
        for name, info in _build.build_all().items():
            ptxas[name] = CS.ptxas_lines(info["log"])
        log(f"{os.getcwd()}: build {time.monotonic() - t0:.1f}s")
    items, breakdown = build_items(dev, small, groups)
    print(json.dumps({"ready": True, "ptxas": ptxas}), flush=True)
    first = True
    for line in sys.stdin:
        if line.strip() != "measure":
            break
        out = {key: device_split(fn, reps, names, dev, host) for key, fn, reps, names, host in items}
        if first and breakdown and dev.type == "cuda":
            out["breakdown"] = {}
            for key, (kernel, launch) in breakdown.items():
                prof = K.prof_buffer(kernel, dev)
                launch(prof)
                torch.cuda.synchronize()
                out["breakdown"][key] = K.breakdown(kernel, prof)
        first = False
        print(json.dumps(out), flush=True)
        if small:
            break
    return 0


# ---------------------------------------------------------------------------
# the main process: two workers, timed in turns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the other checkout's root")
    ap.add_argument("--out", default="build/torch_compare.json")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--kernels", default=",".join(KERNELS), help="the kernels to time, e.g. K1,K4,K5")
    args = ap.parse_args()
    groups = set(args.kernels.split(","))
    if groups - set(KERNELS):
        ap.error(f"--kernels: unknown {sorted(groups - set(KERNELS))}")
    if args.worker:
        return worker(args.device, args.small, groups)
    import torch

    if not torch.cuda.is_available():
        log("torch_compare: torch.cuda.is_available() is False; this needs the card")
        return 2
    roots = {"other": Path(args.other).resolve(), "this": HERE}
    procs = {}
    for side, root in roots.items():
        env = dict(os.environ, PYTHONPATH=str(root))
        procs[side] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker", "--device", args.device,
             "--kernels", args.kernels],
            cwd=root, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        )
    ready = {side: json.loads(p.stdout.readline() or "{}") for side, p in procs.items()}
    if not all(r.get("ready") for r in ready.values()):
        log(f"torch_compare: a worker failed to start: {ready}")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    turns = []
    for side in ("other", "this", "this", "other"):
        p = procs[side]
        p.stdin.write("measure\n")
        p.stdin.flush()
        line = p.stdout.readline()
        if not line:
            log(f"torch_compare: the {side} worker died")
            return 1
        turns.append((side, json.loads(line)))
    for p in procs.values():
        p.stdin.close()
        p.wait(timeout=60)
    keys = list(dict.fromkeys(k for _, res in turns for k in res if k != "breakdown"))
    table = {}
    for k in keys:
        row = {}
        for side, res in turns:
            for name, ms in res.get(k, {}).items():
                row.setdefault(name, {}).setdefault(side, []).append(ms)
        table[k] = row
    print(f"card: {smi}")
    for k, row in table.items():
        for name, by in row.items():
            o, t = by.get("other", []), by.get("this", [])
            ratio = (sum(t) / len(t)) / (sum(o) / len(o)) if o and t and sum(o) else None
            print(f"{k} [{name}]: other {[round(x, 4) for x in o]}, this {[round(x, 4) for x in t]}, "
                  f"ratio {ratio if ratio is None else round(ratio, 4)}")
    for side, res in turns:
        if "breakdown" in res:
            print(f"breakdown ({side}): {json.dumps(res['breakdown'])}")
    for side, r in ready.items():
        for name, lines in r["ptxas"].items():
            for line in lines:
                print(f"ptxas ({side}) {name}: {line}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": smi, "turns": turns, "table": table, "ptxas": {
        s: r["ptxas"] for s, r in ready.items()}}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
