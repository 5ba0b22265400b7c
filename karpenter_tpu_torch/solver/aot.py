"""The prewarm: every kernel built and launched once over the bucket ladder.

The port's counterpart of the JAX package's `solver/aot.py`. There, the
shape buckets (solver/buckets.py) make the set of compiled programs a
finite ladder, and the prewarm compiles each (entry x rung x relax) combo
into the persistent compilation cache without running it. On the card a
kernel is compiled once per source, not per shape, so the prewarm does
two things instead:

1. It builds every library for the sources' hash (`_build.build_all`),
   which is skipped where the hash directory already holds it. That
   directory (`build/karpenter_tpu_torch/<hash>/`) is the persistent
   cache: a new hash is a new record, as a wiped cache is in the
   reference, and a process that finds it filled invokes no nvcc.
2. In every process, it launches each kernel once per (entry x rung x
   relax) combo on the representative problems: K1 (the type screen), K4
   and K3 (the runs path), K2 (the scan path), each without and with the
   relax tier loop, K5 (the dedup decode), K6 and K8 at the contract
   shapes and, with a fleet, K7 at each lane bucket. So a first solve pays
   for neither nvcc nor a kernel's first launch (the module load, any
   `cudaFuncSetAttribute`, the caching allocator's first blocks).

With `device="cpu"` the prewarm runs the plain versions over the same
ladder and builds nothing.

The manifest (`aot_manifest.json`, in the hash directory) records each
combo: its bucket signature, the build seconds of its kernels' libraries
(0 when reused), its first-launch milliseconds, the bytes its tensors
hold, and each kernel's registers and static shared memory from the
ptxas log. It is written atomically after each combo, so a kill at any
instant leaves a manifest the next process reads. A combo already
launched in this process whose recorded signature matches is skipped.
`/debug/programs` (controllers/probes.py) serves it.

Three consumers: `SolverServer(prewarm=True)` runs `prewarm()` on a
background thread before it reports ready (solves that arrive meanwhile
degrade to the oracle); the Operator builds the libraries at
construction; chip_smoke.py measures a first solve with and without it.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from karpenter_tpu_torch import _build
from karpenter_tpu_torch import logging as klog
from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.device import resolve_device, to_tensor
from karpenter_tpu_torch.solver import buckets

MANIFEST_NAME = "aot_manifest.json"
MANIFEST_VERSION = 1

log = klog.root.named("solver.aot")

PREWARM_PROGRAMS = metrics.REGISTRY.counter(
    "karpenter_solver_prewarm_programs_total",
    "prewarmed (entry x rung x relax) combos per entry point (solver/aot.py prewarm)",
    ("entry",),
)
PREWARM_READY = metrics.REGISTRY.gauge(
    "karpenter_solver_prewarm_ready",
    "1 once the prewarm ladder has fully run (0 while it runs)",
)
PREWARM_SECONDS = metrics.REGISTRY.histogram(
    "karpenter_solver_prewarm_duration_seconds",
    "wall-clock seconds of one full prewarm ladder",
)

# the libraries each entry launches
_SOURCES = {
    "typeok_screen": ("typeok",),
    "solve_runs": ("run_arrays", "run_step"),
    "solve_scan": ("scan_step",),
    "dedup_rows": ("dedup_rows",),
    "fleet_solve_scan": ("scan_lanes",),
    "fast_sweep": ("fast_sweep",),
    "set_sweep": ("set_sweep",),
}

# (device key, combo name) launched in this process: a later prewarm of
# the same combo has nothing left to warm
_WARM: set = set()
_WARM_LOCK = threading.Lock()


def manifest_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, MANIFEST_NAME)


def default_cache_dir() -> str:
    """The build's hash directory, where the manifest lives."""
    return str(_build.build_dir())


def program_catalog(cache_dir: Optional[str] = None) -> dict:
    """The prewarm catalog `/debug/programs` serves: every prewarmed combo
    with its signature, build seconds, first-launch milliseconds, bytes
    and kernel resources. Reads the manifest only; never builds or
    launches."""
    if cache_dir is None:
        cache_dir = default_cache_dir()
    manifest = load_manifest(cache_dir)
    return {
        "cache_dir": cache_dir,
        "torch": manifest.get("torch"),
        "device": manifest.get("device"),
        "programs": manifest.get("combos", {}),
    }


def load_manifest(cache_dir: Optional[str]) -> dict:
    """The ladder manifest, or an empty shell when absent, corrupt or of
    another version (a half-written manifest from a killed prewarm must
    read as 'nothing recorded', never poison the next process)."""
    shell = {"version": MANIFEST_VERSION, "combos": {}}
    if not cache_dir:
        return shell
    try:
        with open(manifest_path(cache_dir), encoding="utf-8") as f:
            data = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, UnicodeDecodeError, OSError):
        return shell
    if not isinstance(data, dict) or data.get("version") != MANIFEST_VERSION:
        return shell
    if not isinstance(data.get("combos"), dict):
        data["combos"] = {}
    return data


def _write_manifest(cache_dir: str, data: dict) -> None:
    """Atomic write (temp + rename in the same directory): a kill at any
    instant leaves either the old manifest or the new one, never a torn
    file."""
    fd, tmp = tempfile.mkstemp(prefix=".aot_manifest.", dir=cache_dir, text=True)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, sort_keys=True)
        os.replace(tmp, manifest_path(cache_dir))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def _representative(kind: str, device="cpu", n_existing: int = 3, n_pods: int = 6, table_cache=None):
    """(sched, problem, order) for one representative family: a generic
    zero-preference mix of `n_pods` (the plain step) or a mixed relaxable
    batch, half of it preference pods (the tier loop), beside
    `n_existing` existing nodes. The same construction as the JAX
    package's prewarm, so the buckets agree. The tables are not built yet
    (that is K1's launch); `table_cache` goes to the scheduler."""
    from karpenter_tpu_torch.api import labels as well_known
    from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
    from karpenter_tpu_torch.solver.nodes import StateNodeView
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.solver.tpu import TorchScheduler
    from karpenter_tpu_torch.solver.tpu_problem import encode_problem
    from karpenter_tpu_torch.testing import fixtures

    fixtures.reset_rng(7)
    its = construct_instance_types(sizes=[2])
    pool = fixtures.node_pool(name="default")
    if kind == "generic":
        pods = fixtures.make_generic_pods(n_pods)
    else:
        pods = fixtures.make_generic_pods(n_pods // 2) + fixtures.make_preference_pods(n_pods - n_pods // 2)
    views = None
    if n_existing:
        it = its[0]
        views = [
            StateNodeView(
                name=f"aot-existing-{i}",
                node_labels={well_known.TOPOLOGY_ZONE_LABEL_KEY: "test-zone-a"},
                labels={
                    well_known.TOPOLOGY_ZONE_LABEL_KEY: "test-zone-a",
                    well_known.INSTANCE_TYPE_LABEL_KEY: it.name,
                    well_known.NODEPOOL_LABEL_KEY: "default",
                },
                available=dict(it.allocatable()),
                capacity=dict(it.capacity),
                initialized=True,
            )
            for i in range(n_existing)
        ]
    topo = Topology([pool], {"default": its}, pods, state_node_views=views)
    sched = TorchScheduler([pool], {"default": its}, topo, views, device=device, table_cache=table_cache)
    problem = encode_problem(sched.oracle, pods)
    order = sched._order_pods(problem)
    return sched, problem, order


def claim_rungs(P: int, claim_slot_div: int = 16) -> tuple[int, int]:
    """(N_runs, N_scan) — the claim-slot buckets TorchScheduler.solve pairs
    with a pod rung of P (keep in lockstep with solve()'s N formula)."""
    runs = min(
        buckets.bucket(max(64, (P + claim_slot_div - 1) // claim_slot_div)),
        buckets.bucket(P),
    )
    scan_div = min(claim_slot_div, 4)
    scan = min(
        buckets.bucket(max(64, (P + scan_div - 1) // scan_div)),
        buckets.bucket(P),
    )
    return runs, scan


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prewarm(
    max_pods: int = 1024,
    min_pods: int = 64,
    include_sweeps: bool = True,
    include_fleet: bool = False,
    fleet_lane_buckets: tuple[int, ...] = (2, 8),
    stop: Optional[threading.Event] = None,
    progress: Optional[Callable[[str, float], None]] = None,
    device=None,
    cache_dir: Optional[str] = None,
) -> dict:
    """Build the libraries (on the card) and launch every kernel once over
    the ladder; returns {"built", "build_seconds", "launched", "skipped",
    "seconds", "completed", "cache_dir", "combos"}.

    `device` None is the card; "cpu" runs the plain versions and builds
    nothing. `cache_dir` (default: the build's hash directory) holds the
    manifest. Interruption-safe: `stop` is polled between combos and every
    manifest write is atomic, so a kill at any point loses at most the
    in-flight combo.
    """
    from karpenter_tpu_torch.solver import fleet as fleet_mod
    from karpenter_tpu_torch.solver import tpu as T
    from karpenter_tpu_torch.solver import tpu_kernel as K
    from karpenter_tpu_torch.solver import tpu_runs as KR

    dev = resolve_device(device)
    t0 = time.monotonic()
    PREWARM_READY.set(0.0)
    built: dict = {}
    if dev.type == "cuda":
        built = _build.build_all()
        for name in _build.SOURCES:
            _build.library(name)
    if cache_dir is None:
        cache_dir = default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    manifest = load_manifest(cache_dir)
    dev_name = _device_name(dev)
    # records are comparable only from the same torch on the same device
    same = manifest.get("torch") == torch.__version__ and manifest.get("device") == dev_name
    reusable = frozenset(manifest["combos"]) if same else frozenset()
    manifest["torch"] = torch.__version__
    manifest["device"] = dev_name
    manifest["build_hash"] = _build.build_dir().name
    combos: dict = manifest["combos"]
    resources = {name: _build.ptxas_resources(b.get("log", "")) for name, b in built.items()}
    launched = skipped = 0
    dev_key = str(dev)

    def check_stop() -> None:
        if stop is not None and stop.is_set():
            raise InterruptedError("prewarm stopped")

    def run_combo(name: str, sig, fn: Callable[[], object]):
        """Launch one combo unless this process already did with the
        recorded signature; returns fn's result (None when skipped)."""
        nonlocal launched, skipped
        check_stop()
        sig_list = [list(x) for x in sig]
        with _WARM_LOCK:
            warm = (dev_key, name) in _WARM
        if warm and name in reusable and combos[name].get("signature") == sig_list:
            skipped += 1
            return None
        entry = name.split("[", 1)[0].split("@", 1)[0]
        _sync(dev)
        t = time.monotonic()
        out, nbytes = fn()
        _sync(dev)
        ms = (time.monotonic() - t) * 1e3
        with _WARM_LOCK:
            _WARM.add((dev_key, name))
        launched += 1
        PREWARM_PROGRAMS.inc({"entry": entry})
        sources = _SOURCES[entry]
        combos[name] = {
            "signature": sig_list,
            "build_seconds": round(sum(built.get(s, {}).get("seconds", 0.0) for s in sources), 3),
            "first_launch_ms": round(ms, 4),
            "bytes": int(nbytes),
            "kernels": {s: resources.get(s, {}) for s in sources},
        }
        _write_manifest(cache_dir, manifest)
        if progress is not None:
            progress(name, ms / 1e3)
        log.info("prewarmed", entry=name, ms=round(ms, 3))
        return out

    completed = False
    sweep_kit = None
    try:
        for kind, relax in (("generic", False), ("mixed", True)):
            check_stop()
            sched, problem, order = _representative(kind, dev)
            sig = buckets.signature(problem)

            def tables(sched=sched, problem=problem):
                tb = sched._tables(problem)  # K1 on the class rows (and tier rows)
                return tb, T._tree_nbytes(tb)

            got = run_combo(f"typeok_screen[relax={relax}]@{kind}", sig, tables)
            tb = got if got is not None else sched._tables(problem)
            sched._upload_pod_tables(problem)
            sched._bulk_flags_c = T._bulk_class_flags(problem, T._bulk_gates(problem, strict_types=False))
            sched._set_runflags_dev()
            if kind == "generic":
                sweep_kit = (sched, problem, order, tb)
            div = max(1, int(sched.opts.claim_slot_div))
            ladder = buckets.ladder(min_pods, max_pods, floor=64)
            for P in ladder:
                check_stop()
                xs, idx_d = sched._pod_xs_with_idx(problem, [order[0]] * P)
                N_runs, N_scan = claim_rungs(P, div)

                def runs(P=P, xs=xs, idx_d=idx_d, N=N_runs):
                    st = sched._init_state(problem, N)
                    seq = torch.zeros(N, dtype=torch.int32, device=dev)
                    next_seq = torch.zeros((), dtype=torch.int32, device=dev)
                    rx = sched._run_x(xs, idx_d, P)  # K4
                    out = KR.solve_runs(tb, st, rx, seq, next_seq, P, relax)  # K3
                    return out[0], T._tree_nbytes((tb, st, rx))

                st_runs = run_combo(f"solve_runs[relax={relax}]@P={P},N={N_runs}", sig, runs)

                def scan(xs=xs, N=N_scan):
                    st = sched._init_state(problem, N)
                    K.solve_scan(tb, st, xs, relax)  # K2
                    return None, T._tree_nbytes((tb, st, xs))

                run_combo(f"solve_scan[relax={relax}]@P={P},N={N_scan}", sig, scan)

                def dedup(st=st_runs, N=N_runs):
                    st = st if st is not None else sched._init_state(problem, N)
                    n2 = min(T._pow2(max(int(st.n_claims), 1), floor=64), N)
                    T.dedup_decode_state(st, n2)  # K5
                    return None, T._tree_nbytes(T.decode_columns(st))

                run_combo(f"dedup_rows[relax={relax}]@P={P},N={N_runs}", sig, dedup)

                if include_fleet and P == ladder[0]:
                    for B in fleet_lane_buckets:

                        def lanes(B=B, xs=xs, N=N_scan):
                            st_b, xs_b = fleet_mod.stack_lanes([sched._init_state(problem, N)] * B, [xs] * B)
                            K.solve_scan_lanes(tb, st_b, xs_b, relax)  # K7
                            return None, T._tree_nbytes((tb, st_b, xs_b))

                        run_combo(f"fleet_solve_scan[relax={relax}]@B={B},P={P},N={N_scan}", sig, lanes)
        if include_sweeps and sweep_kit is not None:
            _prewarm_sweeps(run_combo, sweep_kit, dev)
        completed = True
    except InterruptedError:
        log.warn("prewarm interrupted", launched=launched)
    seconds = time.monotonic() - t0
    PREWARM_SECONDS.observe(seconds)
    if completed:
        PREWARM_READY.set(1.0)
    return {
        "built": sum(1 for b in built.values() if b["seconds"]),
        "build_seconds": sum(b["seconds"] for b in built.values()),
        "launched": launched,
        "skipped": skipped,
        "seconds": seconds,
        "completed": completed,
        "cache_dir": cache_dir,
        "combos": combos,
    }


def _prewarm_sweeps(run_combo, kit, dev: torch.device) -> None:
    """The consolidation kernels at the JAX package's contract shapes, on
    the generic representative beside its existing nodes: K6 over 4
    prefix lanes and K8 over 1024 membership lanes of 8 candidates. This
    warms the kernels, not a production fleet's shapes: a disruption pass
    over a real fleet sizes its own lanes."""
    from karpenter_tpu_torch.controllers.disruption import setsweep as SS
    from karpenter_tpu_torch.controllers.disruption import sweep as SW
    from karpenter_tpu_torch.solver import tpu as T

    sched, p, order, tb = kit
    sig = (("kit", "generic"),)
    st = sched._init_state(p, 8)
    xs = sched._pod_xs(p, order)
    avail0 = to_tensor(p.eavail, dev)
    sizes = to_tensor(p.prequests_c[:1].astype(np.int32), dev)
    E = p.num_existing

    def fast():
        B = 4
        counts = torch.ones((B, 1), dtype=torch.int32, device=dev)
        cand_idx = to_tensor(np.arange(E, dtype=np.int32) % B, dev)
        SW.fast_sweep(tb, st, xs, avail0, cand_idx, counts, sizes)  # K6
        return None, T._tree_nbytes((tb, st, xs, avail0, cand_idx, counts, sizes))

    run_combo("fast_sweep@contract", sig, fast)

    def sets():
        B, J = 1024, 8
        member = to_tensor(((np.arange(B)[:, None] >> np.arange(J)[None, :]) & 1).astype(np.int32), dev)
        slot_cand = to_tensor(np.arange(E, dtype=np.int32) % (J + 1), dev)
        base_counts = torch.zeros((1,), dtype=torch.int32, device=dev)
        percand = torch.ones((J, 1), dtype=torch.int32, device=dev)
        SS.set_sweep(tb, st, xs, avail0, slot_cand, member, base_counts, percand, sizes)  # K8
        return None, T._tree_nbytes((tb, st, xs, avail0, slot_cand, member, base_counts, percand, sizes))

    run_combo("set_sweep@contract", sig, sets)
