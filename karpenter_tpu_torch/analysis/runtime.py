"""The port's runtime budgets: what a solve does besides computing its answer.

The JAX package pins, in `kernel_budgets.json`, how many table uploads a
solve makes and that a repeat solve traces and compiles nothing. The port
pins its own counterparts in `torch_budgets.json` (`budgets.py`), measured
here on the port's own objects:

- **The CPU scope** (entries `solve[runtime]`, `solve_relax[runtime]`,
  `epoch[runtime]`, `fleet[runtime]`, `setsweep[runtime]`,
  `sweep[runtime]`, `sweep_lanes[runtime]`): table uploads
  (`TorchScheduler._tables`, `_upload_pod_tables`, `_pod_xs_with_idx`
  calls), dispatches, and the calls of each kernel seam (`CALLS`,
  counted where a wrapper picks its plain version or its kernel, on both
  routes). These do not depend on the route, so they read the same on
  the CPU and on the card.
- **The `cuda:` scope**, on the card only: over one `torch.profiler`
  window around the repeat solve, window, batch or sweep, the kernel
  records of the hand-written kernels (`launches_hand`, exact, held to
  the wrappers' own count), torch's own kernels (`launches_torch`), host
  syncs and copies (ceilings), nvcc processes and library loads (0), new
  allocator segments of a same-bucket solve or sweep (0) and the peak
  device bytes above what the window started with; the same over a
  re-solve of the 10000-pod headline and the c6 mix
  (`cuda:headline[runtime]`, `cuda:c6[runtime]`); and each kernel's
  registers, shared memory and spill stores from ptxas
  (`cuda:kernel:<name>`).

Every measurement takes `device=` (None = the card, which raises without
one; "cpu" for the plain versions). `python -m karpenter_tpu_torch.analysis
--budgets` runs them against the manifest.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
import warnings
from typing import Any, Callable, Iterable, Optional

# ---------------------------------------------------------------------------
# the seams and the kernel records

# The seams: the wrappers that pick the plain version (CPU tensors) or the
# kernel (CUDA tensors), each with the LAUNCHES keys its card route counts
# under. A seam counts its calls in CALLS on both routes; the wrappers' own
# LAUNCHES dicts count the card's launches only.
SEAM_LAUNCHES = {
    "typeok_screen": ("typeok_screen",),
    "run_arrays": ("run_arrays",),
    "dedup_columns": ("dedup_rows",),
    "solve_scan": ("scan_step", "scan_step_relax"),
    "scan_lanes": ("scan_lanes", "scan_lanes_relax"),
    "solve_scan_lanes": ("fleet_lanes", "fleet_lanes_relax"),
    "solve_runs": ("run_step", "run_step_relax"),
    "fast_sweep": ("fast_sweep", "fast_sweep_singleton"),
    "set_sweep": ("set_sweep",),
}
CALLS = dict.fromkeys(SEAM_LAUNCHES, 0)

# Every hand-written kernel as the profiler names it (`kernel_name`), and
# the library whose launch function starts it (csrc/<library>.cu). This
# is the one table that tells them from torch's own kernels.
HAND_KERNELS = {
    "typeok_kernel": "typeok",
    "scan_step_kernel": "scan_step",
    "run_step_kernel": "run_step",
    "run_arrays_kernel": "run_arrays",
    "dedup_cluster_kernel": "dedup_rows",  # up to 8192 rows: one launch
    "hash_kernel": "dedup_rows",  # past 8192 rows: the passes below
    "sort_pass_kernel": "dedup_rows",
    "mark_kernel": "dedup_rows",
    "tile_sum_kernel": "dedup_rows",
    "tile_scan_kernel": "dedup_rows",
    "scatter_kernel": "dedup_rows",
    "scan_lanes_kernel": "scan_lanes",
    "sweep_cache_kernel": "fast_sweep and set_sweep",  # sweep_core.cuh
    "fast_sweep_lanes": "fast_sweep",
    "set_sweep_lanes": "set_sweep",
    "empty_kernel": "empty",  # the launch floor; marks a profiled window's start
}

# csrc/dedup_rows.cu CLUSTER_MAX_ROWS and TILE (16 positions a thread, 512
# threads a CTA); csrc/step.cuh KTPU_MAX_LANES
_DEDUP_CLUSTER_MAX_ROWS = 8192
_DEDUP_TILE = 16 * 512
_MAX_LANES = 128


def kernel_records(library: str, n: int = 0, lanes: int = 0) -> dict:
    """{kernel name: records} that one launch call of a library
    (csrc/<library>.cu) puts on the stream, from its launch function:

    - K1, K2, K3, K4: one kernel;
    - K5 `dedup_rows`: one cluster kernel up to 8192 rows; past that
      `launch_passes`: a hash pass, a bitonic sort of m(m+1)/2 passes
      over L = 2^m >= n positions (L at least a tile), then mark,
      tile-sum, tile-scan and scatter;
    - K6 `fast_sweep` and K8 `set_sweep`: the cache kernel, then the lanes
      kernel;
    - K7 `scan_lanes`: one launch per 128 lanes (the lane table's rows)."""
    if library == "dedup_rows":
        if n <= _DEDUP_CLUSTER_MAX_ROWS:
            return {"dedup_cluster_kernel": 1}
        L = _DEDUP_TILE
        while L < n:
            L <<= 1
        m = L.bit_length() - 1
        out = dict.fromkeys(("hash_kernel", "mark_kernel", "tile_sum_kernel", "tile_scan_kernel", "scatter_kernel"), 1)
        out["sort_pass_kernel"] = m * (m + 1) // 2
        return out
    if library == "scan_lanes":
        return {"scan_lanes_kernel": -(-lanes // _MAX_LANES)}
    if library in ("fast_sweep", "set_sweep"):
        return {"sweep_cache_kernel": 1, f"{library}_lanes": 1}
    return {f"{library}_kernel": 1}


# kernel records the card's route put on the stream, by kernel name
RECORDS: dict = collections.Counter()
_LOCK = threading.Lock()


def seam(name: str) -> None:
    """Count one call of a seam (either route)."""
    with _LOCK:
        CALLS[name] += 1


def launched(library: str, n: int = 0, lanes: int = 0) -> None:
    """Count the kernel records of one launch call on the card."""
    with _LOCK:
        RECORDS.update(kernel_records(library, n, lanes))


def kernel_name(profiler_name: str) -> str:
    """A kernel record's name as `HAND_KERNELS` keys it: `void
    dedup_cluster_kernel<true>(DedupArgs)` -> `dedup_cluster_kernel`; an
    Itanium-mangled name is cut to its function name."""
    from karpenter_tpu_torch import _build

    name = profiler_name.strip().replace("(anonymous namespace)::", "")
    if name.startswith("_Z"):
        return _build._demangle(name)
    if name.startswith("void "):
        name = name[5:]
    for stop in "(<":
        name = name.split(stop, 1)[0]
    return name.strip()


# ---------------------------------------------------------------------------
# counting helpers


@contextlib.contextmanager
def count_method_calls(cls: type, names: Iterable[str]):
    """Temporarily wrap methods of `cls` with call counters; yields the
    live {name: count} dict. Restores the original methods on exit."""
    counts = {n: 0 for n in names}
    originals = {n: getattr(cls, n) for n in counts}

    def _wrap(name: str, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            counts[name] += 1
            return fn(*args, **kwargs)

        return wrapper

    for n, fn in originals.items():
        setattr(cls, n, _wrap(n, fn))
    try:
        yield counts
    finally:
        for n, fn in originals.items():
            setattr(cls, n, fn)


@contextlib.contextmanager
def count_seams(names: Iterable[str]):
    """Yields {f"calls_{seam}": n}, filled in with the seams' calls over
    the block when it ends."""
    names = tuple(names)
    before = dict(CALLS)
    out: dict = {}
    try:
        yield out
    finally:
        out.update({f"calls_{n}": CALLS[n] - before[n] for n in names})


def launch_counts() -> dict:
    """Every wrapper's LAUNCHES counter, by key."""
    from karpenter_tpu_torch.controllers.disruption import setsweep, sweep
    from karpenter_tpu_torch.solver import tpu, tpu_kernel, tpu_runs

    out: dict = {}
    for counts in (tpu.LAUNCHES, tpu_kernel.LAUNCHES, tpu_runs.LAUNCHES, sweep.LAUNCHES, setsweep.LAUNCHES):
        out.update(counts)
    return out


def _resolve(device):
    from karpenter_tpu_torch.device import resolve_device

    return resolve_device(device)


# ---------------------------------------------------------------------------
# the profiled window (the cuda: scope)

# runtime records that block the host until the device catches up (a
# synchronous cudaMemcpy is a copy and a sync)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")
# runtime records that launch a kernel, copy and set memory: each has one
# device record, joined to it by correlation id
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")
COPY_PREFIX = "cudaMemcpy"
SET_PREFIX = "cudaMemset"
# the annotation around a window's block: runtime records outside it (the
# markers around it, the profiler's own sync at its stop) are not the block's
WINDOW_RANGE = "karpenter_budget_window"

# the marker launches and copies a window makes before and after its
# block, the host's wait beside them, and the windows a measurement may
# open before it gives up
MARKERS = 32
MARKER_SECONDS = 0.1
WINDOW_ATTEMPTS = 5


class WindowError(RuntimeError):
    """The profiler's records disagree with the wrappers' own counts."""


def _device(e) -> str:
    return str(getattr(e, "device_type", "")).rsplit(".", 1)[-1]


def census(events) -> dict:
    """Counts over one window's profiler events. The runtime records
    counted are those that start inside the `WINDOW_RANGE` annotation (all
    of them when there is none): syncs, launches, copies and every `cuda*`
    call by name. The device records counted are theirs, joined by
    correlation id: kernel records of the hand-written kernels (also by
    name) and of torch's, copies by direction, memsets. Records of the
    rest of the session (the markers around the block) are not counted;
    `records_missing` counts the block's launch, copy and memset calls
    that have no device record."""
    events = list(events)
    span = next(
        ((e.time_range.start, e.time_range.end) for e in events if e.name == WINDOW_RANGE and _device(e) == "CPU"),
        None,
    )
    inside, device = [], []
    outside = 0
    for e in events:
        if e.name == WINDOW_RANGE:
            continue
        if _device(e) == "CUDA":
            device.append(e)
        elif e.name.startswith(("cuda", "cuLaunch")):
            if span is None or span[0] <= e.time_range.start <= span[1]:
                inside.append(e)
            else:
                outside += 1
    ids = {e.id for e in inside}
    runtime_calls = collections.Counter(e.name for e in inside)
    hand: collections.Counter = collections.Counter()
    torch_kernels: collections.Counter = collections.Counter()
    out = {"launches_hand": 0, "launches_torch": 0, "h2d_copies": 0, "d2h_copies": 0, "d2d_copies": 0, "memsets": 0}
    others = 0
    for e in device:
        if e.id not in ids:
            others += 1
            continue
        name = e.name
        if name.startswith("Memcpy"):
            out["h2d_copies" if "HtoD" in name else "d2h_copies" if "DtoH" in name else "d2d_copies"] += 1
        elif name.startswith("Memset"):
            out["memsets"] += 1
        elif kernel_name(name) in HAND_KERNELS:
            out["launches_hand"] += 1
            hand[kernel_name(name)] += 1
        else:
            out["launches_torch"] += 1
            torch_kernels[kernel_name(name)] += 1

    def calls(*prefixes) -> int:
        return sum(v for n, v in runtime_calls.items() if n.startswith(prefixes))

    out["host_syncs"] = sum(runtime_calls[n] for n in SYNC_CALLS)
    out["launch_calls"] = calls(*LAUNCH_PREFIXES)
    out["records_missing"] = (
        out["launch_calls"] - out["launches_hand"] - out["launches_torch"]
        + calls(COPY_PREFIX) - out["h2d_copies"] - out["d2h_copies"] - out["d2d_copies"]
        + calls(SET_PREFIX) - out["memsets"]
    )
    out["runtime_calls"] = dict(sorted(runtime_calls.items()))
    out["runtime_calls_outside"] = outside
    out["device_records_outside"] = others
    out["hand_kernels"] = dict(sorted(hand.items()))
    out["torch_kernels"] = dict(torch_kernels.most_common())
    out["annotated"] = span is not None
    return out


class DeviceWindow:
    """One profiled window on the card. Use as a context manager around a
    repeat; afterwards `metrics` holds the budgeted counts and `detail`
    the census behind them (runtime calls by name, sync-debug warnings,
    torch's kernels by name, the LAUNCHES and seam deltas).

    Raises WindowError when a record is missing: a launch, copy or memset
    call of the block has no device record, the hand-written kernels'
    records differ from the wrappers' count (`RECORDS`), or the wrappers'
    launches from their seams' calls. A dropped record is a failed window,
    never a smaller count.

    The device is synchronized before the window opens. The block runs
    inside the `WINDOW_RANGE` annotation, between `MARKERS` launches of the
    empty kernel and as many one-element copies to the card, each batch
    synchronized and `MARKER_SECONDS` apart from the block (on the card the
    profiler has lost records near the start of a session: these absorb
    it). Every measured block ends in a host read of its last kernel's
    output, so its kernels are complete when the window closes."""

    def __init__(self, dev):
        self.dev = dev
        self.metrics: dict = {}
        self.detail: dict = {}

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from karpenter_tpu_torch import _build
        from karpenter_tpu_torch.solver import tpu

        tpu._empty_lib()  # loaded before the count of library loads starts
        self._launches = launch_counts()
        self._calls = dict(CALLS)
        self._records = collections.Counter(RECORDS)
        self._nvcc = _build.NVCC_STARTS
        self._loads = _build.LIBRARY_LOADS
        torch.cuda.synchronize(self.dev)
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._markers()
        time.sleep(MARKER_SECONDS)
        self._base = torch.cuda.memory_allocated(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        self._range = record_function(WINDOW_RANGE)
        self._range.__enter__()
        self._warn = warnings.catch_warnings(record=True)
        self._caught = self._warn.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def _markers(self) -> None:
        import torch

        from karpenter_tpu_torch.solver import tpu

        dst = torch.empty(1, dtype=torch.int32, device=self.dev)
        src = torch.zeros(1, dtype=torch.int32)
        for _ in range(MARKERS):
            tpu.empty_launch(self.dev)
            dst.copy_(src)
        torch.cuda.synchronize(self.dev)

    def __exit__(self, exc_type, exc, tb):
        import torch

        from karpenter_tpu_torch import _build

        torch.cuda.set_sync_debug_mode(0)
        self._warn.__exit__(None, None, None)
        self._range.__exit__(None, None, None)
        if exc_type is None:
            torch.cuda.synchronize(self.dev)
            time.sleep(MARKER_SECONDS)
            self._markers()
        self._prof.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            return False
        peak = torch.cuda.max_memory_allocated(self.dev) - self._base
        c = census(self._prof.events())
        launches = {k: v - self._launches[k] for k, v in launch_counts().items() if v != self._launches[k]}
        calls = {k: v - self._calls[k] for k, v in CALLS.items() if v != self._calls[k]}
        records = collections.Counter(RECORDS)
        records.subtract(self._records)
        records = {k: v for k, v in records.items() if v}
        warned = [w for w in self._caught if "synchroniz" in str(w.message)]
        self.metrics = {
            "launches_hand": c["launches_hand"],
            "launches_torch": c["launches_torch"],
            "host_syncs": c["host_syncs"],
            "h2d_copies": c["h2d_copies"],
            "d2h_copies": c["d2h_copies"],
            "peak_device_bytes": max(0, int(peak)),
            "second_solve_builds": _build.NVCC_STARTS - self._nvcc,
            "second_solve_library_loads": _build.LIBRARY_LOADS - self._loads,
        }
        self.detail = {k: v for k, v in c.items() if k not in self.metrics and k != "annotated"}
        self.detail.update(
            records=dict(sorted(records.items())), launches=launches, calls=calls, sync_warnings=len(warned),
            sync_sites=dict(collections.Counter(_site(w) for w in warned).most_common()),
        )
        faults = [] if c["annotated"] else [f"the profiler lost the {WINDOW_RANGE} annotation"]
        if c["records_missing"]:
            faults.append(f"{c['records_missing']} of the block's launch, copy and memset calls have no device record")
        if c["hand_kernels"] != self.detail["records"]:
            faults.append(f"profiler hand kernels {c['hand_kernels']} != the wrappers' records {self.detail['records']}")
        for s, keys in SEAM_LAUNCHES.items():
            got = sum(launches.get(k, 0) for k in keys)
            if got != calls.get(s, 0):
                faults.append(f"{s}: {calls.get(s, 0)} calls but {got} launches ({keys})")
        if faults:
            raise WindowError("; ".join(faults))
        return False


class Windows:
    """The `cuda:` scope's recorder on `dev`: `run(entry, block)` runs
    the block in a `DeviceWindow` and keeps its metrics and census under
    `entry`. A window that misses a record is discarded whole (its error
    kept in the census's `discarded`) and the block runs again in a new
    one, up to `WINDOW_ATTEMPTS` windows; `prepare()` runs before each,
    outside it, and its result is the block's argument."""

    def __init__(self, dev):
        self.dev = dev
        self.metrics: dict = {}
        self.detail: dict = {}

    def run(self, entry: str, block: Callable, prepare: Callable = lambda: None) -> None:
        discarded: list = []
        for _ in range(WINDOW_ATTEMPTS):
            arg = prepare()
            try:
                with DeviceWindow(self.dev) as w:
                    block(arg)
            except WindowError as e:
                discarded.append(str(e))
                continue
            self.metrics[entry] = dict(w.metrics)
            self.detail[entry] = dict(w.detail, discarded=discarded)
            return
        raise WindowError(f"{entry}: {WINDOW_ATTEMPTS} windows missed records: " + " | ".join(discarded))


def _repeat(windows: Optional[Windows], entry: str, block: Callable[[], Any]) -> None:
    """Run an entry's repeat: plainly, or in a window of `windows`."""
    if windows is None:
        block()
    else:
        windows.run(entry, lambda _: block())


def _site(w) -> str:
    """A warning's source line, as `<package dir>/<file>:<line>`."""
    parts = str(w.filename).replace("\\", "/").split("/")
    return f"{'/'.join(parts[-2:])}:{w.lineno}"


def _segments(dev) -> int:
    import torch

    return int(torch.cuda.memory_stats(dev).get("segment.all.allocated", 0))


# ---------------------------------------------------------------------------
# the problems

_UPLOADS = ("_tables", "_upload_pod_tables", "_pod_xs_with_idx")
SOLVE_SEAMS = ("typeok_screen", "run_arrays", "solve_runs", "solve_scan", "dedup_columns")


def _solve(kind: str, dev, n_pods: int = 6, force_scan: bool = False, table_cache=None):
    """One solve of `aot._representative(kind)`: the prewarm's problem, so
    the buckets agree with the JAX package's budgets."""
    from karpenter_tpu_torch.solver import aot

    sched, problem, _ = aot._representative(kind, device=dev, n_pods=n_pods, table_cache=table_cache)
    sched.debug_force_scan = force_scan
    return sched.solve(problem.pods)


def solve_metrics(kind: str = "generic", device=None, windows: Optional[Windows] = None) -> dict:
    """Entry `solve[runtime]` ("generic") or `solve_relax[runtime]`
    ("mixed", the tier loop): the first solve's table, pod-table and
    pod-batch uploads, and the seams' calls over five solves of the
    representative problem: a first and a second solve on the runs path
    and on the scan path (`debug_force_scan`), then a 7-pod solve in the
    same pow-2 bucket. With `windows` (on the card) the two second solves
    run in one window, and the 7-pod solve's new allocator segments are
    counted."""
    from karpenter_tpu_torch.solver.tpu import TorchScheduler

    dev = _resolve(device)
    entry = "cuda:" + ("solve[runtime]" if kind == "generic" else "solve_relax[runtime]")
    with count_seams(SOLVE_SEAMS) as calls:
        with count_method_calls(TorchScheduler, _UPLOADS) as up:
            _solve(kind, dev)
        _solve(kind, dev, force_scan=True)
        _repeat(windows, entry, lambda: (_solve(kind, dev), _solve(kind, dev, force_scan=True)))
        seg0 = _segments(dev) if windows is not None else 0
        _solve(kind, dev, n_pods=7)
        if windows is not None:
            windows.metrics[entry]["same_bucket_solve_segments"] = _segments(dev) - seg0
    return {
        "table_uploads": up["_tables"],
        "pod_table_uploads": up["_upload_pod_tables"],
        "pod_batch_uploads": up["_pod_xs_with_idx"],
        **calls,
    }


def epoch_metrics(device=None, windows: Optional[Windows] = None) -> dict:
    """Entry `epoch[runtime]`: two solves of the generic problem through
    one `epochs.DeviceTableCache`, as the sidecar serves a repeat
    same-epoch solve: the first uploads once, the repeat uploads only its
    pod batch. The window is around the repeat."""
    from karpenter_tpu_torch.solver import epochs
    from karpenter_tpu_torch.solver.tpu import TorchScheduler

    dev = _resolve(device)
    cache = epochs.DeviceTableCache()
    with count_method_calls(TorchScheduler, _UPLOADS) as first:
        _solve("generic", dev, table_cache=cache)
    with count_method_calls(TorchScheduler, _UPLOADS) as repeat:
        _repeat(windows, "cuda:epoch[runtime]", lambda: _solve("generic", dev, table_cache=cache))
    return {
        "epoch_first_table_uploads": first["_tables"],
        "epoch_repeat_table_uploads": repeat["_tables"],
        "epoch_repeat_pod_table_uploads": repeat["_upload_pod_tables"],
        "epoch_repeat_pod_batch_uploads": repeat["_pod_xs_with_idx"],
    }


def _fleet_lane(dev, cache, coalescer):
    """(TorchScheduler, pods) of one fleet lane: the reference's scan-path
    fixture (six self-spreading pods: the zone spread sends them down the
    scan path, the only one the coalescer serves)."""
    from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.solver.tpu import TorchScheduler
    from karpenter_tpu_torch.testing import fixtures

    fixtures.reset_rng(7)
    its = construct_instance_types(sizes=[2])
    pool = fixtures.node_pool(name="default")
    pods = fixtures.make_self_spread_pods(6)
    topo = Topology([pool], {"default": its}, pods)
    sched = TorchScheduler([pool], {"default": its}, topo, device=dev, table_cache=cache, fleet=coalescer)
    return sched, pods


def fleet_metrics(device=None, windows: Optional[Windows] = None) -> dict:
    """Entry `fleet[runtime]`: two windows of two concurrent scan-path
    lanes through one `FleetCoalescer` and one `DeviceTableCache`, as a
    fleet-serving sidecar stacks sibling solves. The first window
    materializes the tables once; the repeat uploads none and makes one
    dispatch (one `solve_scan_lanes` call, launched from the leader's
    thread). The window is around the repeat."""
    from karpenter_tpu_torch import tracing
    from karpenter_tpu_torch.solver import epochs
    from karpenter_tpu_torch.solver.fleet import FleetCoalescer
    from karpenter_tpu_torch.solver.tpu import TorchScheduler

    dev = _resolve(device)
    cache = epochs.DeviceTableCache()
    coalescer = FleetCoalescer(window_seconds=10.0, max_lanes=2)

    def window() -> None:
        lanes = [_fleet_lane(dev, cache, coalescer) for _ in range(2)]
        errors: list = []

        def run(sched, pods) -> None:
            try:
                sched.solve(pods)
            except BaseException as e:  # raised below, never swallowed
                errors.append(e)

        threads = [threading.Thread(target=run, args=lane, daemon=True) for lane in lanes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors:
            raise errors[0]
        if not all(s.last_used_fleet for s, _ in lanes):
            raise RuntimeError("fleet runtime budget: the lanes did not coalesce")

    with count_method_calls(TorchScheduler, ("_tables",)) as first:
        window()
    d0 = tracing.SOLVE_DISPATCHES.value({"path": "fleet"})
    with count_seams(("solve_scan_lanes",)) as calls:
        with count_method_calls(TorchScheduler, ("_tables",)) as repeat:
            _repeat(windows, "cuda:fleet[runtime]", window)
    return {
        "fleet_first_window_table_uploads": first["_tables"],
        "fleet_repeat_window_table_uploads": repeat["_tables"],
        "fleet_repeat_window_dispatches": int(tracing.SOLVE_DISPATCHES.value({"path": "fleet"}) - d0),
        **calls,
    }


def _set_fleet():
    """(Operator, candidates) of the reference's tiny under-utilized fleet:
    five one-rider nodes provisioned through the port's control plane on
    the oracle (no device work before the sweeps)."""
    from karpenter_tpu_torch.controllers.disruption.consolidation import MultiNodeConsolidation
    from karpenter_tpu_torch.testing import fixtures

    op = fixtures.underutilized_operator(5, seed=7, force_oracle=True, max_ticks=120)
    mnc = MultiNodeConsolidation(op.kube, op.cluster, op.cloud, op.clock, options=op.opts, force_oracle=True)
    return op, mnc.candidates()


def setsweep_metrics(device=None, windows: Optional[Windows] = None) -> dict:
    """Entry `setsweep[runtime]`: on the tiny fleet, `SetSweepContext.build`
    uploads the tables once, and a 1024-lane membership batch is one
    dispatch (one `set_sweep` call). The window is around a second batch
    (the rows reversed)."""
    import numpy as np

    from karpenter_tpu_torch import tracing
    from karpenter_tpu_torch.controllers.disruption.setsweep import SetProposer, SetSweepContext
    from karpenter_tpu_torch.solver.tpu import TorchScheduler

    dev = _resolve(device)
    op, candidates = _set_fleet()
    with count_method_calls(TorchScheduler, ("_tables", "_upload_pod_tables")) as uploads:
        ctx = SetSweepContext.build(op.kube, op.cluster, op.cloud, candidates, op.opts, device=dev)
    proposer = SetProposer(candidates, seed=7, max_lanes=1024)
    member = proposer._dedup(proposer._random(8 * 1024))
    pad = np.zeros((1024, len(candidates)), bool)
    pad[: len(member)] = member[:1024]
    d0 = tracing.SOLVE_DISPATCHES.value({"path": "setsweep"})
    with count_seams(("set_sweep",)) as calls:
        ctx.evaluate(pad)
    dispatches = int(tracing.SOLVE_DISPATCHES.value({"path": "setsweep"}) - d0)
    _repeat(windows, "cuda:setsweep[runtime]", lambda: ctx.evaluate(pad[::-1].copy()))
    return {
        "set_table_uploads": uploads["_tables"],
        "set_pod_table_uploads": uploads["_upload_pod_tables"],
        "set_eval_dispatches": dispatches,
        **calls,
    }


def sweep_metrics(device=None, windows: Optional[Windows] = None) -> dict:
    """Entry `sweep[runtime]`: one prefix and one singleton sweep of the
    tiny fleet, each one `fast_sweep` call (the delta-state path; the
    full-state lane scan, `scan_lanes`, takes none). The window is around
    a repeat of both."""
    from karpenter_tpu_torch.controllers.disruption.sweep import prefix_feasibility, singleton_feasibility

    dev = _resolve(device)
    op, candidates = _set_fleet()

    def both() -> None:
        prefix_feasibility(op.kube, op.cluster, op.cloud, candidates, op.opts, device=dev)
        singleton_feasibility(op.kube, op.cluster, op.cloud, candidates, op.opts, device=dev)

    with count_seams(("fast_sweep", "scan_lanes")) as calls:
        both()
    _repeat(windows, "cuda:sweep[runtime]", both)
    return dict(calls)


def _spread_fleet():
    """(World, candidates) of a five-node under-utilized fleet whose riders
    carry a zone spread (max skew 4), built as chip_smoke.py builds its
    spread fleet: on the host with the port's oracle, no Operator and no
    device work. The fast gates refuse it ("topology constraints among
    union pods"), so its sweeps take the full-state lane scan."""
    from karpenter_tpu_torch.controllers.disruption.helpers import build_candidates
    from karpenter_tpu_torch.testing import fixtures

    w = fixtures.underutilized_world(5, seed=7, rider_spread=4)
    cands = build_candidates(w.kube, w.cluster, w.cloud, w.clock, lambda c: c.consolidatable())
    cands.sort(key=lambda c: (c.disruption_cost, c.name))
    return w, cands


def sweep_lanes_metrics(device=None, windows: Optional[Windows] = None) -> dict:
    """Entry `sweep_lanes[runtime]`: one prefix and one singleton sweep of
    the spread fleet, each one `scan_lanes` call (K7, the full-state lane
    scan) and no `fast_sweep` call. The window is around a repeat of both;
    with `windows` (on the card) the repeat's new allocator segments are
    counted."""
    from karpenter_tpu_torch.controllers.disruption.sweep import prefix_feasibility, singleton_feasibility

    dev = _resolve(device)
    w, candidates = _spread_fleet()

    def both() -> None:
        prefix_feasibility(w.kube, w.cluster, w.cloud, candidates, device=dev)
        singleton_feasibility(w.kube, w.cluster, w.cloud, candidates, device=dev)

    entry = "cuda:sweep_lanes[runtime]"
    with count_seams(("fast_sweep", "scan_lanes")) as calls:
        both()
    seg0 = _segments(dev) if windows is not None else 0
    _repeat(windows, entry, both)
    if windows is not None:
        windows.metrics[entry]["same_bucket_solve_segments"] = _segments(dev) - seg0
    return dict(calls)


# the CPU scope's entries and their measurements
CPU_ENTRIES: dict = {
    "solve[runtime]": functools.partial(solve_metrics, "generic"),
    "solve_relax[runtime]": functools.partial(solve_metrics, "mixed"),
    "epoch[runtime]": epoch_metrics,
    "fleet[runtime]": fleet_metrics,
    "setsweep[runtime]": setsweep_metrics,
    "sweep[runtime]": sweep_metrics,
    "sweep_lanes[runtime]": sweep_lanes_metrics,
}


def measure_cpu_scope(device=None, entries: Optional[Iterable[str]] = None, windows: Optional[Windows] = None) -> dict:
    """{entry: metrics} of the CPU scope on `device`; with `windows` (on
    the card) each measurement also records its `cuda:` entry there."""
    names = CPU_ENTRIES if entries is None else entries
    return {name: CPU_ENTRIES[name](device=device, windows=windows) for name in names}


# ---------------------------------------------------------------------------
# the full-width re-solves and the kernels' resources (card only)

HEADLINE_PODS = 10000
HEADLINE_TYPES = 500


def full_width_world(kind: str, dev, n_pods: int = HEADLINE_PODS, n_types: int = HEADLINE_TYPES):
    """(TorchScheduler, pods) of the headline (`make_diverse_pods` on 500
    KWOK types, one default NodePool) or the c6 mix (the same with a 2%
    tail of preference pods), as chip_smoke.py builds them."""
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.solver.tpu import TorchScheduler
    from karpenter_tpu_torch.testing import fixtures

    its = fixtures.kwok_universe(n_types)
    if kind == "headline":
        fixtures.reset_rng(42)
        pods = fixtures.make_diverse_pods(n_pods)
    else:
        pods = fixtures.c6_pods(n_pods)
    pools = [fixtures.node_pool(name="default")]
    ibp = {p.name: its for p in pools}
    return TorchScheduler(pools, ibp, Topology(pools, ibp, pods), device=dev), pods


def kernel_metrics() -> dict:
    """{"cuda:kernel:<name>": {"registers", "smem_bytes",
    "spill_store_bytes"}} of every hand-written kernel, from the build's
    ptxas logs (`_build.ptxas_resources`); a name built in two libraries
    (the sweep cache kernel) keeps the largest of each."""
    from karpenter_tpu_torch import _build

    merged: dict = {}
    for info in _build.build_all().values():
        for name, res in _build.ptxas_resources(info.get("log", "")).items():
            had = merged.setdefault(name, {})
            for k in ("registers", "smem_bytes", "spill_store_bytes"):
                had[k] = max(had.get(k, 0), res[k])
    missing = sorted(set(HAND_KERNELS) - set(merged))
    if missing:
        raise RuntimeError(f"ptxas logs name no resources for {missing}")
    return {f"cuda:kernel:{k}": merged[k] for k in sorted(merged)}


def seam_issues(detail: dict) -> list:
    """The counted seams (rules_kernel.COUNTED_SEAMS) whose named `cuda:`
    entry saw no host sync inside the seam's function: one `unseen-seam`
    BudgetIssue each. `detail` is measure_cuda_scope's census, whose
    `sync_sites` are the sync-debug warnings' `<dir>/<file>:<line>`. A seam
    that names a window which never runs it counts nothing, so the static
    rule's allow-list would rest on an unmeasured sync."""
    import ast
    import os

    from karpenter_tpu_torch.analysis.budgets import BudgetIssue
    from karpenter_tpu_torch.analysis.rules_kernel import COUNTED_SEAMS, _functions

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    trees: dict = {}
    out = []
    for (module, qualname), seam in sorted(COUNTED_SEAMS.items()):
        if module not in trees:
            with open(os.path.join(root, module), encoding="utf-8") as f:
                trees[module] = _functions(ast.parse(f.read()))
        fn = trees[module][qualname]
        short = "/".join(module.split("/")[-2:])
        sites = detail.get(seam["entry"], {}).get("sync_sites", {})
        seen = any(
            path == short and fn.lineno <= int(line) <= fn.end_lineno
            for path, _, line in (site.rpartition(":") for site in sites)
        )
        if not seen:
            out.append(BudgetIssue("unseen-seam", seam["entry"], f"{short} {qualname}", None, None))
    return out


def measure_cuda_scope(device=None, worlds: Optional[dict] = None) -> tuple[dict, dict, dict]:
    """(CPU-scope entries measured on the card, `cuda:` entries, the
    windows' census). The CPU scope is measured as on the CPU; then the
    same measurements run again with each repeat in a window (their counts
    are not kept: a discarded window runs its block again), then one
    profiled re-solve of the headline and of the c6 mix after a warm-up
    solve. `worlds` maps "headline" and "c6" to a callable that makes a
    fresh (scheduler, pods) (chip_smoke.py passes its own); without it they
    are built here at full width."""
    dev = _resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("the cuda: scope is measured on the card only")
    cpu = measure_cpu_scope(dev)
    windows = Windows(dev)
    measure_cpu_scope(dev, windows=windows)
    for kind in ("headline", "c6"):
        make = (worlds or {}).get(kind) or functools.partial(full_width_world, kind, dev)
        sched, pods = make()
        sched.solve(pods)
        windows.run(f"cuda:{kind}[runtime]", lambda world: world[0].solve(world[1]), make)
    windows.metrics.update(kernel_metrics())
    return cpu, windows.metrics, windows.detail
