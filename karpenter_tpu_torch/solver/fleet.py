"""Fleet lanes: concurrent scan-path solves share one launch per round.

A port of the reference's `solver/fleet.py`. Independent solve lanes
(control planes or simulation lanes asking one solver about one cluster at
once) that share a TABLE fingerprint (`epochs.table_fingerprint`: the
cluster tables, topology groups and relax-tier tables, not the per-pod
columns, which ride each lane's own PodX) meet in a batch window and run
every requeue round as ONE dispatch over all active lanes:

- **The lane core** (`stack_lanes`, `fleet_dispatch`): each lane's State
  and PodX stacked on a leading lane axis, and one
  `tpu_kernel.solve_scan_lanes` call per round, which on the card is one
  launch of K7 `scan_lanes` (K2's walk, one CTA per lane, each lane's
  State and PodX rows resolved once per launch).
- **`FleetCoalescer`**: the batch window in front of `TorchScheduler`'s
  scan-path solve loop. The first lane in leads: it waits up to
  `window_seconds` for siblings (woken early when `max_lanes` arrive),
  then drives every lane's rounds while the others block on their events.

Eligibility and isolation, as in the reference:

- only SCAN-path solves coalesce (`TorchScheduler` offers nothing else):
  the runs path grows claim slots mid-round on the host, per lane;
- the window key is (table fingerprint, claim slots N, relax); lanes with
  another key land in another window;
- a window that closes with one lane answers None (mode `solo_window`);
- a lane past its deadline finishes `timed_out` with the decisions it
  has; a lane whose host work raises is errored alone; a lane that
  overflows its claim slots leaves the window for the solo loop's
  N-doubling restart (decisions do not depend on N); a fault of the
  shared dispatch returns every lane to the solo path. Each of these is
  mode `fallback`, and the exception caught is kept in
  `FleetCoalescer.last_fallback_error`.

Decisions are bit-identical to solo by construction: each lane runs the
same step over its own state, with the solo loop's per-round pending sets
and stall rule.

Not ported, because one card has no counterpart: the mesh placement of
the lane axis (`_mesh_active`, `shard_lanes`, the `shard_map` variant of
`fleet_fn`, `_MESH_DISPATCH_LOCK`). The reference also backfills each
round's lanes with lane 0 up to the pow-2 lane bucket, only to reuse one
compiled XLA shape; K7 takes any lane count, so a round here launches
exactly its active lanes.

The reference's metrics and `fleet_window` trace events become module
counters and `last_*` introspection (the port has no tracing yet):
`FLEET_SOLVES` by mode, `FLEET_DISPATCHES`, `FLEET_LANES` (dispatches by
lane count), per lane `TorchScheduler.last_fleet` (mode, lanes, rounds,
window wait) and per window `FleetCoalescer.last_window` (lanes, rounds,
the window's rung P0 and its host phases in seconds).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from karpenter_tpu_torch.solver import epochs
from karpenter_tpu_torch.solver import tpu_kernel as K
from karpenter_tpu_torch.solver.tpu import _fold_odo, _new_odo_totals
from karpenter_tpu_torch.solver.tpu_problem import _pow2

# lanes offered to the coalescer, by outcome: coalesced (shared lane
# dispatches), solo_window (no sibling arrived in the window), fallback
# (an overflow, a lane error or a coalescing fault returned the lane to
# the solo path)
FLEET_SOLVES = {"coalesced": 0, "solo_window": 0, "fallback": 0}
# shared lane dispatches (one K7 launch each on the card)
FLEET_DISPATCHES = {"fleet": 0}
# dispatches by their lane count
FLEET_LANES: dict = {}
_COUNTS_LOCK = threading.Lock()

# the hard cap on a non-leader lane's result wait. Before the leader
# drains the window a waiter that exhausts its deadline-shaped budget
# WITHDRAWS (removes itself from the lane list and solves solo); after
# the drain the leader owns the lane, so the waiter takes the handoff
# under this cap — the leader sets every drained lane's done event in a
# finally, so exceeding it means the leader thread died, and the lane
# falls back to the solo path
_RESULT_WAIT_CAP_SECONDS = 600.0


def _count(counts: dict, key, by: int = 1) -> None:
    with _COUNTS_LOCK:
        counts[key] = counts.get(key, 0) + by


def reset_counters() -> None:
    """Set FLEET_SOLVES and FLEET_DISPATCHES to 0 and empty FLEET_LANES."""
    with _COUNTS_LOCK:
        for counts in (FLEET_SOLVES, FLEET_DISPATCHES):
            for k in counts:
                counts[k] = 0
        FLEET_LANES.clear()


# ---------------------------------------------------------------------------
# the lane core


def stack_lanes(st_list: list, xs_list: list):
    """Per-lane States and PodX batches stacked on a leading lane axis.
    Lanes must be shape-compatible (one table fingerprint, one claim-slot
    count, one pod rung)."""
    return K.stack_lanes(st_list), K.stack_lanes(xs_list)


def fleet_dispatch(tb, st_b, xs_b, relax: bool = True):
    """ONE dispatch running every stacked lane's requeue round; returns
    (st_b, kinds_b [B, P], slots_b [B, P], over_b [B], odo_b) with a
    leading lane axis (odo_b: every Odometer field per lane)."""
    out = K.solve_scan_lanes(tb, st_b, xs_b, relax)
    _count(FLEET_DISPATCHES, "fleet")
    _count(FLEET_LANES, int(st_b.rank.shape[0]))
    return out


def _fetch(kinds_b, slots_b, over_b, odo_b) -> tuple:
    """One device-to-host copy of a dispatch's outputs: (kinds [B, P],
    slots [B, P], over [B] bool, per-lane Odometers of host values)."""
    P = kinds_b.shape[1]
    host = torch.cat(
        [
            kinds_b,
            slots_b,
            over_b[:, None].to(torch.int32),
            odo_b.steps[:, None],
            odo_b.bulk_steps[:, None],
            odo_b.tier_steps[:, None],
            odo_b.tier_hist,
        ],
        dim=1,
    ).cpu().numpy()
    odos = [
        K.Odometer(steps=r[2 * P + 1], bulk_steps=r[2 * P + 2], tier_steps=r[2 * P + 3], tier_hist=r[2 * P + 4 :])
        for r in host
    ]
    return host[:, :P], host[:, P : 2 * P], host[:, 2 * P] != 0, odos


# ---------------------------------------------------------------------------
# the batch-window coalescer


class _Lane:
    """One request's seat in a batch window. Mutated by the leader thread
    while the owner blocks on `done`; ownership hands back at done.set(),
    so no field is ever accessed concurrently."""

    __slots__ = (
        "sched", "problem", "tb", "order", "N", "relax", "deadline", "done", "result", "error",
        "entered_at", "st", "kinds", "slots", "pending", "finished", "timed_out", "solo", "rounds",
        "lanes_in_window", "odo",
    )

    def __init__(self, sched, problem, tb, order, N, relax, deadline):
        self.sched = sched
        self.problem = problem
        self.tb = tb
        self.order = order
        self.N = N
        self.relax = relax
        self.deadline = deadline
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.entered_at = time.monotonic()
        self.st = None
        self.kinds = None
        self.slots = None
        self.pending: list[int] = []
        self.finished = False
        self.timed_out = False
        self.solo = False
        self.rounds = 0
        self.lanes_in_window = 1
        # this lane's kernel odometer over the shared rounds (folded into
        # the scheduler's last_odometer)
        self.odo = _new_odo_totals()


class _Window:
    """One open batch window for a lane-group key. The FIRST lane in
    becomes the leader: it waits `window_seconds` (woken early when the
    window fills), drains the lane list, and drives every lane's rounds
    through shared dispatches while the others block on their events."""

    def __init__(self, first: _Lane):
        self.lanes: list[_Lane] = [first]
        self.full = threading.Event()
        # set under the coalescer lock when the leader copies the lane
        # list: a waiter that gives up BEFORE the drain removes itself
        # (the leader never sees it); after the drain the leader owns the
        # lane and the waiter must take the handoff, not fork a duplicate
        # solo solve of the same scheduler
        self.drained = False


class FleetCoalescer:
    """The batch-window layer in front of scan-path solves.

    The single lock guards only the open-window map and lane-list
    membership; it is never held across a wait or a dispatch. Leader and
    waiter hand off through per-lane Events; the leader sets every lane's
    event in a finally, so a waiter can only time out if the leader thread
    died (then the lane solves solo).

    `window_seconds` is the latency a request trades for siblings; a
    window that closes with one lane charges only that wait and falls
    back to the solo path. `max_lanes` wakes the leader early when the
    window fills, and a lane arriving at a full window opens a fresh
    one."""

    def __init__(self, window_seconds: float = 0.02, max_lanes: int = 8):
        self.window_seconds = float(window_seconds)
        self.max_lanes = int(max_lanes)
        self._lock = threading.Lock()
        self._open: dict[tuple, _Window] = {}
        # the exception behind the last lane that fell back to the solo
        # path (None while none has)
        self.last_fallback_error: Optional[BaseException] = None
        # the last window's lanes, rounds, pod rung P0 and host phases
        self.last_window: dict = {}

    # -- the TorchScheduler hook -----------------------------------------

    def solve_lane(self, sched, problem, tb, order, N: int, relax: bool, deadline):
        """Offer one scan-path solve to the current batch window.

        Returns (st, kinds, slots, timed_out, odo) — the solo scan loop's
        tuple plus this lane's odometer accumulator, ready for
        `TorchScheduler._decode` — or None when the lane must run the solo
        path instead (no sibling arrived, claim-slot overflow, a lane-local
        or batch-wide failure). Never raises for coalescing faults: the
        solo path is always the floor. Sets `sched.last_fleet`."""
        lane = _Lane(sched, problem, tb, order, N, relax, deadline)
        key = (epochs.table_fingerprint(problem), int(N), bool(relax))
        try:
            result = self._submit(key, lane)
        except Exception as e:
            # a batch-wide fault (stack or dispatch raised in THIS lane's
            # leader turn) lands on the solo loop; the siblings were already
            # errored to their own solo fallbacks by _submit
            lane.error = e
            result = None
        if result is not None:
            mode = "coalesced"
        elif lane.error is None and not lane.solo:
            mode = "solo_window"
        else:
            mode = "fallback"
        _count(FLEET_SOLVES, mode)
        if lane.error is not None:
            self.last_fallback_error = lane.error
        sched.last_fleet = {
            "mode": mode,
            "lanes": lane.lanes_in_window,
            "rounds": lane.rounds,
            "wait_seconds": time.monotonic() - lane.entered_at,
        }
        return result

    def _submit(self, key: tuple, lane: _Lane):
        with self._lock:
            window = self._open.get(key)
            if window is not None and len(window.lanes) >= self.max_lanes:
                # the incumbent window is FULL (its leader is waking to
                # drain it): never join past max_lanes; open a fresh window
                # in the map slot (the drain-time `is window` check keeps
                # both sound)
                window = None
            if window is None:
                window = _Window(lane)
                self._open[key] = window
                leader = True
            else:
                window.lanes.append(lane)
                leader = False
                if len(window.lanes) >= self.max_lanes:
                    window.full.set()
        if not leader:
            # deadline-shaped first wait: a lane with a short budget should
            # not sit a full result cap behind a slow window
            budget = _RESULT_WAIT_CAP_SECONDS
            if lane.deadline is not None:
                budget = min(budget, max(1.0, lane.deadline - time.monotonic()) + self.window_seconds + 60.0)
            if not lane.done.wait(budget):
                with self._lock:
                    if not window.drained:
                        # the leader has not taken the lane list yet:
                        # withdraw and solve solo; the leader never sees it
                        window.lanes.remove(lane)
                        lane.error = TimeoutError("fleet window leader never answered")
                        return None
                # drained: the leader OWNS this lane; forking a solo solve
                # now would run the same scheduler twice at once
                if not lane.done.wait(_RESULT_WAIT_CAP_SECONDS):
                    lane.error = TimeoutError("fleet window leader never answered")
                    return None
            if lane.error is not None:
                return None
            return lane.result
        window.full.wait(self.window_seconds)
        with self._lock:
            if self._open.get(key) is window:
                del self._open[key]
            window.drained = True
            lanes = list(window.lanes)
        try:
            if len(lanes) == 1:
                return None  # no sibling arrived: the solo path
            self._run_window(lanes)
        except BaseException as e:
            for l in lanes:
                if l.result is None and l.error is None:
                    aborted = RuntimeError(f"fleet window aborted: {type(e).__name__}")
                    l.error = e if isinstance(e, Exception) else aborted
            raise
        finally:
            for l in lanes:
                if l is not lane:
                    l.done.set()
        if lane.error is not None:
            return None
        return lane.result

    # -- the coalesced multi-round solve ---------------------------------

    def _run_window(self, lanes: list[_Lane]) -> None:
        """Drive every lane's requeue rounds through shared dispatches:
        the solo scan loop of `TorchScheduler.solve` replicated per lane,
        with the same per-round pending sets, stall rule, deadline and
        overflow handling. The pod axis stays at the window's initial
        pow-2 rung P0 for every round."""
        tb = lanes[0].tb
        relax = lanes[0].relax
        P0 = max(_pow2(len(l.order)) for l in lanes)
        phases = {"init": 0.0, "gather": 0.0, "stack": 0.0, "launch": 0.0, "fetch": 0.0, "commit": 0.0}
        rounds = 0
        t = time.monotonic()
        for l in lanes:
            l.lanes_in_window = len(lanes)
            try:
                l.st = l.sched._init_state(l.problem, l.N)
                l.kinds = np.full(len(l.problem.pods), K.KIND_FAIL, np.int32)
                l.slots = np.full(len(l.problem.pods), -1, np.int32)
                l.pending = list(l.order)
            except Exception as e:
                l.error = e
                l.finished = True
        phases["init"] += time.monotonic() - t
        while True:
            now = time.monotonic()
            for l in lanes:
                if not l.finished and l.deadline is not None and now > l.deadline:
                    l.timed_out = True
                    l.finished = True
            active = [l for l in lanes if not l.finished and not l.solo and l.error is None]
            if not active:
                break
            # per-lane host work is isolated: a gather failure errors that
            # lane alone and its siblings keep the round
            t = time.monotonic()
            xs_list, st_list, ok = [], [], []
            for l in active:
                try:
                    xs_list.append(self._gather(l, P0))
                    st_list.append(l.st)
                    ok.append(l)
                except Exception as e:
                    l.error = e
                    l.finished = True
            phases["gather"] += time.monotonic() - t
            if not ok:
                continue
            t = time.monotonic()
            st_b, xs_b = stack_lanes(st_list, xs_list)
            t1 = time.monotonic()
            st_b, kinds_b, slots_b, over_b, odo_b = fleet_dispatch(tb, st_b, xs_b, relax)
            t2 = time.monotonic()
            kinds_h, slots_h, over_h, odos = _fetch(kinds_b, slots_b, over_b, odo_b)
            t3 = time.monotonic()
            phases["stack"] += t1 - t
            phases["launch"] += t2 - t1
            phases["fetch"] += t3 - t2
            rounds += 1
            for i, l in enumerate(ok):
                l.rounds += 1
                _fold_odo(l.odo, odos[i])
                l.st = K.lane_slice(st_b, i)
                if over_h[i]:
                    # scan-path overflow: the solo loop restarts the whole
                    # solve at 2N; siblings keep their rounds
                    l.solo = True
                    l.finished = True
                    continue
                n = len(l.pending)
                got_kinds = kinds_h[i, :n]
                batch = np.asarray(l.pending, np.int64)
                l.kinds[batch] = got_kinds
                l.slots[batch] = slots_h[i, :n]
                round_failed = [p for p, k in zip(l.pending, got_kinds) if k == K.KIND_FAIL]
                if not round_failed or len(round_failed) == n:
                    l.finished = True  # all placed, or no progress: stall
                else:
                    l.pending = round_failed
            phases["commit"] += time.monotonic() - t3
        for l in lanes:
            l.result = None if l.error is not None or l.solo else (l.st, l.kinds, l.slots, l.timed_out, l.odo)
        self.last_window = {"lanes": len(lanes), "rounds": rounds, "P0": P0, "phases": phases}

    @staticmethod
    def _gather(l: _Lane, P0: int):
        """One lane's round PodX at the window's shared pod rung: the solo
        path's `_pod_xs_with_idx`, padded to P0 so the lanes stack (pad
        positions carry valid=False; the kernel commits nothing there)."""
        return l.sched._pod_xs_with_idx(l.problem, l.pending, pad_to=P0)[0]
