"""Removal-set consolidation: batched feasibility over arbitrary
node-removal sets.

A port of the reference's `controllers/disruption/setsweep.py`. The prefix
sweep (sweep.py) batches only contiguous prefixes of the cost-sorted
candidate list; here each lane carries an arbitrary membership row
M[b, J] over the candidates:

- the disabled-slot mask is a gather through the slot -> candidate index
  (sentinel J for slots that are not candidates): removed[b, e] =
  M[b, slot_cand[e]];
- the lane's valid pods per class are counts[b] = base + M[b] @ P, where
  P[j, c] counts candidate j's reschedulable pods of class c;
- then the shared class-cumsum FFD core and the <= 1-new-claim check
  (sweep.ffd_feasibility_core_plain) score every lane at once.

The int64 guard argument is the reference's: every per-lane count is a sum
of non-negative per-candidate contributions, so the all-candidates mask
dominates every row, and `SetSweepContext.build` checks that worst case
once on the host before anything rides the int32 device path.

K8 `set_sweep` (csrc/set_sweep.cu with csrc/sweep_core.cuh).
  Replaces: karpenter_tpu/controllers/disruption/setsweep.py:100
  `_set_sweep_kernel` (with the shared core, sweep.py:82).
  Bound on an H100: bytes, the lanes' [E, R] availability read and
  rewritten once per class. The design: K6's two launches; the lane
  launch first derives its removed slots from the membership row and its
  class counts as an exact integer reduction over J (torch has no CUDA
  int32 matmul, and a float product must not stand in for a count).

`sweep_sets` is MultiNodeConsolidation's "sets" rung: bounded
proposal -> feasibility -> reseed rounds, one K8 launch each, under the
multi-node timeout; the winner is materialized through the real
compute_consolidation, feasible prefixes walked largest-first as a
backstop, so its savings are never below the prefix search's. The port has
no tracing yet: `last_search_stats` keeps the last search's counters.
"""

from __future__ import annotations

import numpy as np
import torch

from karpenter_tpu_torch.controllers.disruption.sweep import (
    SweepUnsupported,
    build_union,
    capacity_cumsum_fits_int32,
    fast_gate_reason,
    ffd_feasibility_core_plain,
    launch_sweep,
    last_sweep,
    _lane_avail,
    _row0,
)
from karpenter_tpu_torch.controllers.disruption.types import Candidate, Command, command_savings
from karpenter_tpu_torch.solver import tpu_problem as tp
from karpenter_tpu_torch.solver import tpu_runs as KR

# lane cap for one device dispatch; proposals beyond it queue for the
# next round
MAX_SET_LANES = 4096
# proposal->feasibility->reseed rounds per sweep (each is one dispatch)
MAX_SET_ROUNDS = 6
# top-ranked non-prefix sets materialized through compute_consolidation
# (the prefix backstop walk rides separately); each materialization is
# one exact simulation
MATERIALIZE_TRIES = 6
# lane-count bucket floor: rounds of different sizes pad to the same
# pow-2 lane counts
LANE_BUCKET_FLOOR = 64

# sweep_sets overwrites this with the last search's round, lane and
# materialization counters
last_search_stats: dict = {}

# launches of K8 (one per set_sweep call on the card)
LAUNCHES = {"set_sweep": 0}


def set_sweep_plain(tb, st, x, avail0, slot_cand, member, base_counts, percand_counts, sizes, with_left=False):
    """The reference's `_set_sweep_kernel` for one pod row `x`:
    (feasible [B] bool, steps) for membership rows `member` [B, J] (int32
    0/1), and the leftovers [B, C] with `with_left`. slot_cand [E] maps
    existing slots to candidates (J = not a candidate); percand_counts
    [J, C] is P; base_counts [C] counts the pods valid in every lane."""
    rc = KR._build_cache(tb, st, x)
    B, J = member.shape
    # a zero column so the sentinel J gathers "never removed"
    member_pad = torch.cat([member, torch.zeros((B, 1), dtype=member.dtype, device=member.device)], dim=1)
    removed = member_pad[:, slot_cand.clamp(0, J).long()] > 0  # [B, E]
    # an exact integer product (0/1 x small counts; the host guards bound it)
    counts = base_counts[None, :] + (member[:, :, None] * percand_counts[None]).sum(dim=1, dtype=torch.int32)
    return ffd_feasibility_core_plain(tb, rc, _lane_avail(avail0, removed), counts, sizes, with_left)


def set_sweep(tb, st, xs, avail0, slot_cand, member, base_counts, percand_counts, sizes, with_left=False):
    """(feasible [B] bool, steps) of the removal-set sweep for the pod in
    row 0 of the batch `xs`, and the leftovers [B, C] with `with_left`.
    CPU tensors take the plain version; CUDA tensors launch K8."""
    if st.rank.device.type == "cpu":
        return set_sweep_plain(
            tb, st, _row0(xs), avail0, slot_cand, member, base_counts, percand_counts, sizes, with_left
        )
    B, J = member.shape
    if tuple(percand_counts.shape) != (J, sizes.shape[0]) or tuple(base_counts.shape) != (sizes.shape[0],):
        raise ValueError(
            f"set_sweep: member {tuple(member.shape)}, P {tuple(percand_counts.shape)}, "
            f"base {tuple(base_counts.shape)} and sizes {tuple(sizes.shape)} disagree"
        )
    lanes = {"slot_cand": slot_cand, "member": member, "base_counts": base_counts, "percand": percand_counts}
    out = launch_sweep("set_sweep", tb, st, xs, avail0, sizes, B, lanes, with_left, J=J)
    LAUNCHES["set_sweep"] += 1
    return out


class SetSweepContext:
    """Built once per consolidation pass: the union problem, the device
    tables (uploaded once) and the per-candidate class-count matrix.
    evaluate() then scores any batch of removal sets in one dispatch."""

    def __init__(
        self, candidates, sched, tb, base_st, xs1, avail0, slot_cand, base_counts, percand_counts, sizes,
        trivial: bool,
    ):
        self.candidates = candidates
        self.sched = sched
        self.tb = tb
        self.base_st = base_st
        self.xs1 = xs1  # the representative pod in row 0
        self.avail0 = avail0
        self.slot_cand = slot_cand
        self.base_counts = base_counts
        self.percand_counts = percand_counts
        self.sizes = sizes
        self.trivial = trivial  # no union pods: every set feasible
        self.n_candidates = len(candidates)
        # unknown prices ride as MAX_FLOAT (helpers.py _candidate_price);
        # rank them as 0 — unknown is not infinitely valuable
        from karpenter_tpu_torch.cloudprovider.types import MAX_FLOAT

        raw = np.array([c.price for c in candidates], np.float64)
        self.prices = np.where(raw >= MAX_FLOAT, 0.0, raw)

    @classmethod
    def build(cls, kube, cluster, cloud_provider, candidates: list[Candidate], options=None, device=None):
        """Union gates + set-kernel gates + int64 guards + one table
        upload. Raises SweepUnsupported when the set kernel cannot express
        the shape."""
        if not candidates:
            raise SweepUnsupported("no candidates for set sweep")
        u = build_union(kube, cluster, cloud_provider, candidates, options, device=device)
        p = u.problem
        reason = fast_gate_reason(p)
        if reason is not None:
            # there is no full-state fallback for arbitrary sets: the
            # caller falls down its ladder instead
            raise SweepUnsupported(f"set sweep needs the fast shape: {reason}")

        J = len(candidates)
        order_arr = np.asarray(u.order, dtype=np.int64)
        ordered_cls = p.pod_class[order_arr]
        if len(ordered_cls) == 0:
            return cls(candidates, u.sched, u.tb, u.base, None, None, None, None, None, None, trivial=True)
        class_seq = tp.contiguous_class_seq(ordered_cls)
        if class_seq is None:
            raise SweepUnsupported("encode classes not contiguous in FFD order (sig collision)")
        pp = np.asarray(u.pod_prefix)[order_arr]
        base, P = tp.group_class_counts(ordered_cls, class_seq, pp, J)
        sizes = p.prequests_c[class_seq].astype(np.int32)
        C = len(class_seq)

        # int64 guards: the all-candidates mask dominates every membership
        # row; the capacity cumsum bound is lane-independent
        full = base + P.sum(axis=0)  # [C] int64, M = all-ones row
        worst_tot = full @ sizes.astype(np.int64)
        if (worst_tot >= (1 << 30)).any():
            raise SweepUnsupported("worst-case removal-set totals exceed int32")
        if not capacity_cumsum_fits_int32(p.eavail, sizes):
            raise SweepUnsupported("per-class capacity cumsum exceeds int32")

        # J padded to a pow-2 bucket (padded candidates have zero P rows and
        # no slots, so their membership bits are inert)
        Jp = tp._pow2(J, floor=8)
        P_pad = np.zeros((Jp, C), np.int64)
        P_pad[:J] = P
        slot_cand = np.full(p.num_existing, Jp, np.int32)
        for j, c in enumerate(candidates):
            slot_cand[u.view_slot[c.name]] = j

        rep_i = p.class_reps[int(p.rclass_creps[0])]
        xs1 = u.sched._pod_xs(p, [rep_i])
        t = u.sched._t
        return cls(
            candidates, u.sched, u.tb, u.base, xs1, t(p.eavail), t(slot_cand),
            t(base.astype(np.int32)), t(P_pad.astype(np.int32)), t(sizes), trivial=False,
        )

    def evaluate(self, member: np.ndarray) -> np.ndarray:
        """feasible[B] for a [B, J] boolean/0-1 membership batch, in one
        dispatch (see kernel_args for the padding)."""
        member = np.asarray(member)
        if member.ndim != 2 or member.shape[1] != self.n_candidates:
            raise ValueError(f"member must be [B, {self.n_candidates}], got {member.shape}")
        B = member.shape[0]
        if B == 0:
            return np.zeros(0, bool)
        if B > MAX_SET_LANES:
            raise SweepUnsupported(f"{B} set lanes > {MAX_SET_LANES}")
        if self.trivial:
            return np.ones(B, bool)
        out, steps = set_sweep(*self.kernel_args(member))
        last_sweep.clear()
        last_sweep.update(path="setsweep", lanes=B, steps=int(steps))
        return out.cpu().numpy()[:B].astype(bool)

    def kernel_args(self, member: np.ndarray) -> tuple:
        """K8's arguments for a [B, J] membership batch: the rows padded to
        a pow-2 lane bucket (floor LANE_BUCKET_FLOOR) and the candidate
        axis to the context's J bucket, as an int32 tensor on the device."""
        B = member.shape[0]
        Bp = tp._pow2(B, floor=LANE_BUCKET_FLOOR)
        Jp = int(self.percand_counts.shape[0])
        padded = np.zeros((Bp, Jp), np.int32)
        padded[:B, : self.n_candidates] = member.astype(np.int32)
        return (
            self.tb, self.base_st, self.xs1, self.avail0, self.slot_cand, self.sched._t(padded),
            self.base_counts, self.percand_counts, self.sizes,
        )

    def savings_estimate(self, member: np.ndarray) -> np.ndarray:
        """[B] — the sum of removed candidate prices per lane: the
        materialization ranking key (an upper bound on real savings)."""
        return np.asarray(member, np.float64) @ self.prices


class SetProposer:
    """Bounded removal-set proposal generator. Round 0 strictly subsumes
    the prefix sweep (every prefix is a lane) and adds per-nodepool
    prefixes plus seeded random sets; reseed rounds explore leave-one-out
    / add-one / swap neighborhoods of the best known set. Deduplicates
    across rounds so a scored set is never dispatched again."""

    def __init__(self, candidates: list[Candidate], seed: int = 0, max_lanes: int = MAX_SET_LANES):
        self.J = len(candidates)
        self.pools = [c.nodepool_name for c in candidates]
        self.rng = np.random.default_rng(seed)
        self.max_lanes = max_lanes
        self._seen: set[bytes] = set()

    def _dedup(self, rows: np.ndarray) -> np.ndarray:
        out: list[np.ndarray] = []
        for r in np.asarray(rows, bool).reshape(-1, self.J):
            if not r.any():
                continue  # the empty set is a no-op by definition
            key = np.packbits(r).tobytes()
            if key in self._seen:
                continue
            self._seen.add(key)
            out.append(r)
            if len(out) >= self.max_lanes:
                break
        return np.asarray(out, bool).reshape(len(out), self.J)

    def _random(self, n: int) -> np.ndarray:
        # densities spread over (0, 1): small sets and near-full sets both
        # get sampled
        dens = self.rng.uniform(0.1, 0.9, size=(n, 1))
        return self.rng.random((n, self.J)) < dens

    def first_round(self) -> np.ndarray:
        J = self.J
        rows = [np.tril(np.ones((J, J), bool))]  # lane k = candidates[:k+1]
        for pool in sorted(set(self.pools)):
            idx = [j for j, pl in enumerate(self.pools) if pl == pool]
            m = np.zeros((len(idx), J), bool)
            for k in range(len(idx)):
                m[k, idx[: k + 1]] = True
            rows.append(m)
        rows.append(self._random(max(2 * J, 16)))
        return self._dedup(np.concatenate(rows, axis=0))

    def neighborhood(self, best: np.ndarray) -> np.ndarray:
        """Local moves around the best known set, plus fresh random sets
        so the search never stalls in a one-move basin."""
        best = np.asarray(best, bool)
        rows: list[np.ndarray] = []
        members = np.flatnonzero(best)
        outside = np.flatnonzero(~best)
        for j in members:  # leave-one-out
            r = best.copy()
            r[j] = False
            rows.append(r)
        for j in outside:  # add-one
            r = best.copy()
            r[j] = True
            rows.append(r)
        if len(members) and len(outside):  # swaps (sampled)
            for _ in range(min(64, len(members) * len(outside))):
                r = best.copy()
                r[self.rng.choice(members)] = False
                r[self.rng.choice(outside)] = True
                rows.append(r)
        rows.append(self._random(max(self.J, 8)))
        return self._dedup(np.concatenate([np.atleast_2d(r) for r in rows], axis=0))


def _prefix_len(mask: np.ndarray) -> int:
    """k if mask is exactly candidates[:k], else 0."""
    k = int(mask.sum())
    return k if k and bool(mask[:k].all()) else 0


def sweep_sets(consolidation, candidates: list[Candidate]) -> Command:
    """MultiNodeConsolidation's sweep="sets" search: bounded
    proposal->batched-feasibility->reseed rounds under the multi-node
    timeout, then the winners materialized through the real
    compute_consolidation path (feasible prefixes walked largest-first as
    a backstop, the prefix sweep's own rule, so the result's savings are
    >= the prefix search's on every supported shape). Raises
    SweepUnsupported when the set kernel cannot express the problem."""
    ctx = SetSweepContext.build(
        consolidation.kube,
        consolidation.cluster,
        consolidation.cloud,
        candidates,
        consolidation.opts,
        device=consolidation.device,
    )
    clock = consolidation.clock
    deadline = clock.now() + consolidation.opts.multinode_consolidation_timeout_seconds
    proposer = SetProposer(candidates, seed=len(candidates))
    feasible_masks: list[np.ndarray] = []
    best_mask = None
    best_est = -1.0
    batch = proposer.first_round()
    rounds = 0
    lanes = 0
    while len(batch) and rounds < MAX_SET_ROUNDS and clock.now() <= deadline:
        feas = ctx.evaluate(batch)
        rounds += 1
        lanes += len(batch)
        ests = ctx.savings_estimate(batch)
        improved = False
        for r, ok, est in zip(batch, feas, ests):
            if not ok:
                continue
            feasible_masks.append(r)
            if est > best_est + 1e-12:
                best_mask, best_est = r, float(est)
                improved = True
        if not improved or best_mask is None:
            break
        batch = proposer.neighborhood(best_mask)

    # ---- materialize ----
    # Kernel feasibility is schedulability; compute_consolidation also
    # applies the price and spot-to-spot rules, so a feasible set can still
    # materialize to a no-op. Two passes:
    best_cmd = Command(reason=consolidation.reason)
    best_savings = 0.0

    # 1) prefix backstop: feasible prefix lengths largest-first until one
    #    materializes, exactly the prefix sweep's rule (sweep.sweep_first_n)
    feasible_ks = sorted({k for k in (_prefix_len(r) for r in feasible_masks) if k}, reverse=True)
    for k in feasible_ks:
        cmd = consolidation.compute_consolidation(candidates[:k])
        if cmd.candidates:
            best_cmd, best_savings = cmd, command_savings(cmd)
            break

    # 2) top non-prefix sets by estimated savings (price sum, an upper
    #    bound that ignores replacement cost), ties toward larger sets
    ranked = sorted(
        (r for r in feasible_masks if not _prefix_len(r)),
        key=lambda r: (-float(ctx.savings_estimate(r[None])[0]), -int(r.sum())),
    )
    for r in ranked[:MATERIALIZE_TRIES]:
        if clock.now() > deadline and best_cmd.candidates:
            break
        subset = [c for j, c in enumerate(candidates) if r[j]]
        cmd = consolidation.compute_consolidation(subset)
        if not cmd.candidates:
            continue
        s = command_savings(cmd)
        if s > best_savings + 1e-12 or (
            abs(s - best_savings) <= 1e-12 and len(cmd.candidates) > len(best_cmd.candidates)
        ):
            best_cmd, best_savings = cmd, s

    last_search_stats.clear()
    last_search_stats.update(
        rounds=rounds,
        lanes_evaluated=lanes,
        feasible_sets=len(feasible_masks),
        winner_nodes=len(best_cmd.candidates),
        winner_savings_per_hour=best_savings,
    )
    return best_cmd
