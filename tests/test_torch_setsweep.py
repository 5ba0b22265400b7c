"""The port's removal-set sweep against the JAX package's, on the CPU.

Fleets come from the reference's control plane and are carried across with
`convert.cluster` / `convert.candidates` (tests/test_torch_sweep.py's
helpers). Every comparison is exact:

- `SetSweepContext.evaluate` gives the reference's verdicts and odometer
  steps on `SetProposer.first_round()` and one `neighborhood()` round, on
  the set-parity fleets of tests/test_setsweep.py, a 9-node fleet (its
  existing slots padded to 16) and the pinned fleet where only a
  non-prefix set wins;
- the plain K8 (`set_sweep_plain`) equals the reference's
  `_set_sweep_kernel` on the reference context's inputs;
- `SetProposer`, `savings_estimate` and `_prefix_len` are the reference's;
- on the c0 fleet (`fixtures.underutilized_world(..., heavy_every=3)`,
  chip_smoke.py's fleet whose lanes' first leftover class differs), the
  plain K6 and K8 equal the reference's `_fast_sweep_kernel` and
  `_set_sweep_kernel`, leftovers included;
- every SweepUnsupported gate of `SetSweepContext.build` / `evaluate`
  fires on the same crafted case.
"""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu import jaxsetup
from karpenter_tpu import tracing
from karpenter_tpu.api import labels as well_known
from karpenter_tpu.api.objects import Budget, LabelSelector, PodAffinityTerm, PodPhase
from karpenter_tpu.cloudprovider.kwok import construct_instance_types
from karpenter_tpu.controllers.disruption import setsweep as rset
from karpenter_tpu.controllers.disruption import sweep as rsweep
from karpenter_tpu.controllers.disruption.types import POD_DELETION_COST_ANNOTATION
from karpenter_tpu.controllers.kube import FakeClock
from karpenter_tpu.controllers.operator import Operator
from karpenter_tpu.solver import tpu_problem as rtp
from karpenter_tpu.testing import fixtures
from karpenter_tpu.utils import resources as rres
from karpenter_tpu_torch import convert
from karpenter_tpu_torch.controllers.disruption import setsweep as pset
from karpenter_tpu_torch.controllers.disruption import sweep as psweep
from karpenter_tpu_torch.solver import tpu_problem as ptp
from karpenter_tpu_torch.utils import resources as pres
from karpenter_tpu_torch.testing import fixtures as pfixtures
from test_torch_sweep import EDGE_FLEETS, MATRIX_FLEETS, _fleet_multiset, fleet_op, fleet_sides, port_sweep, ref_sweep, sides


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compile_cache():
    """The reference side compiles without the persistent XLA cache (its
    cache writes have crashed workers); the setting is restored after."""
    old = os.environ.get("KARPENTER_COMPILATION_CACHE_DIR")
    os.environ["KARPENTER_COMPILATION_CACHE_DIR"] = ""
    jaxsetup.ensure_compilation_cache()
    yield
    if old is None:
        del os.environ["KARPENTER_COMPILATION_CACHE_DIR"]
    else:
        os.environ["KARPENTER_COMPILATION_CACHE_DIR"] = old
    jaxsetup.ensure_compilation_cache()


def pinned_op():
    """tests/test_setsweep.py's pinned fleet: three candidates where the
    best removal set is not a prefix (c0, a cheap 4-cpu node, sorts first;
    the two 16-cpu nodes' riders fit c0's slack)."""
    op = Operator(clock=FakeClock(), force_oracle=True)
    op.raw_cloud.types = construct_instance_types(sizes=[4, 16])
    op.raw_cloud._by_name = {it.name: it for it in op.raw_cloud.types}
    fixtures.reset_rng(5)
    op.kube.create("NodePool", fixtures.node_pool(name="default", budgets=[Budget(nodes="100%")]))
    for i, cpu in enumerate(["2500m", "9", "9"]):
        op.kube.create(
            "Pod",
            fixtures.pod(
                name=f"seed-{i}",
                labels={"fleet": "seed"},
                requests={"cpu": cpu, "memory": "512Mi"},
                pod_anti_requirements=[
                    PodAffinityTerm(
                        topology_key=well_known.HOSTNAME_LABEL_KEY,
                        label_selector=LabelSelector(match_labels={"fleet": "seed"}),
                    )
                ],
            ),
        )
    assert op.run_until_settled(max_ticks=60, advance_seconds=2.0) < 60
    riders = [("1200m", None), ("1", "134217728"), ("1", "134217728")]
    for i, (cpu, cost) in enumerate(riders):
        node_name = op.kube.get("Pod", f"seed-{i}").node_name
        op.kube.delete("Pod", f"seed-{i}")
        r = fixtures.pod(name=f"rider-{i}", labels={"fleet": "rider"}, requests={"cpu": cpu, "memory": "128Mi"})
        if cost:
            r.metadata.annotations[POD_DELETION_COST_ANNOTATION] = cost
        r.node_name = node_name
        r.phase = PodPhase.RUNNING
        op.kube.create("Pod", r)
    op.clock.advance(26.0)
    op.pod_events.reconcile_all()
    op.claim_conditions.reconcile_all()
    return op


def _contexts(ref, port):
    rctx = rset.SetSweepContext.build(ref.kube, ref.cluster, ref.cloud, ref.cands, ref.opts)
    pctx = pset.SetSweepContext.build(port.kube, port.cluster, port.cloud, port.cands, device="cpu")
    return rctx, pctx


def _evaluate_both(rctx, pctx, batch):
    tr = tracing.new_trace("setsweep")
    want = rctx.evaluate(batch, trace=tr)
    got = pctx.evaluate(batch)
    assert np.array_equal(got, want)
    assert psweep.last_sweep["steps"] == tr.counts["kernel_iterations"]
    assert psweep.last_sweep["lanes"] == len(batch)
    return want


def _kernel_matches(rctx, batch):
    """The plain K8 on the reference context's own inputs."""
    Bp = rtp._pow2(len(batch), floor=rset.LANE_BUCKET_FLOOR)
    Jp = int(rctx.percand_counts.shape[0])
    member = np.zeros((Bp, Jp), np.int32)
    member[: len(batch), : rctx.n_candidates] = batch
    want_feas, want_steps = jax.device_get(rctx._dispatch(jax.numpy.asarray(member)))
    t = lambda a: torch.from_numpy(np.array(a))
    got_feas, got_steps = pset.set_sweep_plain(
        convert.tables(jax.device_get(rctx.tb)), convert.state(jax.device_get(rctx.base_st)),
        convert.pod_x(jax.device_get(rctx.x_row)), t(rctx.avail0), t(rctx.slot_cand), t(member),
        t(rctx.base_counts), t(rctx.percand_counts), t(rctx.sizes),
    )
    assert np.array_equal(got_feas.numpy(), np.asarray(want_feas))
    assert got_steps == int(want_steps)


@pytest.mark.parametrize(
    "fleet", [f + ("128Mi",) for f in MATRIX_FLEETS] + [EDGE_FLEETS[1], "pinned"],
    ids=[f"seed{f[0]}-n{f[1]}" for f in MATRIX_FLEETS] + ["seed21-n9-padded", "pinned-non-prefix"],
)
def test_set_sweep_matches_reference(fleet):
    if fleet == "pinned":
        ref, port = sides(pinned_op())
        seed = 5
    else:
        ref, port = fleet_sides(fleet)
        seed = fleet[0]
    rctx, pctx = _contexts(ref, port)
    rprop, pprop = rset.SetProposer(ref.cands, seed=seed), pset.SetProposer(port.cands, seed=seed)
    batch = rprop.first_round()
    assert np.array_equal(pprop.first_round(), batch)
    feas = _evaluate_both(rctx, pctx, batch)
    assert np.array_equal(pctx.savings_estimate(batch), rctx.savings_estimate(batch))
    assert [pset._prefix_len(r) for r in batch] == [rset._prefix_len(r) for r in batch]
    ests = rctx.savings_estimate(batch)
    best = batch[int(np.argmax(np.where(feas, ests, -1.0)))]
    nbhd = rprop.neighborhood(best)
    assert np.array_equal(pprop.neighborhood(best), nbhd)
    if len(nbhd):
        _evaluate_both(rctx, pctx, nbhd)
    _kernel_matches(rctx, batch)
    if fleet == "pinned":
        # the winning non-prefix set {c1, c2} is feasible on both sides
        assert pctx.evaluate(np.array([[False, True, True]]))[0]


# ---------------------------------------------------------------------------
# the c0 fleet: lanes whose first leftover class differs

C0_RIDER = {"cpu": "700m", "memory": "512Mi"}
C0_HEAVY = {"cpu": "1000", "memory": "1Gi"}


def c0_op(n: int):
    """`fixtures.underutilized_world(n, rider_requests=C0_RIDER,
    heavy_every=3, heavy_requests=C0_HEAVY)` through the reference's control
    plane: riders as large as the seeds (no node has room for a removed
    one), and on every third node a bound pod that asks more cpu than any
    type has in place of its rider. A lane that removes a heavy node
    leaves the heavy class first, which no template fits; a lane that
    removes only rider nodes leaves the rider class first."""
    op = fixtures.underutilized_operator(n, seed=7, rider_requests=C0_RIDER, force_oracle=True)
    for i in range(1, n, 3):
        node_name = op.kube.get("Pod", f"rider-{i}").node_name
        op.kube.delete("Pod", f"rider-{i}")
        heavy = fixtures.pod(name=f"heavy-{i}", labels={"fleet": "heavy"}, requests=C0_HEAVY)
        heavy.node_name = node_name
        heavy.phase = PodPhase.RUNNING
        op.kube.create("Pod", heavy)
    op.clock.advance(30.0)
    op.pod_events.reconcile_all()
    op.claim_conditions.reconcile_all()
    return op


def _first_left(left) -> list:
    """Each lane's first leftover class (0 when none, as the kernels take)."""
    return [int(c) for c in (left > 0).to(torch.int32).argmax(dim=1).tolist()]


def test_c0_fleet_kernels_match_reference(monkeypatch):
    n = 9
    op = c0_op(n)
    w = pfixtures.underutilized_world(n, seed=7, rider_requests=C0_RIDER, heavy_every=3, heavy_requests=C0_HEAVY)
    assert _fleet_multiset(w.kube) == _fleet_multiset(op.kube)  # one fleet, built by either side
    ref, port = sides(op, limit=n)
    t = lambda a: torch.from_numpy(np.array(a))

    # K6: the verdicts on both sides, then the plain K6 on the reference's inputs
    captured = []
    real = jax.jit(rsweep._fast_sweep_kernel, static_argnames=("singleton",))

    def spy(*args, singleton=False):
        out = real(*args, singleton=singleton)
        captured.append((jax.device_get(args), singleton, jax.device_get(out)))
        return out

    monkeypatch.setattr(rsweep, "_fast_sweep_cached", spy)
    for singleton in (False, True):
        want, want_steps = ref_sweep(ref, singleton)
        got, got_steps = port_sweep(port, singleton)
        assert psweep.last_sweep["path"] == "sweep_fast"
        assert got == want and got_steps == want_steps
    assert len(captured) == 2
    for (tb, st, x, avail0, cand_idx, counts, sizes), singleton, (feas, steps) in captured:
        got_feas, got_steps, left = psweep.fast_sweep_plain(
            convert.tables(tb), convert.state(st), convert.pod_x(x), t(avail0), t(cand_idx), t(counts), t(sizes),
            singleton=singleton, with_left=True,
        )
        assert np.array_equal(got_feas.numpy(), np.asarray(feas)) and got_steps == int(steps)
        c0 = _first_left(left[: len(ref.cands)])
        assert set(c0) == {0, 1}, (singleton, c0)  # the heavy class first in some lanes, the riders' in others
        feas_c0 = [bool(f) for f, c in zip(np.asarray(feas), c0)]
        # the heavy class fits no template, the riders' one does: the
        # first leftover class decides
        assert not any(f for f, c in zip(feas_c0, c0) if c == 0) and any(f for f, c in zip(feas_c0, c0) if c == 1)

    # K8 on the proposer's first round
    rctx, pctx = _contexts(ref, port)
    batch = rset.SetProposer(ref.cands, seed=7).first_round()
    _evaluate_both(rctx, pctx, batch)
    Bp = rtp._pow2(len(batch), floor=rset.LANE_BUCKET_FLOOR)
    member = np.zeros((Bp, int(rctx.percand_counts.shape[0])), np.int32)
    member[: len(batch), : rctx.n_candidates] = batch
    want_feas, want_steps = jax.device_get(rctx._dispatch(jax.numpy.asarray(member)))
    got_feas, got_steps, left = pset.set_sweep_plain(
        convert.tables(jax.device_get(rctx.tb)), convert.state(jax.device_get(rctx.base_st)),
        convert.pod_x(jax.device_get(rctx.x_row)), t(rctx.avail0), t(rctx.slot_cand), t(member),
        t(rctx.base_counts), t(rctx.percand_counts), t(rctx.sizes), with_left=True,
    )
    assert np.array_equal(got_feas.numpy(), np.asarray(want_feas)) and got_steps == int(want_steps)
    c0 = _first_left(left[: len(batch)])
    assert set(c0) == {0, 1}, c0


# ---------------------------------------------------------------------------
# gates


def _side_mods(ref, port):
    ref.mod = SimpleNamespace(set=rset, sweep=rsweep, tp=rtp, res=rres)
    port.mod = SimpleNamespace(set=pset, sweep=psweep, tp=ptp, res=pres)


def _build(side):
    if side.mod.set is rset:
        return rset.SetSweepContext.build(side.kube, side.cluster, side.cloud, side.cands, side.opts)
    return pset.SetSweepContext.build(side.kube, side.cluster, side.cloud, side.cands, device="cpu")


def _gate_no_candidates(side, monkeypatch):
    side.cands = []
    return "no candidates", _build


def _gate_nodepool_limits(side, monkeypatch):
    np_ = side.kube.list("NodePool")[0]
    np_.limits = side.mod.res.parse_list({"cpu": "1000"})
    side.kube.update("NodePool", np_)
    return "nodepool limits", _build


def _gate_int32_overflow(side, monkeypatch):
    orig = side.mod.tp.group_class_counts

    def inflated(ordered_cls, class_seq, group, n_groups):
        base, M = orig(ordered_cls, class_seq, group, n_groups)
        return base + (1 << 28), M

    monkeypatch.setattr(side.mod.tp, "group_class_counts", inflated)
    return "exceed int32", _build


def _gate_capacity_cumsum(side, monkeypatch):
    monkeypatch.setattr(side.mod.set, "capacity_cumsum_fits_int32", lambda eavail, sizes: False)
    return "capacity cumsum exceeds int32", _build


def _gate_max_set_lanes(side, monkeypatch):
    ctx = _build(side)
    over = np.ones((side.mod.set.MAX_SET_LANES + 1, len(side.cands)), bool)
    return "set lanes >", lambda s: ctx.evaluate(over)


GATES = {
    "no-candidates": _gate_no_candidates,
    "nodepool-limits": _gate_nodepool_limits,
    "int32-overflow": _gate_int32_overflow,
    "capacity-cumsum": _gate_capacity_cumsum,
    "max-set-lanes": _gate_max_set_lanes,
}


@pytest.mark.parametrize("case", sorted(GATES), ids=sorted(GATES))
def test_set_gates_match_reference(case, monkeypatch):
    ref, port = sides(fleet_op(21, 5, [2, 32], "100m", "700m"))
    _side_mods(ref, port)
    for side in (ref, port):
        match, call = GATES[case](side, monkeypatch)
        with pytest.raises((rsweep.SweepUnsupported, psweep.SweepUnsupported), match=match) as info:
            call(side)
        assert isinstance(info.value, side.mod.sweep.SweepUnsupported)


def test_fast_shape_gate_matches_reference():
    """A rider with hostname anti-affinity puts topology among the union
    pods: both sides refuse the set sweep."""
    op = fleet_op(21, 5, [2, 32], "100m", "700m")
    rider = next(p for p in op.kube.list("Pod") if p.name.startswith("rider-"))
    rider.pod_anti_affinity = [
        PodAffinityTerm(
            topology_key=well_known.HOSTNAME_LABEL_KEY,
            label_selector=LabelSelector(match_labels={"fleet": "rider"}),
        )
    ]
    op.kube.update("Pod", rider)
    ref, port = sides(op)
    _side_mods(ref, port)
    for side in (ref, port):
        with pytest.raises((rsweep.SweepUnsupported, psweep.SweepUnsupported), match="set sweep needs the fast shape"):
            _build(side)
