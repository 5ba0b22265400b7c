"""The port's consolidation prefix sweeps against the JAX package's, on the
CPU.

Each fleet is built by the reference's control plane
(`fixtures.underutilized_operator(..., force_oracle=True)`) and carried
across with `convert.cluster` / `convert.candidates`, so both sides sweep
the same cluster. Every comparison is exact:

- (a) `build_union`'s tables, base state, FFD order, lane prefixes and
  slot map equal the reference's;
- (b) `prefix_feasibility` / `singleton_feasibility` verdicts and odometer
  steps equal the reference's on the fast path for the set-parity fleets
  of tests/test_setsweep.py, the partial-feasibility fleet of
  tests/test_disruption.py and two fleets on the existing-slot bucket's
  edges (8 and 9 nodes), and on the full-state lane path forced as
  test_disruption.py forces it (`_fast_prefix_feasibility` returning None);
- (c) at kernel level, the plain K6 (`fast_sweep_plain`) and K7
  (`scan_lanes_plain`) equal the reference's `_fast_sweep_kernel` and
  `vmap(solve_scan)` on the inputs the reference built;
- (d) the port's referee, `helpers.simulate_scheduling(force_oracle=True)`,
  gives the reference's results snapshot per prefix, and its default path
  (the kernels through TorchHybridScheduler) the reference's default path's;
- (e) `fixtures.underutilized_world` builds the reference operator's fleet;
- (f) every SweepUnsupported gate the reference raises on a crafted case
  is raised by the port.
"""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu import jaxsetup
from karpenter_tpu.api import labels as well_known
from karpenter_tpu.api import objects as robjects
from karpenter_tpu.api.codec import to_jsonable
from karpenter_tpu.controllers.disruption import sweep as rsweep
from karpenter_tpu.controllers.disruption.consolidation import MultiNodeConsolidation
from karpenter_tpu.controllers.disruption.helpers import simulate_scheduling as r_simulate
from karpenter_tpu.options import Options as ROptions
from karpenter_tpu.testing import fixtures, fuzz
from karpenter_tpu.utils import resources as rres
from karpenter_tpu_torch import convert
from karpenter_tpu_torch.api import objects as pobjects
from karpenter_tpu_torch.controllers.disruption import sweep as psweep
from karpenter_tpu_torch.controllers.disruption.helpers import simulate_scheduling as p_simulate
from karpenter_tpu_torch.options import Options as POptions
from karpenter_tpu_torch.solver import tpu_kernel as PK
from karpenter_tpu_torch.testing import fixtures as pfixtures
from karpenter_tpu_torch.utils import resources as pres

# (rng seed, nodes, instance sizes, rider cpu, seed cpu): the set-parity
# matrix of tests/test_setsweep.py
MATRIX_FLEETS = [
    (21, 6, [2, 32], "100m", "700m"),
    (11, 6, [2, 32], "1200m", "1500m"),
    (3, 6, [4, 16], "700m", "900m"),
    (7, 5, [2, 8, 32], "400m", "700m"),
    (13, 7, [2, 16], "900m", "1100m"),
    (17, 6, [4, 32], "1500m", "1800m"),
]
# tests/test_disruption.py's partial-feasibility fleet: big riders exhaust
# the keepers' free capacity, so only a strict prefix is feasible
PARTIAL_FLEET = (11, 10, None, "1200m", "1500m", "256Mi")
# the existing-slot bucket's edges: 8 nodes fill E=8, 9 pad E to 16 with
# slots that must fit nothing on every lane
EDGE_FLEETS = [(21, 8, [2, 32], "100m", "700m", "128Mi"), (21, 9, [2, 32], "100m", "700m", "128Mi")]
FLEETS = [f + ("128Mi",) for f in MATRIX_FLEETS] + [PARTIAL_FLEET] + EDGE_FLEETS
FLEET_IDS = [f"seed{f[0]}-n{f[1]}" for f in FLEETS]


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


# ---------------------------------------------------------------------------
# the two sides of one cluster


def fleet_op(seed, n, sizes, rider_cpu, seed_cpu, rider_mem="128Mi"):
    """An under-utilized fleet through the reference's control plane."""
    return fixtures.underutilized_operator(
        n,
        seed=seed,
        sizes=sizes,
        rider_requests={"cpu": rider_cpu, "memory": rider_mem},
        seed_requests={"cpu": seed_cpu, "memory": "512Mi"},
        force_oracle=True,
    )


def objects_of(op) -> list:
    """The operator's API objects as JSON-able dicts, state nodes in the
    cluster cache's order (each claim before its node)."""
    out = [to_jsonable(o) for o in op.kube.list("NodePool")]
    for ds in op.kube.list("DaemonSet"):
        out.append({"__type__": "DaemonSet", "name": ds.name, "pod_template": to_jsonable(ds.pod_template)})
    for ns in op.kube.list("Namespace"):
        out.append({"__type__": "Namespace", "name": ns.name, "labels": dict(ns.labels)})
    for sn in op.cluster.state_nodes():
        if sn.node_claim is not None:
            out.append(to_jsonable(op.kube.get("NodeClaim", sn.node_claim.name)))
        if sn.node is not None:
            out.append(to_jsonable(op.kube.get("Node", sn.node.name)))
    return out + [to_jsonable(p) for p in op.kube.list("Pod")]


def ref_candidates(op, limit=None):
    mnc = MultiNodeConsolidation(op.kube, op.cluster, op.cloud, op.clock, options=op.opts, force_oracle=True)
    return mnc.candidates()[:limit]


def sides(op, limit=None):
    """(reference side, port side) of the operator's cluster: each a
    namespace of kube, cluster, cloud and candidates (same names, same
    order)."""
    cands = ref_candidates(op, limit)
    pool = op.kube.list("NodePool")[0]
    its = [to_jsonable(it) for it in op.cloud.get_instance_types(pool)]
    w = convert.cluster(objects_of(op), its, op.clock.now())
    pc = convert.candidates(w.kube, w.cluster, w.cloud, w.clock, [c.name for c in cands])
    assert [c.name for c in pc] == [c.name for c in cands]
    ref = SimpleNamespace(kube=op.kube, cluster=op.cluster, cloud=op.cloud, cands=cands, opts=op.opts)
    port = SimpleNamespace(kube=w.kube, cluster=w.cluster, cloud=w.cloud, cands=pc, clock=w.clock)
    return ref, port


_FLEET_CACHE: dict = {}


def fleet_sides(fleet):
    """Both sides of a fleet, built once per module run (read-only use)."""
    key = repr(fleet)
    if key not in _FLEET_CACHE:
        seed, n, sizes, rider_cpu, seed_cpu, rider_mem = fleet
        _FLEET_CACHE[key] = sides(fleet_op(seed, n, sizes, rider_cpu, seed_cpu, rider_mem), limit=n)
    return _FLEET_CACHE[key]


def ref_sweep(ref, singleton=False):
    """The reference's verdicts and odometer steps (read off its trace)."""
    from karpenter_tpu import tracing

    tr = tracing.new_trace("sweep")
    out = rsweep.prefix_feasibility(ref.kube, ref.cluster, ref.cloud, ref.cands, ref.opts, singleton=singleton, trace=tr)
    return out, tr.counts.get("kernel_iterations", 0)


def port_sweep(port, singleton=False):
    out = psweep.prefix_feasibility(port.kube, port.cluster, port.cloud, port.cands, singleton=singleton, device="cpu")
    return out, psweep.last_sweep["steps"]


def assert_tree_equal(want, got, path="") -> None:
    """Reference arrays (numpy leaves) against port tensors, NamedTuples
    field by field."""
    if hasattr(got, "_fields"):
        for name in got._fields:
            assert_tree_equal(getattr(want, name), getattr(got, name), f"{path}.{name}")
        return
    w = np.asarray(want)
    if w.dtype == np.uint32:
        w = w.view(np.int32)
    g = got.cpu().numpy()
    assert w.shape == g.shape, (path, w.shape, g.shape)
    assert np.array_equal(w.astype(g.dtype), g), path


# ---------------------------------------------------------------------------
# (a) the union problem


def test_union_tensors_match_reference():
    op = fleet_op(21, 6, [2, 32], "100m", "700m")
    for i in range(3):  # pending pods of a second class valid in every lane
        op.kube.create("Pod", fixtures.pod(name=f"pending-{i}", requests={"cpu": "250m", "memory": "256Mi"}))
    ref, port = sides(op)
    ru = rsweep.build_union(ref.kube, ref.cluster, ref.cloud, ref.cands, ref.opts)
    pu = psweep.build_union(port.kube, port.cluster, port.cloud, port.cands, device="cpu")
    assert pu.order == ru.order
    assert pu.pod_prefix == ru.pod_prefix
    assert pu.view_slot == ru.view_slot
    assert [p.name for p in pu.pods] == [p.name for p in ru.pods]
    assert_tree_equal(jax.device_get(ru.tb), pu.tb, "tb")
    assert_tree_equal(jax.device_get(ru.base), pu.base, "base")
    assert psweep.fast_gate_reason(pu.problem) == rsweep.fast_gate_reason(ru.problem) is None


# ---------------------------------------------------------------------------
# (b, c) verdicts, steps and kernels


@pytest.mark.parametrize("fleet", FLEETS, ids=FLEET_IDS)
def test_fast_path_matches_reference(fleet, monkeypatch):
    ref, port = fleet_sides(fleet)
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
        assert got == want, (singleton, got, want)
        assert got_steps == want_steps
    # the plain K6 on the very inputs the reference's kernel took
    assert len(captured) == 2
    for (tb, st, x, avail0, cand_idx, counts, sizes), singleton, (feas, steps) in captured:
        t = lambda a: torch.from_numpy(np.array(a))
        got_feas, got_steps = psweep.fast_sweep_plain(
            convert.tables(tb), convert.state(st), convert.pod_x(x), t(avail0), t(cand_idx), t(counts), t(sizes),
            singleton=singleton,
        )
        assert np.array_equal(got_feas.numpy(), np.asarray(feas))
        assert got_steps == int(steps)


def test_fast_path_with_leftovers_matches_reference(monkeypatch):
    """Pending pods that fit no node are left over in every lane with the
    removed nodes' riders: the first leftover class (the pending one) and
    the one-claim fit of the leftover total decide, and the 32-core type
    hosts the pending pods and some riders only up to a prefix."""
    op = fleet_op(21, 8, [2, 32], "1200m", "1500m")
    for i in range(3):
        op.kube.create("Pod", fixtures.pod(name=f"pending-{i}", requests={"cpu": "8", "memory": "1Gi"}))
    ref, port = sides(op)
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
        assert got == want, (singleton, got, want)
        assert got_steps == want_steps
    assert True in want and False in ref_sweep(ref, False)[0]  # some prefixes fit one new claim, some do not
    for (tb, st, x, avail0, cand_idx, counts, sizes), singleton, (feas, _) in captured:
        t = lambda a: torch.from_numpy(np.array(a))
        got_feas, _, left = psweep.fast_sweep_plain(
            convert.tables(tb), convert.state(st), convert.pod_x(x), t(avail0), t(cand_idx), t(counts), t(sizes),
            singleton=singleton, with_left=True,
        )
        assert np.array_equal(got_feas.numpy(), np.asarray(feas))
        assert (left[:, 0] == 3).all()  # the pending class comes first and fits no node
        assert (left[:, 1] == 1 if singleton else left[:, 1] == torch.arange(1, left.shape[0] + 1)).all()


def _lane_inputs(args):
    """The reference's vmap inputs (tb, st_b, xs_b) as the port's
    scan_lanes inputs: every state field with its lane axis, the shared
    batch and the [B, P] valid rows."""
    tb, st_b, xs_b = args
    B = np.asarray(xs_b.valid).shape[0]
    base = convert.state(st_b._replace(eavail=st_b.eavail[0], v_cnt=st_b.v_cnt[0], h_cnt=st_b.h_cnt[0]))
    base = base._replace(n_claims=base.n_claims.reshape(()))  # a 0-dim leaf converts to shape (1,)
    st = PK.stack_lanes([base] * B)._replace(
        eavail=torch.from_numpy(np.array(st_b.eavail)),
        v_cnt=torch.from_numpy(np.array(st_b.v_cnt)),
        h_cnt=torch.from_numpy(np.array(st_b.h_cnt)),
    )
    xs = convert.pod_x(xs_b._replace(valid=xs_b.valid[0]))
    return convert.tables(tb), st, xs, torch.from_numpy(np.array(xs_b.valid))


# the reference's full-state path recompiles on every call (4-7 s), so the
# lane path skips the unpadded edge
LANE_FLEETS = [f for f in FLEETS if f is not EDGE_FLEETS[0]]


@pytest.mark.parametrize("fleet", LANE_FLEETS, ids=[i for f, i in zip(FLEETS, FLEET_IDS) if f in LANE_FLEETS])
def test_lane_scan_path_matches_reference(fleet, monkeypatch):
    """The full-state path, forced on both sides; the reference's
    vmap(solve_scan) dispatch is captured and the plain K7 run on it."""
    ref, port = fleet_sides(fleet)
    monkeypatch.setattr(rsweep, "_fast_prefix_feasibility", lambda *a, **k: None)
    monkeypatch.setattr(psweep, "_fast_prefix_feasibility", lambda *a, **k: None)
    captured = []
    real_jit = jax.jit

    def jit_spy(fn, **jit_kw):
        compiled = real_jit(fn, **jit_kw)

        def call(*args, **kw):
            out = compiled(*args, **kw)
            if not kw and len(args) == 3 and hasattr(args[1], "eavail"):  # the (tb, st_b, xs_b) dispatch
                captured.append((jax.device_get(args), jax.device_get(out)))
            return out

        return call

    for singleton in (False, True):
        monkeypatch.setattr(jax, "jit", jit_spy)
        want, want_steps = ref_sweep(ref, singleton)
        monkeypatch.setattr(jax, "jit", real_jit)
        got, got_steps = port_sweep(port, singleton)
        assert psweep.last_sweep["path"] == "sweep_vmap"
        assert got == want, (singleton, got, want)
        assert got_steps == want_steps
    assert len(captured) == 2
    relax = False  # the fleets carry no preferences
    for args, (st_out, kinds, slots, over, odo) in captured:
        g_st, g_kinds, g_slots, g_over, g_odo = PK.scan_lanes_plain(*_lane_inputs(args), relax)
        assert np.array_equal(g_kinds.numpy(), np.asarray(kinds))
        assert np.array_equal(g_slots.numpy(), np.asarray(slots))
        assert np.array_equal(g_over.numpy(), np.asarray(over))
        for f in ("steps", "tier_steps", "tier_hist"):
            assert np.array_equal(getattr(g_odo, f).numpy(), np.asarray(getattr(odo, f))), f
        assert_tree_equal(st_out, g_st, "st_out")


# ---------------------------------------------------------------------------
# (d) the referee


def test_referee_matches_reference_per_prefix():
    ref, port = fleet_sides(PARTIAL_FLEET)
    for k in range(1, len(ref.cands) + 1):
        want = r_simulate(ref.kube, ref.cluster, ref.cloud, ref.cands[:k], ref.opts, force_oracle=True)
        got = p_simulate(port.kube, port.cluster, port.cloud, port.cands[:k], force_oracle=True)
        assert fuzz.results_snapshot(got.results, got.pods) == fuzz.results_snapshot(want.results, want.pods), k
        assert got.all_pods_scheduled() == want.all_pods_scheduled()
        assert len(got.non_empty_new_claims()) == len(want.non_empty_new_claims())
    # the default path (tests/test_disruption.py:1131): TorchHybridScheduler
    # on the kernels, with the crossover set to 0 on both sides
    for k in (1, len(ref.cands)):
        want = r_simulate(ref.kube, ref.cluster, ref.cloud, ref.cands[:k], ROptions(tpu_min_pods=0))
        got = p_simulate(port.kube, port.cluster, port.cloud, port.cands[:k], POptions(tpu_min_pods=0), device="cpu")
        assert got.used_tpu is want.used_tpu is True, k
        assert fuzz.results_snapshot(got.results, got.pods) == fuzz.results_snapshot(want.results, want.pods), k


# ---------------------------------------------------------------------------
# (e) the fleet builder


def _fleet_multiset(kube):
    out = []
    for node in kube.list("Node"):
        labels = node.metadata.labels
        riders = sorted(
            tuple(sorted(p.requests.items())) for p in kube.list("Pod") if p.node_name == node.name
        )
        out.append(
            (
                labels[well_known.INSTANCE_TYPE_LABEL_KEY],
                labels[well_known.TOPOLOGY_ZONE_LABEL_KEY],
                labels[well_known.CAPACITY_TYPE_LABEL_KEY],
                tuple(sorted(node.allocatable.items())),
                tuple(riders),
            )
        )
    return sorted(out)


@pytest.mark.parametrize("sizes", [None, [2, 8, 32]], ids=["kwok-types", "sizes-2-8-32"])
def test_underutilized_world_matches_operator(sizes):
    kw = dict(seed=7, sizes=sizes, rider_requests={"cpu": "400m", "memory": "128Mi"},
              seed_requests={"cpu": "700m", "memory": "512Mi"})
    op = fixtures.underutilized_operator(8, force_oracle=True, **kw)
    w = pfixtures.underutilized_world(8, **kw)
    assert _fleet_multiset(w.kube) == _fleet_multiset(op.kube)
    # every node is a consolidation candidate on both sides
    pc = convert.candidates(w.kube, w.cluster, w.cloud, w.clock, [n.name for n in w.kube.list("Node")])
    assert len(pc) == len(ref_candidates(op)) == 8


def test_underutilized_world_pending_and_spread():
    w = pfixtures.underutilized_world(4, seed=3, n_pending=2, rider_spread=2)
    assert len(w.kube.pending_pods()) == 2
    riders = [p for p in w.kube.list("Pod") if p.name.startswith("rider-")]
    assert all(p.topology_spread_constraints[0].max_skew == 2 for p in riders)


# ---------------------------------------------------------------------------
# (f) the gates


def _both(op, limit=None):
    ref, port = sides(op, limit)
    ref.mod = SimpleNamespace(sweep=rsweep, res=rres, objects=robjects)
    port.mod = SimpleNamespace(sweep=psweep, res=pres, objects=pobjects)
    return ref, port


def _sweep(side, **kw):
    if side.mod.sweep is rsweep:
        return rsweep.prefix_feasibility(side.kube, side.cluster, side.cloud, side.cands, side.opts, **kw)
    return psweep.prefix_feasibility(side.kube, side.cluster, side.cloud, side.cands, device="cpu", **kw)


def _gate_nodepool_limits(side, monkeypatch):
    np_ = side.kube.list("NodePool")[0]
    np_.limits = side.mod.res.parse_list({"cpu": "1000"})
    side.kube.update("NodePool", np_)
    return "nodepool limits"


def _gate_draining_non_candidate(side, monkeypatch):
    keeper = side.cands[-1]
    side.cands = side.cands[:-1]
    side.kube.delete("Node", keeper.name)  # finalizers hold it: marked deleting
    return "draining off non-candidate"


def _gate_missing_candidate(side, monkeypatch):
    side.cands = side.cands + [SimpleNamespace(name="ghost-node", reschedulable_pods=[])]
    return "missing from schedulable"


def _rider(side):
    return next(p for p in side.kube.list("Pod") if p.name.startswith("rider-"))


def _gate_host_ports(side, monkeypatch):
    rider = _rider(side)
    rider.host_ports = [("", "TCP", 8080)]
    side.kube.update("Pod", rider)
    side.cands = [next(c for c in _recandidates(side) if c.name == x.name) for x in side.cands]
    return "host ports"


def _recandidates(side):
    """The side's candidates rebuilt after a pod mutation."""
    if side.mod.sweep is rsweep:
        return ref_candidates(SimpleNamespace(kube=side.kube, cluster=side.cluster, cloud=side.cloud,
                                              clock=side.clock, opts=side.opts))
    return convert.candidates(side.kube, side.cluster, side.cloud, side.clock, [c.name for c in side.cands])


def _gate_anti_affinity_on_candidate(side, monkeypatch):
    rider = _rider(side)
    rider.pod_anti_affinity = [
        side.mod.objects.PodAffinityTerm(
            topology_key=well_known.HOSTNAME_LABEL_KEY,
            label_selector=side.mod.objects.LabelSelector(match_labels={"fleet": "rider"}),
        )
    ]
    side.kube.update("Pod", rider)
    side.cands = [next(c for c in _recandidates(side) if c.name == x.name) for x in side.cands]
    return "anti-affinity pod on candidate"


def _gate_large_unsupported(side, monkeypatch):
    # a zone-spread pending backlog: the fast gates fail, and lanes x pods
    # pass the full-state scan's 4096 limit
    objs = side.mod.objects
    for i in range(1000):
        p = objs.Pod(
            metadata=objs.ObjectMeta(name=f"spread-{i}", labels={"app": "spread"}),
            requests=side.mod.res.parse_list({"cpu": "10m", "memory": "16Mi"}),
            topology_spread_constraints=[
                objs.TopologySpreadConstraint(
                    max_skew=1,
                    topology_key=well_known.TOPOLOGY_ZONE_LABEL_KEY,
                    label_selector=objs.LabelSelector(match_labels={"app": "spread"}),
                )
            ],
        )
        side.kube.create("Pod", p)
    return "binary search wins"


def _gate_max_prefixes(side, monkeypatch):
    monkeypatch.setattr(side.mod.sweep, "MAX_SWEEP_PREFIXES", 2)
    return "prefixes >"


GATES = {
    "nodepool-limits": _gate_nodepool_limits,
    "draining-non-candidate": _gate_draining_non_candidate,
    "missing-candidate": _gate_missing_candidate,
    "host-ports": _gate_host_ports,
    "anti-affinity-on-candidate": _gate_anti_affinity_on_candidate,
    "large-unsupported": _gate_large_unsupported,
    "max-prefixes": _gate_max_prefixes,
}


@pytest.mark.parametrize("case", sorted(GATES), ids=sorted(GATES))
def test_sweep_gates_match_reference(case, monkeypatch):
    op = fleet_op(21, 5, [2, 32], "100m", "700m")
    ref, port = _both(op)
    ref.clock = op.clock
    for side in (ref, port):
        match = GATES[case](side, monkeypatch)
        with pytest.raises((rsweep.SweepUnsupported, psweep.SweepUnsupported), match=match) as info:
            _sweep(side)
        assert isinstance(info.value, side.mod.sweep.SweepUnsupported)


def test_empty_candidate_list():
    ref, port = fleet_sides(FLEETS[0])
    assert psweep.prefix_feasibility(port.kube, port.cluster, port.cloud, [], device="cpu") == []
    assert rsweep.prefix_feasibility(ref.kube, ref.cluster, ref.cloud, [], ref.opts) == []
