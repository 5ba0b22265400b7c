"""The port's epochs (karpenter_tpu_torch/solver/epochs.py) against the JAX
package's.

- `sections_from_request`, `diff_sections`, `apply_delta` and
  `materialize_request` equal the reference's on the same requests (the
  reference's `encode_problem_dict` of a base world and of churned ones);
- `EpochStore` evicts on both axes, `AdmissionGate` sheds and recovers;
- `DeviceTableCache`: the single-flight election and the dead-builder
  recovery (twins of tests/test_fleet.py:416 and the dead-builder case),
  a coalesced window that builds its shared tables once and a repeat
  window none (twin of tests/test_fleet.py:374), and on the solve path a
  repeat same-epoch solve that uploads no table bytes, answers a `hit`
  and screens no types (the K1 wrapper is not called), a new pending
  batch of the same cluster that takes the shared tables
  (`tables_hit`), and decisions equal to the uncached solve's.
"""

from __future__ import annotations

import json
import sys
import threading
import time

import pytest

from karpenter_tpu.api import labels as ref_wk
from karpenter_tpu.cloudprovider.kwok import construct_instance_types as ref_types
from karpenter_tpu.solver import epochs as ref_epochs
from karpenter_tpu.solver.nodes import StateNodeView as RefView
from karpenter_tpu.solver.service import encode_problem_dict as ref_encode_dict
from karpenter_tpu.solver.topology import ClusterSource as RefSource
from karpenter_tpu.testing import fixtures as ref_fixtures
from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
from karpenter_tpu_torch.solver import epochs, fleet
from karpenter_tpu_torch.solver import tpu as T
from karpenter_tpu_torch.solver.topology import Topology
from karpenter_tpu_torch.solver.tpu import TorchScheduler
from karpenter_tpu_torch.testing import fixtures

JOIN_SECONDS = 120.0
PROFILES = [f"{k}00m" for k in range(1, 9)]


# ---------------------------------------------------------------------------
# sections and deltas against the reference's


def _ref_view(name: str, zone: str, cpu: int = 1500) -> RefView:
    labels = {
        ref_wk.TOPOLOGY_ZONE_LABEL_KEY: zone,
        ref_wk.HOSTNAME_LABEL_KEY: name,
        ref_wk.INSTANCE_TYPE_LABEL_KEY: "c-2x-amd64-linux",
        ref_wk.CAPACITY_TYPE_LABEL_KEY: "on-demand",
        ref_wk.NODEPOOL_LABEL_KEY: "default",
    }
    return RefView(
        name=name,
        node_labels=dict(labels),
        labels=dict(labels),
        available={"cpu": cpu, "memory": 3 * 1024**3 * 1000, "pods": 100},
        capacity={"cpu": 2000, "memory": 4 * 1024**3 * 1000},
        initialized=True,
    )


_BASE: list = []


def _ref_base():
    """The reference objects of a small world, built once (the fixtures
    seed their rng but not their uids): two existing nodes, three bound
    pods, eight pending pods."""
    if not _BASE:
        ref_fixtures.reset_rng(11)
        pools = [ref_fixtures.node_pool(name="default")]
        its = ref_types(sizes=[2, 8])
        pods = ref_fixtures.make_diverse_pods(8)
        bound = ref_fixtures.make_generic_pods(3)
        extra_bound = ref_fixtures.make_generic_pods(2)
        other_pool = ref_fixtures.node_pool(name="default", labels={"tier": "x"})
        _BASE.append((pools, its, pods, bound, extra_bound, other_pool))
    return _BASE[0]


def _ref_request(churn: str = "", views: bool = True) -> dict:
    """The reference's full-snapshot request of the base world, with
    `churn` applied to copies: a view's capacity changed, a node removed
    and one added ("views"), a relabelled node ("labels"), bound pods
    removed and added ("pods"), a changed node pool ("pools")."""
    import copy

    from karpenter_tpu.api.objects import Node, ObjectMeta

    pools, its, pods, bound, extra_bound, other_pool = _ref_base()
    bound = copy.deepcopy(bound)
    vs = [_ref_view("node-a", "test-zone-a"), _ref_view("node-b", "test-zone-b")]
    for p, v in zip(bound, vs + vs):
        p.node_name = v.name
    if "views" in churn:
        vs[0].available = {"cpu": 100, "memory": 1024**3 * 1000, "pods": 100}
        vs.append(_ref_view("node-c", "test-zone-c"))
        del vs[1]
    if "labels" in churn:
        vs[0].labels = dict(vs[0].labels, team="blue")
    if "pods" in churn:
        bound = bound[1:] + copy.deepcopy(extra_bound)
        for p in bound:
            p.node_name = "node-a"
    if "pools" in churn:
        pools = [other_pool]
    nodes = {v.name: Node(metadata=ObjectMeta(name=v.name, labels=dict(v.labels))) for v in vs}
    source = RefSource(
        pods_by_namespace={"default": bound}, nodes_by_name=nodes, namespace_labels={"default": {"env": "t"}}
    )
    return ref_encode_dict(
        pools, {"default": its}, pods, vs if views else None, None, None, False, None, source
    )


CHURNS = ["", "views", "labels", "pods", "pools", "views+labels+pods+pools"]


def _json(x) -> str:
    return json.dumps(x, sort_keys=True)


@pytest.mark.parametrize("churn", CHURNS, ids=lambda c: c or "none")
def test_sections_and_deltas_match_reference(churn):
    base_req, new_req = _ref_request(), _ref_request(churn)
    for req in (base_req, new_req):
        assert _json(epochs.sections_from_request(req)) == _json(ref_epochs.sections_from_request(req))
    base = epochs.sections_from_request(base_req)
    new = epochs.sections_from_request(new_req)
    delta = epochs.diff_sections(base, new)
    assert _json(delta) == _json(ref_epochs.diff_sections(base, new))
    if not churn:
        assert delta == {}
    applied = epochs.apply_delta(base, delta)
    assert _json(applied) == _json(ref_epochs.apply_delta(base, delta))
    # the delta rebuilds the new world exactly, and the base is untouched
    assert _json(applied) == _json(new)
    assert _json(base) == _json(epochs.sections_from_request(_ref_request()))
    pods_flat = new_req["pods_flat"]
    got = epochs.materialize_request(applied, pods_flat, new_req["options"], False)
    want = ref_epochs.materialize_request(applied, pods_flat, new_req["options"], False)
    assert _json(got) == _json(want)


def test_delta_from_and_to_no_views_is_wholesale():
    with_views = epochs.sections_from_request(_ref_request())
    without = epochs.sections_from_request(_ref_request(views=False))
    delta = epochs.diff_sections(with_views, without)
    assert delta["views"] == {"full": None}
    assert _json(delta) == _json(ref_epochs.diff_sections(with_views, without))
    assert epochs.apply_delta(with_views, delta)["views"] is None


@pytest.mark.parametrize(
    "delta,match",
    [
        ([], "must be an object"),
        ({"nope": {"full": 1}}, "unknown delta section"),
        ({"views": []}, "change must be an object"),
        ({"node_pools": {"set": {}}}, "only supports full replacement"),
        ({"cluster_pods": {"set": {"u": "not a pair"}}}, r"\[namespace, pod\]"),
        ({"views": {"set": ["x"]}}, "'set' must be an object"),
    ],
)
def test_apply_delta_rejects_malformed(delta, match):
    base = epochs.sections_from_request(_ref_request())
    with pytest.raises(epochs.DeltaError, match=match):
        epochs.apply_delta(base, delta)
    with pytest.raises(ref_epochs.DeltaError, match=match):
        ref_epochs.apply_delta(base, delta)


def test_epoch_store_evicts_on_both_axes():
    store = epochs.EpochStore(max_clients=2, max_epochs=2)
    for e in range(3):
        store.put("a", e, {"e": e})
    assert store.get("a", 0) is None  # oldest epoch of "a" evicted
    assert store.get("a", 2) == {"e": 2}
    store.put("b", 0, {})
    store.get("a", 1)  # "a" is now the most recent client
    store.put("c", 0, {})
    assert store.get("b", 0) is None  # least recent client evicted
    assert store.stats() == (2, 3)
    assert epochs.EPOCHS_RESIDENT.value() == 3.0
    assert store.get(None, 0) is None
    store.clear()
    assert store.stats() == (0, 0)


def test_admission_gate_sheds_and_recovers():
    gate = epochs.AdmissionGate(max_inflight=2, max_cost_seconds=1.0, estimator=lambda n: 0.6)
    rejected = epochs.ADMISSION_REJECTED.value()
    t1, hint, depth = gate.try_admit(10)
    assert t1 is not None and hint == 0.0 and depth == 1
    # a second request would push the cost past the budget: shed, with a hint
    t2, hint, depth = gate.try_admit(10)
    assert t2 is None and hint > 0 and depth == 1
    assert epochs.ADMISSION_REJECTED.value() == rejected + 1
    gate.release(t1)
    assert gate.depth() == 0
    # an idle gate always admits, even a request past the whole budget
    big = epochs.AdmissionGate(max_inflight=2, max_cost_seconds=0.1, estimator=lambda n: 5.0)
    t3, _, _ = big.try_admit(1)
    assert t3 is not None
    # the depth cap sheds regardless of cost
    zero = epochs.AdmissionGate(max_inflight=0)
    assert zero.try_admit(1)[0] is None
    # the EWMA floor
    gate.observe(0.5)
    gate.observe(1.0)
    assert epochs.ADMISSION_EWMA.value() == pytest.approx(0.6)


# ---------------------------------------------------------------------------
# DeviceTableCache mechanics (tests/test_fleet.py:416 and the dead builder)


def test_table_cache_single_flight_election():
    cache = epochs.DeviceTableCache(capacity=2)
    tb, token = cache.begin_tables("k1")
    assert tb is None and token == "k1"
    done: list = []
    t = threading.Thread(target=lambda: done.append(cache.begin_tables("k1")), daemon=True)
    t.start()
    cache.end_tables(token, "TB1")
    t.join(timeout=10)
    assert done == [("TB1", None)], done
    assert cache.get_tables("k1") == "TB1"
    # a failed publish re-elects the waiter
    _tb, token2 = cache.begin_tables("k2")
    relay: list = []
    t2 = threading.Thread(target=lambda: relay.append(cache.begin_tables("k2")), daemon=True)
    t2.start()
    time.sleep(0.05)
    cache.end_tables(token2, None)
    t2.join(timeout=10)
    assert relay == [(None, "k2")], relay
    cache.end_tables("k2", "TB2")
    # the LRU keeps `capacity` shared-tables entries
    cache.put_tables("k3", "TB3")
    assert cache.get_tables("k1") is None
    assert cache.get_tables("k2") == "TB2" and cache.get_tables("k3") == "TB3"


def test_table_cache_dead_builder_key_recovers():
    cache = epochs.DeviceTableCache()
    cache.BUILD_WAIT_SECONDS = 0.05
    waits = epochs.TABLE_CACHE_WAIT.count()
    _tb, token = cache.begin_tables("kd")
    assert token == "kd"  # the builder never publishes
    assert cache.begin_tables("kd") == (None, None)
    assert epochs.TABLE_CACHE_WAIT.count() == waits + 1
    t0 = time.monotonic()
    _tb2, token2 = cache.begin_tables("kd")
    assert token2 == "kd" and time.monotonic() - t0 < 1.0
    cache.end_tables(token2, "TBD")
    assert cache.get_tables("kd") == "TBD"


def test_table_cache_full_entries_are_an_lru():
    cache = epochs.DeviceTableCache(capacity=2)
    hits = epochs.TABLE_CACHE.value({"outcome": "hit"})
    misses = epochs.TABLE_CACHE.value({"outcome": "miss"})
    cache.put("a", (1,))
    cache.put("b", (2,))
    assert cache.get("a") == (1,)
    cache.put("c", (3,))  # evicts "b", the least recent
    assert cache.get("b") is None and len(cache) == 2
    assert epochs.TABLE_CACHE.value({"outcome": "hit"}) == hits + 1
    assert epochs.TABLE_CACHE.value({"outcome": "miss"}) == misses + 1
    cache.clear()
    assert len(cache) == 0


# ---------------------------------------------------------------------------
# the table cache on the solve path


def _world(cpu: str = "100m", n: int = 6, sizes=(2, 8)):
    fixtures.reset_rng(5)
    its = construct_instance_types(sizes=list(sizes))
    pools = [fixtures.node_pool(name="default")]
    return pools, {"default": its}, fixtures.make_self_spread_pods(n, cpu)


def _snapshot(r, pods) -> tuple:
    name = {p.uid: p.name for p in pods}
    return sorted(
        (
            tuple(sorted(name[p.uid] for p in c.pods)),
            tuple(sorted(it.name for it in c.instance_type_options)),
            tuple(sorted(c.requests.items())),
        )
        for c in r.new_node_claims
        if c.pods
    ), tuple(sorted(name[u] for u in r.pod_errors))


def _cached_solve(cache, cpu="100m", **kw):
    pools, ibp, pods = _world(cpu)
    sched = TorchScheduler(pools, ibp, Topology(pools, ibp, pods), device="cpu", table_cache=cache, **kw)
    res = sched.solve(pods)
    tr = sched.last_profile
    outcomes = [s.attrs["outcome"] for s in tr.spans if s.name == "table_cache"]
    return _snapshot(res, pods), outcomes, tr.counts.get("upload_bytes", 0), sched


@pytest.fixture()
def typeok_calls(monkeypatch):
    """Count the K1 wrapper's calls (on the CPU it takes its plain
    version, which LAUNCHES does not count)."""
    calls = [0]
    real = T.typeok_screen

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(T, "typeok_screen", counted)
    return calls


def test_repeat_same_epoch_solve_uploads_nothing_and_screens_nothing(typeok_calls):
    cache = epochs.DeviceTableCache()
    want = _cached_solve(None)[0]
    upload0 = T.tracing.SOLVE_UPLOAD_BYTES.value()
    got, outcomes, nbytes, first = _cached_solve(cache)
    assert (got, outcomes) == (want, ["miss"])
    assert nbytes > 0 and typeok_calls[0] >= 1
    assert T.tracing.SOLVE_UPLOAD_BYTES.value() - upload0 == nbytes
    calls = typeok_calls[0]
    got, outcomes, nbytes, again = _cached_solve(cache)
    assert (got, outcomes, nbytes) == (want, ["hit"], 0)
    assert typeok_calls[0] == calls, "a cache hit screened types"
    # the hit shares the card's tensors as they lie
    assert again._dev_tables is first._dev_tables and again._typeok is first._typeok


def test_new_batch_of_the_same_cluster_takes_the_shared_tables(typeok_calls):
    cache = epochs.DeviceTableCache()
    _cached_solve(cache, "100m")
    want = _cached_solve(None, "300m")[0]
    calls = typeok_calls[0]
    got, outcomes, nbytes, sched = _cached_solve(cache, "300m")
    assert (got, outcomes) == (want, ["tables_hit"])
    # only the pod tables rebuilt: their bytes, and one screen of the pod
    # rows (the tier rows' screen rides the shared tables)
    assert nbytes == T._tree_nbytes(sched._dev_tables) > 0
    assert typeok_calls[0] - calls == 1


def test_coalesced_window_builds_its_tables_once(monkeypatch):
    """tests/test_fleet.py:374: a coalesced window whose lanes carry
    distinct request profiles builds the shared K.Tables once (the
    table-level single flight), and a repeat window none."""
    builds = [0]
    real = TorchScheduler._tables

    def counted(self, p):
        builds[0] += 1
        return real(self, p)

    monkeypatch.setattr(TorchScheduler, "_tables", counted)
    cache = epochs.DeviceTableCache()
    coalescer = fleet.FleetCoalescer(window_seconds=JOIN_SECONDS, max_lanes=2)

    def window(profiles) -> int:
        b0 = builds[0]
        scheds, errors = [], []
        for cpu in profiles:
            pools, ibp, pods = _world(cpu)
            s = TorchScheduler(pools, ibp, Topology(pools, ibp, pods), device="cpu", table_cache=cache, fleet=coalescer)
            scheds.append((s, pods))

        def run(s, pods):
            try:
                s.solve(pods)
            except BaseException as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=run, args=sp, daemon=True) for sp in scheds]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-4)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=JOIN_SECONDS)
        finally:
            sys.setswitchinterval(interval)
        assert not errors, errors
        assert all(s.last_used_fleet for s, _ in scheds), "lanes did not coalesce"
        for s, _ in scheds:
            events = [e for e in s.last_profile.spans if e.name == "fleet_window"]
            assert events and events[0].attrs["mode"] == "coalesced" and events[0].attrs["lanes"] == 2
        return builds[0] - b0

    assert window(PROFILES[:2]) == 1
    assert window(PROFILES[2:4]) == 0
