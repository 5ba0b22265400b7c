"""TorchHybridScheduler and solve_in_process (plain versions on the CPU)
against the JAX package's HybridScheduler.

Every problem is built once with the reference's objects and crosses to
both packages as one wire payload (`encode_problem_dict`; the port decodes
it with `karpenter_tpu_torch.wire`), so both sides see the same uids and
names. Each twin sets `tpu_min_pods` explicitly: the two packages'
defaults differ (each is its own device's crossover). The port must equal
the reference bit for bit on `used_tpu`, `fallback_reason`, the reason
class (the port's `fallback_kind` against what the reference counts in
`tracing.SOLVE_FALLBACKS`) and `fuzz.results_snapshot`.
"""

import os

import pytest
import torch

from karpenter_tpu import jaxsetup
from karpenter_tpu import tracing as rtracing
from karpenter_tpu.api import labels as well_known
from karpenter_tpu.api.objects import LabelSelector, PodAffinityTerm, TopologySpreadConstraint, WhenUnsatisfiable
from karpenter_tpu.cloudprovider.kwok import construct_instance_types
from karpenter_tpu.solver.hybrid import HybridScheduler
from karpenter_tpu.solver.nodes import StateNodeView
from karpenter_tpu.solver.oracle import SchedulerOptions
from karpenter_tpu.solver.service import encode_problem_dict
from karpenter_tpu.solver.topology import Topology as RTopology
from karpenter_tpu.solver.tpu import TpuScheduler
from karpenter_tpu.solver.tpu_problem import UnsupportedBySolver as RefUnsupported
from karpenter_tpu.testing import fixtures, fuzz
from karpenter_tpu_torch import _build
from karpenter_tpu_torch import logging as plog
from karpenter_tpu_torch import wire
from karpenter_tpu_torch.solver import TorchHybridScheduler, solve_in_process
from karpenter_tpu_torch.solver import hybrid as phybrid
from karpenter_tpu_torch.solver.topology import Topology
from karpenter_tpu_torch.solver.tpu import TorchScheduler
from karpenter_tpu_torch.solver.tpu_problem import UnsupportedBySolver

# fuzz seeds whose cases mix kernel-supported pods with volume-claim pods,
# and the route each takes: the partitioned continuation (across existing
# nodes, bound pods, limits, spreads, preferences and host ports), or a
# whole-problem encode gate (zone anti-affinity, best-effort minValues)
MIXED_SEEDS = {
    7015: "partition_continuation",
    7021: "partition_continuation",
    7046: "partition_continuation",
    7066: "partition_continuation",
    7113: "partition_continuation",
    7172: "partition_continuation",
    7007: "unsupported",
    7124: "unsupported",
}
CORPUS = fuzz.load_corpus(os.path.join(os.path.dirname(__file__), "fuzz_corpus"))
REF_CROSSOVER = 768  # the reference's default, set on both sides where a twin needs routing


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


def _case(pods, options, its=None, pool=None, views=None) -> fuzz.FuzzCase:
    pool = pool or fixtures.node_pool(name="default")
    its = its if its is not None else construct_instance_types(sizes=[2, 8, 32])
    problem = encode_problem_dict([pool], {pool.name: its}, pods, views, None, options)
    return fuzz.FuzzCase(seed=0, families=[], problem=problem)


def _counts(counter) -> dict:
    with counter._lock:
        return dict(counter.values)


def _delta(before: dict, after: dict) -> dict:
    return {k[0]: after[k] - before.get(k, 0.0) for k in after if after[k] != before.get(k, 0.0)}


def ref_hybrid(case, force_oracle=False):
    pools, ibp, pods, views, daemons, options, source = case.materialize()
    topo = RTopology(pools, ibp, pods, cluster=source, state_node_views=views,
                     ignore_preferences=options.ignore_preferences)
    before = _counts(rtracing.SOLVE_FALLBACKS)
    h = HybridScheduler(pools, ibp, topo, views, daemons, options, force_oracle=force_oracle)
    res = h.solve(pods)
    return res, pods, h, _delta(before, _counts(rtracing.SOLVE_FALLBACKS))


def port_hybrid(case, force_oracle=False):
    pools, ibp, pods, views, daemons, options, _force, source = wire._decode_problem_dict(case.problem)
    topo = Topology(pools, ibp, pods, cluster=source, state_node_views=views,
                    ignore_preferences=options.ignore_preferences)
    before = _counts(phybrid.SOLVE_FALLBACKS)
    h = TorchHybridScheduler(pools, ibp, topo, views, daemons, options, force_oracle=force_oracle, device="cpu")
    res = h.solve(pods)
    return res, pods, h, _delta(before, _counts(phybrid.SOLVE_FALLBACKS))


def twin(case, force_oracle=False):
    """Both dispatches on one case; returns the port's scheduler after
    holding it to the reference's."""
    want, wpods, rh, rkinds = ref_hybrid(case, force_oracle)
    got, gpods, ph, pkinds = port_hybrid(case, force_oracle)
    assert ph.used_tpu is rh.used_tpu
    assert ph.fallback_reason == rh.fallback_reason
    assert pkinds == rkinds
    assert ({ph.fallback_kind: 1.0} if ph.fallback_kind else {}) == rkinds
    assert fuzz.results_snapshot(got, gpods) == fuzz.results_snapshot(want, wpods)
    return ph


# ---------------------------------------------------------------------------
# twins of tests/test_hybrid.py


def test_supported_problem_rides_the_kernel():
    """tests/test_hybrid.py:28: diverse pods carry topology, so the
    crossover does not route them away."""
    fixtures.reset_rng(7)
    h = twin(_case(fixtures.make_diverse_pods(20), SchedulerOptions(tpu_min_pods=REF_CROSSOVER)))
    assert h.used_tpu is True and h.fallback_reason is None and h.fallback_kind is None
    assert h.tpu.last_odometer["steps"] > 0


def test_unsupported_batch_falls_back_wholesale():
    """tests/test_hybrid.py:46: only volume-claim pods, no crossover."""
    fixtures.reset_rng(7)
    pods = fixtures.make_generic_pods(8)
    for i, p in enumerate(pods):
        p.volume_claims = [f"pvc-{i}"]
    h = twin(_case(pods, SchedulerOptions(tpu_min_pods=0)))
    assert h.used_tpu is False and h.fallback_kind == "unsupported"
    assert "volume claims" in h.fallback_reason


def test_torch_scheduler_raises_only_inside_dispatch():
    """tests/test_hybrid.py:93: the scheduler alone raises the reference's
    UnsupportedBySolver with its message; the dispatch absorbs it."""
    fixtures.reset_rng(7)
    pods = fixtures.make_generic_pods(4)
    pods[1].node_selector = {well_known.HOSTNAME_LABEL_KEY: "some-node"}
    case = _case(pods, SchedulerOptions(tpu_min_pods=0))
    pools, ibp, rpods, views, daemons, options, source = case.materialize()
    with pytest.raises(RefUnsupported) as want:
        TpuScheduler(pools, ibp, RTopology(pools, ibp, rpods), views, daemons, options).solve(rpods)
    pools, ibp, ppods, views, daemons, options, _f, source = wire._decode_problem_dict(case.problem)
    with pytest.raises(UnsupportedBySolver) as got:
        TorchScheduler(pools, ibp, Topology(pools, ibp, ppods), views, daemons, options, device="cpu").solve(ppods)
    assert str(got.value) == str(want.value)
    h = twin(case)
    assert h.fallback_kind == "partition_continuation"


def test_unexpected_kernel_error_degrades_to_pristine_oracle(monkeypatch):
    """The last-resort guard (hybrid.py:236-254): any other error of the
    kernel solve re-solves the whole batch on a pristine oracle, logged at
    error level and counted as tpu_error."""

    def boom(self, pods, trace=None):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(TpuScheduler, "solve", lambda self, pods, trace=None: boom(self, pods))
    monkeypatch.setattr(TorchScheduler, "solve", boom)
    fixtures.reset_rng(7)
    with plog.capture() as records:
        h = twin(_case(fixtures.make_diverse_pods(12), SchedulerOptions(tpu_min_pods=0)))
    assert h.used_tpu is False and h.fallback_kind == "tpu_error"
    assert h.fallback_reason.endswith("RuntimeError: kernel launch failed")
    errors = [r for r in records if r["level"] == "error" and r["logger"] == "karpenter.solver"]
    assert len(errors) == 1 and errors[0]["error"] == "RuntimeError: kernel launch failed"


def _missing_library():
    _build._library.cache_clear()
    try:
        _build.library("no_such_kernel")
    finally:
        _build._library.cache_clear()


DEVICE_FAILURES = {
    "build": lambda: (_ for _ in ()).throw(_build.BuildError("nvcc failed for run_step.cu (exit 1)")),
    "load": _missing_library,
    "launch": lambda: _build.check_launch("run_step", 700),
    "torch_oom": lambda: (_ for _ in ()).throw(torch.OutOfMemoryError("CUDA out of memory")),
    "torch_cuda_error": lambda: (_ for _ in ()).throw(
        RuntimeError("CUDA error: an illegal memory access was encountered")),
}


@pytest.mark.parametrize("failure", sorted(DEVICE_FAILURES))
def test_device_failure_passes_the_guard(monkeypatch, failure):
    """A failure of the card itself (a kernel that does not build, load or
    launch; torch's CUDA errors) propagates out of solve(): the guard does
    not re-solve it on the oracle, counts no tpu_error and sets no route."""
    monkeypatch.setattr(_build, "build_all", lambda: {"no_such_kernel": {"path": "/nonexistent/lib.so"}})
    monkeypatch.setattr(TorchScheduler, "solve", lambda self, pods, trace=None: DEVICE_FAILURES[failure]())
    fixtures.reset_rng(7)
    case = _case(fixtures.make_diverse_pods(12), SchedulerOptions(tpu_min_pods=0))
    pools, ibp, pods, views, daemons, options, _f, source = wire._decode_problem_dict(case.problem)
    h = TorchHybridScheduler(pools, ibp, Topology(pools, ibp, pods, cluster=source), views, daemons, options,
                             device="cpu")
    before = _counts(phybrid.SOLVE_FALLBACKS)
    with plog.capture() as records, pytest.raises(RuntimeError) as raised:
        h.solve(pods)
    assert phybrid.device_failure(raised.value)
    assert _delta(before, _counts(phybrid.SOLVE_FALLBACKS)) == {}
    assert h.used_tpu is None and h.fallback_kind is None
    assert not [r for r in records if r["level"] == "error"]


def test_force_oracle():
    """tests/test_hybrid.py:106."""
    fixtures.reset_rng(7)
    h = twin(_case(fixtures.make_diverse_pods(10), SchedulerOptions(tpu_min_pods=0)), force_oracle=True)
    assert h.tpu is None and h.used_tpu is False and h.fallback_kind == "forced"


def test_mixed_batch_partitions_per_pod():
    """tests/test_hybrid.py:159: the kernel packs the bulk, the oracle
    continues with the volume-claim pod on the decoded state."""
    fixtures.reset_rng(3)
    pods = fixtures.make_diverse_pods(40)
    pods.append(
        fixtures.pod(
            name="anyway",
            labels={"app": "web"},
            requests={"cpu": "100m"},
            topology_spread_constraints=[
                TopologySpreadConstraint(
                    max_skew=1,
                    topology_key=well_known.TOPOLOGY_ZONE_LABEL_KEY,
                    when_unsatisfiable=WhenUnsatisfiable.SCHEDULE_ANYWAY,
                    label_selector=LabelSelector(match_labels={"app": "web"}),
                )
            ],
        )
    )
    ported = fixtures.pod(name="ported", requests={"cpu": "100m"})
    ported.volume_claims = ["pvc-ported"]
    pods.append(ported)
    h = twin(_case(pods, SchedulerOptions(tpu_min_pods=REF_CROSSOVER), its=construct_instance_types(sizes=[2, 8])))
    assert h.used_tpu is True and h.fallback_kind == "partition_continuation"
    assert "continued on the oracle" in h.fallback_reason


def test_continuation_with_padded_existing_slots():
    """tests/test_hybrid.py:208: two existing nodes (padded to 8 slots),
    hostname anti-affinity, and a volume-claim chaser continued on the
    oracle that must see the kernel's hostname counts."""
    hostname = well_known.HOSTNAME_LABEL_KEY
    fixtures.reset_rng(11)
    def labels(i):
        return {
                well_known.TOPOLOGY_ZONE_LABEL_KEY: "test-zone-a",
                hostname: f"existing-{i}",
                well_known.INSTANCE_TYPE_LABEL_KEY: "c-2x-amd64-linux",
                well_known.CAPACITY_TYPE_LABEL_KEY: "on-demand",
                well_known.OS_LABEL_KEY: "linux",
                well_known.ARCH_LABEL_KEY: "amd64",
                well_known.NODEPOOL_LABEL_KEY: "default",
        }

    views = [
        StateNodeView(
            name=f"existing-{i}",
            labels=labels(i),
            node_labels=labels(i),
            available={"cpu": 1500, "memory": 3 * 1024**3 * 1000, "pods": 20_000},
            capacity={"cpu": 2000, "memory": 4 * 1024**3 * 1000},
            initialized=True,
        )
        for i in range(2)
    ]

    def anti():
        return [PodAffinityTerm(topology_key=hostname, label_selector=LabelSelector(match_labels={"app": "redis"}))]

    pods = [
        fixtures.pod(name=f"redis-{i}", labels={"app": "redis"}, requests={"cpu": "100m"},
                     pod_anti_requirements=anti())
        for i in range(3)
    ]
    chaser = fixtures.pod(name="chaser", labels={"app": "web"}, requests={"cpu": "100m"},
                          pod_anti_requirements=anti())
    chaser.volume_claims = ["pvc-chaser"]
    pods.append(chaser)
    h = twin(_case(pods, SchedulerOptions(tpu_min_pods=0), views=views))
    assert h.used_tpu is True and h.fallback_kind == "partition_continuation"


@pytest.mark.parametrize(
    "make,crossover,kind",
    [
        (lambda: fixtures.make_generic_pods(12), REF_CROSSOVER, "small_batch"),
        (lambda: fixtures.make_topology_spread_pods(12, well_known.TOPOLOGY_ZONE_LABEL_KEY), REF_CROSSOVER, None),
        (lambda: fixtures.make_generic_pods(12), 0, None),
    ],
    ids=["topology-free", "spread", "routing-off"],
)
def test_small_batch_routing(make, crossover, kind):
    """tests/test_hybrid.py:310: below the crossover a topology-free batch
    runs on the oracle; a spread batch of the same size, or a crossover of
    0, rides the kernel."""
    fixtures.reset_rng(7)
    h = twin(_case(make(), SchedulerOptions(tpu_min_pods=crossover)))
    assert h.fallback_kind == kind
    assert h.used_tpu is (kind is None)


@pytest.mark.parametrize("force_oracle", [False, True], ids=["hybrid", "forced"])
def test_partition_with_nodepool_limits(force_oracle):
    """tests/test_hybrid.py:344: the continuation must not double-spend the
    pool's limit the kernel already spent."""
    fixtures.reset_rng(13)
    pods = fixtures.make_generic_pods(12)
    hp = fixtures.pod(name="hp", requests={"cpu": "100m"})
    hp.volume_claims = ["pvc-hp"]
    pods.append(hp)
    pool = fixtures.node_pool(name="default", limits={"cpu": "24"})
    h = twin(_case(pods, SchedulerOptions(tpu_min_pods=0), pool=pool), force_oracle=force_oracle)
    assert h.fallback_kind == ("forced" if force_oracle else "partition_continuation")


def test_strict_reserved_mode_falls_back():
    """tests/test_hybrid.py:530: strict reserved mode is refused at encode
    (UnsupportedBySolver) and the same oracle solves the batch."""
    from karpenter_tpu.api.objects import Operator as Op
    from karpenter_tpu.cloudprovider.types import Offering
    from karpenter_tpu.scheduling import Requirement, Requirements

    its = construct_instance_types(sizes=[2, 8, 32])
    its[0].offerings.append(
        Offering(
            requirements=Requirements(
                [
                    Requirement(well_known.TOPOLOGY_ZONE_LABEL_KEY, Op.IN, ["test-zone-a"]),
                    Requirement(well_known.CAPACITY_TYPE_LABEL_KEY, Op.IN, ["reserved"]),
                    Requirement(well_known.RESERVATION_ID_LABEL_KEY, Op.IN, ["res-1"]),
                ]
            ),
            price=0.01,
            available=True,
            reservation_capacity=4,
        )
    )
    fixtures.reset_rng(7)
    opts = SchedulerOptions(reserved_capacity_enabled=True, reserved_offering_strict=True, tpu_min_pods=0)
    h = twin(_case(fixtures.make_diverse_pods(6), opts, its=its))
    assert h.used_tpu is False and h.fallback_kind == "unsupported"
    assert "strict" in h.fallback_reason


# ---------------------------------------------------------------------------
# fuzz seeds and the corpus through solve_in_process


def _in_process(case):
    pools, ibp, pods, views, daemons, options, _force, source = wire._decode_problem_dict(case.problem)
    res, sched = solve_in_process(pools, ibp, pods, views, daemons, options, cluster=source, device="cpu")
    return res, pods, sched


def _hold_to_solve_hybrid(case):
    want, wpods, rh = fuzz.solve_hybrid(case)
    got, gpods, ph = _in_process(case)
    assert ph.used_tpu is rh.used_tpu
    assert ph.fallback_reason == rh.fallback_reason
    assert fuzz.results_snapshot(got, gpods) == fuzz.results_snapshot(want, wpods)
    assert set(ph.last_phases) >= {"topology"}
    return ph


@pytest.mark.parametrize("seed,kind", sorted(MIXED_SEEDS.items()))
def test_fuzz_seed_solve_in_process(seed, kind):
    h = _hold_to_solve_hybrid(fuzz.generate_case(seed))
    assert h.fallback_kind == kind
    assert h.used_tpu is (kind == "partition_continuation")


@pytest.mark.parametrize("name,entry", CORPUS, ids=[n for n, _ in CORPUS])
def test_corpus_case_solve_in_process(name, entry):
    _hold_to_solve_hybrid(fuzz.corpus_case(entry))


# ---------------------------------------------------------------------------
# no card: the default device raises at construction, never in the guard


def test_default_device_without_cuda_raises_at_construction(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fixtures.reset_rng(7)
    case = _case(fixtures.make_generic_pods(4), SchedulerOptions(tpu_min_pods=0))
    pools, ibp, pods, views, daemons, options, _f, source = wire._decode_problem_dict(case.problem)
    topo = Topology(pools, ibp, pods)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchHybridScheduler(pools, ibp, topo, views, daemons, options)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_in_process(pools, ibp, pods, views, daemons, options, cluster=source)
    # the oracle-only scheduler runs no device code
    assert TorchHybridScheduler(pools, ibp, topo, force_oracle=True).tpu is None
