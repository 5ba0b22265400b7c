"""tests/test_topology_matrix.py's scenarios through the port, on the CPU.

Every scenario of the reference's topology matrix (spread with maxSkew and
minDomains, the node inclusion policies, several constraints a pod, pod
affinity and anti-affinity with namespaces and selectors, and their
interactions with taints, weights, limits, existing nodes and minValues)
is run by calling that module's own test function with its `run_parity`
swapped for `twin_parity` below: the scenario makers (`problem`,
`spread_pods`, `affinity_pods` and each test's makers) are the reference
module's, not copies. `twin_parity` carries the scenario across as one
wire payload (the reference's `encode_problem_dict`, decoded by the port's
`wire`) and holds:

- the port's `TorchHybridScheduler(..., device="cpu")` (the plain
  versions) to the port's oracle and to the JAX package's oracle: the
  partition (each new claim's pods, each existing node's pods) and the
  failed pods;
- the port's kernel odometer to `fuzz.odometer_violations`;
- on the first case of each test function, the JAX package's
  `HybridScheduler` too: its partition, `used_tpu` and the fallback class.

Both hybrids take `tpu_min_pods=0`, so topology-free scenarios ride the
kernels too (the packages' default crossovers differ). The test
function's own assertions then run on the JAX oracle's Results, as in
the reference module.
"""

import dataclasses
import itertools
import os

import pytest
import torch

import test_topology_matrix as M
from karpenter_tpu import jaxsetup
from karpenter_tpu.solver.oracle import SchedulerOptions
from karpenter_tpu.solver.service import encode_problem_dict
from karpenter_tpu.testing import fuzz
from karpenter_tpu_torch.testing import fuzz as pfuzz
from test_torch_hybrid import port_hybrid, ref_hybrid


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


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's plain versions on one intra-op thread: a full OpenMP pool
    spends more CPU than it saves on these small problems, and under
    `-n 6` the workers' pools spin against one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cases() -> list:
    """(test function name, its keyword arguments, whether it is the
    function's first case) for every case of the reference module, its
    stacked parametrize marks expanded as pytest expands them."""
    out = []
    for name in sorted(n for n in dir(M) if n.startswith("test_") and callable(getattr(M, n))):
        axes = []
        for mark in getattr(getattr(M, name), "pytestmark", []):
            if mark.name != "parametrize":
                continue
            argnames, values = mark.args[0], mark.args[1]
            names = [a.strip() for a in argnames.split(",")] if isinstance(argnames, str) else list(argnames)
            axes.append([dict(zip(names, v if len(names) > 1 else (v,))) for v in values])
        for i, combo in enumerate(itertools.product(*axes)):
            kwargs = {k: v for part in combo for k, v in part.items()}
            out.append((name, kwargs, i == 0))
    return out


CASES = _cases()


def _case_id(case) -> str:
    name, kwargs, _ = case
    return name + ("[" + "-".join(str(getattr(v, "value", v)) for v in kwargs.values()) + "]" if kwargs else "")


def _parts(r) -> list:
    """The placement partition, as the reference's `run_parity` reads it."""
    out = [("new", tuple(sorted(p.name for p in c.pods))) for c in r.new_node_claims if c.pods]
    out += [(n.name, tuple(sorted(p.name for p in n.pods))) for n in r.existing_nodes if n.pods]
    return sorted(out)


def _errors(r, pods) -> set:
    name = {p.uid: p.name for p in pods}
    return {name[u] for u in r.pod_errors}


def twin_parity(make, expect_errors=False, route=False, cluster=None):
    """The reference's `run_parity` with the port in the loop: returns the
    JAX oracle's Results."""
    pools, ibp, pods, views, daemons = make()
    if views is not None:
        # the wire carries node labels as a dict: a view's None (a claim in
        # flight) goes as {}, which seeds no spread domain either
        # (Topology._count_domains skips both)
        views = [v if v.node_labels is not None else dataclasses.replace(v, node_labels={}) for v in views]
    payload = encode_problem_dict(pools, ibp, pods, views, daemons, SchedulerOptions(tpu_min_pods=0), cluster=cluster)
    case = fuzz.FuzzCase(seed=0, families=[], problem=payload)
    orc, orc_pods = fuzz.solve_oracle(case)
    porc, porc_pods = pfuzz.solve_oracle(pfuzz.FuzzCase(seed=0, problem=payload))
    got, got_pods, ph, pkinds = port_hybrid(case)
    assert pfuzz.odometer_violations(ph) == []
    want_errors = _errors(orc, orc_pods)
    assert _errors(porc, porc_pods) == want_errors
    assert _errors(got, got_pods) == want_errors
    if not expect_errors:
        assert not orc.pod_errors, orc.pod_errors
    assert _parts(porc) == _parts(orc)
    assert _parts(got) == _parts(orc)
    if route:
        ref, ref_pods, rh, rkinds = ref_hybrid(case)
        assert ph.used_tpu is rh.used_tpu
        assert pkinds == rkinds
        assert ({ph.fallback_kind: 1.0} if ph.fallback_kind else {}) == rkinds
        assert _parts(ref) == _parts(orc) and _errors(ref, ref_pods) == want_errors
    return orc


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_topology_scenario_through_port(case, monkeypatch):
    name, kwargs, first = case
    calls = []

    def run_parity(make, expect_errors=False):
        calls.append(name)
        return twin_parity(make, expect_errors, route=first)

    class TwinHybrid:
        """The reference's HybridScheduler where a test builds its own
        (Scheduler, HybridScheduler) pair on a cluster source: its solve is
        `twin_parity` on the same problem (no error set asserted: the
        test compares the two itself), answered with the JAX oracle's
        Results."""

        def __init__(self, pools, ibp, topo, views=None, daemons=None):
            self.world, self.cluster = (pools, ibp, views, daemons), topo.cluster

        def solve(self, pods):
            calls.append(name)
            pools, ibp, views, daemons = self.world
            return twin_parity(lambda: (pools, ibp, pods, views, daemons), True, route=first, cluster=self.cluster)

    monkeypatch.setattr(M, "run_parity", run_parity)
    monkeypatch.setattr(M, "HybridScheduler", TwinHybrid)
    getattr(M, name)(**kwargs)
    assert calls, f"{name} ran no scenario"


def test_every_reference_case_is_twinned():
    """The twin covers each reference test function and each of its cases."""
    names = {n for n in dir(M) if n.startswith("test_") and callable(getattr(M, n))}
    assert {c[0] for c in CASES} == names
    assert len(CASES) >= 118
    assert sum(c[2] for c in CASES) == len(names)
