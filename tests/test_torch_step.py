"""The port's plain scan step against the JAX package's `solve_scan`.

Each case builds the reference's Tables/State/PodX for a problem, carries
them over with `karpenter_tpu_torch.convert` (byte-identical inputs), and
runs both `solve_scan`s with relax=False. kinds, slots, the overflow flag,
every final State field and the step count must be equal.
"""

import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from karpenter_tpu import jaxsetup
from karpenter_tpu.solver import tpu_kernel as JK
from karpenter_tpu.solver.topology import Topology
from karpenter_tpu.solver.tpu import TpuScheduler
from karpenter_tpu.solver.tpu_problem import _pow2, encode_problem
from karpenter_tpu.testing import fuzz
from karpenter_tpu_torch import convert
from karpenter_tpu_torch.solver import tpu_kernel as TK

# relax-free, kernel-supported fuzz seeds: existing nodes + host ports +
# taints (7005, 7025), daemonset ports + affinity (7017), pool limits +
# zone spread (7024), reservations (7030), minValues (7031), bound pods +
# existing nodes + pool limits (7042), anti-affinity + minValues + host
# ports on existing nodes (7055)
SEEDS = [7005, 7017, 7024, 7025, 7030, 7031, 7042, 7055]


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


def _fuzz_inputs(seed: int):
    case = fuzz.generate_case(seed)
    pools, ibp, pods, views, daemons, options, source = case.materialize()
    topo = Topology(
        pools, ibp, pods, cluster=source, state_node_views=views,
        ignore_preferences=options.ignore_preferences,
    )
    s = TpuScheduler(pools, ibp, topo, views, daemons, options)
    problem = encode_problem(s.oracle, pods)
    assert not (problem.ntiers_r > 1).any()
    order = s._order_pods(problem)
    tb = s._tables(problem)
    s._upload_pod_tables(problem)
    n = len(pods)
    N = min(_pow2(max(64, (n + 3) // 4)), _pow2(n))
    return tb, s._init_state(problem, N), s._pod_xs(problem, order)


def _check(tb, st, xs):
    jst, jkinds, jslots, jover, jodo = jax.device_get(JK.solve_scan(tb, st, xs, relax=False))
    tb_n, st_n, xs_n = jax.device_get((tb, st, xs))
    pst, pkinds, pslots, pover, podo = TK.solve_scan(
        convert.tables(tb_n), convert.state(st_n), convert.pod_x(xs_n)
    )
    assert np.array_equal(np.asarray(jkinds), pkinds.numpy())
    assert np.array_equal(np.asarray(jslots), pslots.numpy())
    assert bool(jover) == bool(pover)
    assert int(jodo.steps) == int(podo.steps)
    assert int(jodo.bulk_steps) == int(podo.bulk_steps) == 0
    want = convert.state(jst)
    for name, a, b in zip(TK.State._fields, want, pst):
        if isinstance(a, tuple):
            for f, x, y in zip(a._fields, a, b):
                assert torch.equal(x, y), f"{name}.{f}"
        else:
            assert torch.equal(a, b), name
    return pkinds, bool(pover)


def test_small_problem_matches_reference():
    tb, st, xs, _, _ = graft._small_problem()
    kinds, over = _check(tb, st, xs)
    assert not over and (kinds == TK.KIND_NEW).any() and (kinds == TK.KIND_CLAIM).any()


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_seed_matches_reference(seed):
    _check(*_fuzz_inputs(seed))


def test_slot_overflow_matches_reference():
    """Two claim slots for a batch that opens three: both raise the
    overflow signal with identical partial state."""
    tb, _, xs, sched, problem = graft._small_problem()
    _, over = _check(tb, sched._init_state(problem, 2), xs)
    assert over
