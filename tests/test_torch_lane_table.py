"""K7's lane table, the host half of scan_lanes, on the CPU.

The kernel reads each lane's state, pod rows, outputs and scratch through
one pointer a lane and field (`tpu_kernel.lane_pointers`), and every other
field from the argument block all lanes share. These tests hold that
table to the tensors it points into, for the fleet's launch (every PodX
field a lane's own) and the sweep's (the pod batch shared but for
`valid`), and the Python field list to the C header's.
"""

import re
from pathlib import Path

import pytest
import torch

from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
from karpenter_tpu_torch.ops.encode import Reqs
from karpenter_tpu_torch.solver import tpu_kernel as K
from karpenter_tpu_torch.solver.topology import Topology
from karpenter_tpu_torch.solver.tpu import TorchScheduler
from karpenter_tpu_torch.solver.tpu_problem import encode_problem
from karpenter_tpu_torch.testing import fixtures

STEP_ARGS_H = Path(K.__file__).resolve().parent.parent / "csrc" / "step_args.h"


def _c_lane_fields() -> tuple:
    """KTPU_LANE_PTR_FIELDS of csrc/step_args.h, expanded."""
    text = STEP_ARGS_H.read_text()
    body = re.search(r"#define KTPU_LANE_PTR_FIELDS\(X\)(.*?)\n\n", text, re.S).group(1)
    out = []
    for reqs, name in re.findall(r"KTPU_REQS_FIELDS\(X, (\w+)\)|X\((\w+)\)", body):
        out += [f"{reqs}_{f}" for f in Reqs._fields] if reqs else [name]
    return tuple(out)


def _lanes(B: int, relax: bool):
    """(tb, stacked State, stacked PodX) of B small scan-path lanes of one
    table fingerprint, on the CPU."""
    fixtures.reset_rng(5)
    its = construct_instance_types(sizes=[2, 8])
    sts, xss, tb = [], [], None
    for k in range(B):
        pools = [fixtures.node_pool(name="default")]
        pods = fixtures.make_self_spread_pods(6, f"{k + 1}00m") + fixtures.make_preference_pods(2 if relax else 0)
        ibp = {"default": its}
        sched = TorchScheduler(pools, ibp, Topology(pools, ibp, pods), device="cpu")
        problem = encode_problem(sched.oracle, pods)
        order = sched._order_pods(problem)
        tb = sched._tables(problem)
        sched._upload_pod_tables(problem)
        sts.append(sched._init_state(problem, 8))
        xss.append(sched._pod_xs_with_idx(problem, order, pad_to=16)[0])
    return tb, K.stack_lanes(sts), K.stack_lanes(xss)


def test_lane_fields_match_the_header():
    assert K.LANE_PTR_FIELDS == _c_lane_fields()
    assert len(set(K.LANE_PTR_FIELDS)) == len(K.LANE_PTR_FIELDS)


@pytest.mark.parametrize("mode", ["fleet", "fleet-relax", "sweep"])
def test_lane_pointers_point_at_each_lanes_rows(mode):
    B = 3
    relax = mode == "fleet-relax"
    tb, st, xs = _lanes(B, relax)
    if mode == "sweep":  # one pod batch, a valid row a lane
        lane_fields = ("valid",)
        xs = K.PodX(*(K._lane_field(f, 0) if n != "valid" else f for n, f in zip(K.PodX._fields, xs)))
    else:
        lane_fields = K.PodX._fields
    xs0 = K.PodX(*(K._lane_field(f, 0) if n in lane_fields else f for n, f in zip(K.PodX._fields, xs)))
    vals = K.step_arg_values(tb, K.lane_slice(st, 0), xs0, st.rank.device)
    if relax:
        K.tier_arg_values(tb, xs0, vals, st.rank.device)
    P, N = xs0.valid.shape[0], st.active.shape[1]
    outs = {
        "kinds": torch.empty((B, P), dtype=torch.int32),
        "slots": torch.empty((B, P), dtype=torch.int32),
        "counters": torch.zeros((B, K.N_COUNTERS), dtype=torch.int32),
        "cand": torch.empty((B, N), dtype=torch.uint8),
        "scratch": torch.empty((B, 64), dtype=torch.uint8),
    }
    lanes = K.lane_tensors(st, xs, lane_fields, relax, outs, "test")
    table = K.lane_pointers(lanes, vals, B)
    nf = len(K.LANE_PTR_FIELDS)
    assert len(table) == B * nf
    shared_pod = set()
    for b in range(B):
        for i, name in enumerate(K.LANE_PTR_FIELDS):
            got = table[b * nf + i]
            if name in lanes:
                assert got == lanes[name][b].data_ptr(), (b, name)
            else:
                # a field every lane shares: lane 0's address in every lane
                assert got == vals.get(name, 0), (b, name)
                shared_pod.add(name)
    state_fields = set(K.STATE_PTR_FIELDS) | set(outs)
    assert state_fields <= set(lanes)
    if mode == "sweep":
        assert shared_pod == set(K.PODX_PTR_FIELDS) - {"valid"} and "valid" in lanes
        assert table[nf + K.LANE_PTR_FIELDS.index("preq_mask")] == xs.preq.mask.data_ptr()
    else:
        # the tier rows are a lane's own only with the tier loop
        assert shared_pod == (set() if relax else {"rrow", "ntiers"})
        assert all(table[b * nf + K.LANE_PTR_FIELDS.index("rrow")] == 0 for b in range(B)) or relax


def test_lane_pointers_refuse_a_short_or_strided_block():
    t = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.lane_pointers({"count": t}, {}, 3)
    with pytest.raises(ValueError):
        K.lane_pointers({"count": t.t()}, {}, 3)
