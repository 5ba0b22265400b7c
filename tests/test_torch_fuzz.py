"""The port's fuzz harness (`karpenter_tpu_torch/testing/fuzz.py`), fake
cloud provider (`cloudprovider/fake.py`) and fault proxy
(`testing/faults.py`) against the JAX package's.

The carrier is the problem dict: the port's `generate_case(seed)` must
consume its RNG as the reference's does and encode the same payload, so
every later comparison starts from one world. The port's solvers run on
the CPU (`device="cpu"`: the kernels' plain versions).
"""

from __future__ import annotations

import os
import tempfile

import pytest

from karpenter_tpu.api import labels as rwk
from karpenter_tpu.api.objects import NodeClaim as RNodeClaim
from karpenter_tpu.api.objects import NodeSelectorRequirement as RNSR
from karpenter_tpu.api.objects import ObjectMeta as RObjectMeta
from karpenter_tpu.api.objects import Operator as ROperator
from karpenter_tpu.cloudprovider import fake as rfake
from karpenter_tpu.cloudprovider.types import NodeClaimNotFoundError as RNotFound
from karpenter_tpu.testing import fuzz as rfuzz
from karpenter_tpu_torch.api import labels as pwk
from karpenter_tpu_torch.api.objects import NodeClaim, NodeSelectorRequirement, ObjectMeta, Operator
from karpenter_tpu_torch.cloudprovider import fake
from karpenter_tpu_torch.cloudprovider.types import NodeClaimNotFoundError
from karpenter_tpu_torch.testing import fuzz
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.quantity import parse as q

SEEDS = list(range(7000, 7016))
ORACLE_SEEDS = list(range(7000, 7008))
# kernel-supported seeds: 7002 and 7004 take the scan path with the tier
# loop (7004 with a tight slot pool), 7005 and 7006 the runs path (then a
# forced scan solve)
PARITY_SEEDS = [7002, 7004, 7005, 7006]
CORPUS = fuzz.load_corpus()


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_case_gives_the_reference_problem(seed):
    got, want = fuzz.generate_case(seed), rfuzz.generate_case(seed)
    assert got.problem == want.problem
    assert got.families == want.families


@pytest.mark.parametrize("seed", ORACLE_SEEDS)
def test_solve_oracle_matches_reference(seed):
    got = fuzz.results_snapshot(*fuzz.solve_oracle(fuzz.generate_case(seed)))
    want = rfuzz.results_snapshot(*rfuzz.solve_oracle(rfuzz.generate_case(seed)))
    assert got == want


@pytest.mark.parametrize("seed", PARITY_SEEDS)
def test_check_parity_clean(seed):
    case = fuzz.generate_case(seed)
    assert fuzz.kernel_supported(case)
    assert fuzz.check_parity(case, device="cpu") == []
    assert fuzz.check_invariants(case, device="cpu") == []


def test_check_parity_takes_an_oracle_snapshot():
    """A snapshot taken elsewhere stands in for the oracle's; a wrong one
    is reported on the kernel path."""
    case = fuzz.generate_case(7005)
    want = fuzz.results_snapshot(*fuzz.solve_oracle(case))
    assert fuzz.check_parity(case, tight_slots=False, device="cpu", want_snap=want) == []
    bad = fuzz.check_parity(case, tight_slots=False, device="cpu", want_snap=(want[0][1:],) + want[1:])
    assert bad and bad[0].startswith("parity[runs]: tpu=")


def test_oracle_snapshots_feed_check_parity():
    """The side process's form: both oracle snapshots of a case with
    preferences, taken apart, give check_parity's own verdict; a wrong
    relax-off snapshot is reported as such."""
    case = fuzz.generate_case(7002)
    assert fuzz.has_preferences(case)
    want, want_ni = fuzz.oracle_snapshots(case)
    assert want_ni == fuzz.results_snapshot(*fuzz.solve_oracle(case, ignore_preferences=True))
    kw = {"tight_slots": False, "device": "cpu", "want_snap": want}
    assert fuzz.check_parity(case, want_snap_relax_off=want_ni, **kw) == []
    bad = fuzz.check_parity(case, want_snap_relax_off=(want_ni[0][1:],) + want_ni[1:], **kw)
    assert len(bad) == 1 and bad[0].startswith("parity[relax-off]")
    assert fuzz.oracle_snapshots(fuzz.generate_case(7005))[1] is None


@pytest.mark.parametrize("name,entry", CORPUS, ids=[n for n, _ in CORPUS])
def test_corpus_reads_as_the_reference(name, entry):
    got = fuzz.corpus_case(entry)
    want = rfuzz.corpus_case(dict(rfuzz.load_corpus())[name])
    assert (got.seed, got.problem) == (want.seed, want.problem)
    r, pods, h = fuzz.solve_hybrid(got, device="cpu")
    assert fuzz.invariant_violations(got, r, pods) == []
    assert fuzz.odometer_violations(h) == []


def test_planted_double_binding_is_reported_by_both():
    """A pod bound to two claims: both packages' invariant catalogs name
    it with the same words."""
    seed = 7000
    out = []
    for mod in (fuzz, rfuzz):
        case = mod.generate_case(seed)
        r, pods = mod.solve_oracle(case)
        claims = [c for c in r.new_node_claims if c.pods]
        assert len(claims) >= 2
        claims[1].pods.append(claims[0].pods[0])
        out.append(mod.invariant_violations(case, r, pods))
    assert out[0] == out[1]
    assert any(v.endswith("placed twice") for v in out[0])


def test_shrink_matches_reference():
    """One predicate (a zone-spread pod remains) shrinks a seeded case to
    the same size and the same payload in both packages."""
    seed = 7018

    def failing(c):
        return any(p.topology_spread_constraints for p in c.materialize()[2])

    got = fuzz.shrink(fuzz.generate_case(seed), failing, max_evals=120)
    want = rfuzz.shrink(rfuzz.generate_case(seed), failing, max_evals=120)
    assert fuzz.case_size(got) == rfuzz.case_size(want) < fuzz.case_size(fuzz.generate_case(seed))
    assert got.problem == want.problem


def test_corpus_save_load_roundtrip(tmp_path):
    case = fuzz.generate_case(999)
    path = fuzz.save_corpus_case(case, "parity", "example violation", dirpath=str(tmp_path))
    (fn, entry), = fuzz.load_corpus(str(tmp_path))
    assert fn in path and entry["seed"] == 999 and entry["mode"] == "parity"
    assert fuzz.corpus_case(entry).problem == case.problem
    assert "generate_case(999)" in entry["repro"] and "karpenter_tpu_torch" in entry["repro"]


@pytest.mark.hard_timeout(300)
@pytest.mark.parametrize("scenario", ["wire", "retry"])
def test_chaos_through_the_port_sidecar(scenario):
    """A seeded case through the port's SolverServer behind the port's
    FaultyProxy (truncate, corrupt, delay), and through an admission gate
    that refuses everything: every answer equals the in-process oracle."""
    case = fuzz.generate_case(7004)
    tmp = tempfile.mkdtemp(prefix="fz")
    assert fuzz.chaos_violations(case, scenario, tmp, device="cpu") == []


# ---------------------------------------------------------------------------
# the fake cloud provider, twin of tests/test_cloudprovider.py's cases


def _type_view(it) -> tuple:
    return (
        it.name,
        tuple(sorted(it.capacity.items())),
        tuple(sorted(it.allocatable().items())),
        tuple(sorted((r.key, str(r.operator), tuple(sorted(r.values))) for r in it.requirements.values())),
        tuple((tuple(sorted((r.key, tuple(sorted(r.values))) for r in o.requirements.values())), o.price) for o in it.offerings),
    )


@pytest.mark.parametrize("factory", ["default_instance_types", "instance_types", "instance_types_assorted"])
def test_fake_instance_types_match_reference(factory):
    args = (400,) if factory == "instance_types" else ()
    got = [_type_view(it) for it in getattr(fake, factory)(*args)]
    want = [_type_view(it) for it in getattr(rfake, factory)(*args)]
    assert got == want


def test_fake_instance_types_shape():
    its = fake.instance_types(400)
    it0 = its[0]
    assert len(its) == 400 and len(it0.offerings) == 5
    assert it0.capacity[res.CPU] == q("1") and it0.capacity[res.PODS] == q("10")
    assert it0.allocatable()[res.MEMORY] == q("2Gi") - q("10Mi")
    assert it0.requirements.get(fake.INTEGER_INSTANCE_LABEL_KEY).values == {"1"}
    assert it0.requirements.get(fake.LABEL_INSTANCE_SIZE).values == {"small"}
    assert its[10].requirements.get(fake.EXOTIC_INSTANCE_LABEL_KEY).values == {"optional"}


def test_fake_labels_registered_well_known():
    for key in (fake.LABEL_INSTANCE_SIZE, fake.EXOTIC_INSTANCE_LABEL_KEY, fake.INTEGER_INSTANCE_LABEL_KEY):
        assert key in pwk.WELL_KNOWN_LABELS and key in rwk.WELL_KNOWN_LABELS


def test_fake_provider_create_picks_cheapest_compatible():
    got = []
    for mod, nc_type, meta, nsr, op, wk, missing in (
        (fake, NodeClaim, ObjectMeta, NodeSelectorRequirement, Operator, pwk, NodeClaimNotFoundError),
        (rfake, RNodeClaim, RObjectMeta, RNSR, ROperator, rwk, RNotFound),
    ):
        cp = mod.FakeCloudProvider(mod.instance_types(10))
        claim = nc_type(
            metadata=meta(name="test-claim", labels={wk.NODEPOOL_LABEL_KEY: "default"}),
            requirements=[nsr(mod.INTEGER_INSTANCE_LABEL_KEY, op.IN, ["4"])],
        )
        created = cp.create(claim)
        assert cp.get(created.status.provider_id) is created and len(cp.list()) == 1
        got.append((created.metadata.labels, created.status.provider_id, created.status.allocatable))
        cp.delete(created)
        with pytest.raises(missing):
            cp.get(created.status.provider_id)
    assert got[0] == got[1]
    assert got[0][0][pwk.INSTANCE_TYPE_LABEL_KEY] == "fake-it-3"


def test_fake_provider_injected_error():
    cp = fake.FakeCloudProvider()
    cp.next_create_err = RuntimeError("boom")
    claim = NodeClaim(metadata=ObjectMeta(name="c", labels={pwk.NODEPOOL_LABEL_KEY: "default"}))
    with pytest.raises(RuntimeError):
        cp.create(claim)
    cp.create(claim)  # the error is one-shot
    assert len(cp.create_calls) == 2 and len(cp.list()) == 1
    cp.reset()
    assert not cp.list() and not cp.create_calls


def test_faults_module_is_the_reference_copy():
    """The fault proxy is stdlib only and, but for its docstring, the
    reference's module line for line."""
    import karpenter_tpu.testing.faults as rfaults
    import karpenter_tpu_torch.testing.faults as pfaults

    def body(mod):
        with open(mod.__file__) as f:
            text = f.read()
        return text[text.index('"""', 3) :]

    assert body(pfaults) == body(rfaults)
    assert os.path.basename(pfaults.__file__) == "faults.py"
