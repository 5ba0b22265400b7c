"""The port's protocol tier held to the reference's.

- `explore` gives the reference's state count, truncation, verdict and
  shrunk counterexample schedule for every scenario and every broken-knob
  variant whose reference exploration takes under a second (all but the
  real-knob `recover`, about 5 s).
- The shared corpus tests/proto_corpus/: each pinned schedule replays to
  its rule in both packages, the model's trace of it is the same in both,
  and both judges return the same violations on it; the corpus is never
  written.
- Traces recorded from the port's live scenarios (its ResilientSolver and
  a drained SolverServer) are judged alike by both judges, and so are the
  same traces with a contract broken.
- `--proto` exits 0 on the tree.
"""

from __future__ import annotations

import glob
import json
import os

import pytest

from karpenter_tpu.analysis import proto as ref_proto
from karpenter_tpu_torch.analysis import proto
from karpenter_tpu_torch.analysis.__main__ import main as cli
from karpenter_tpu_torch.solver import service

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = sorted(glob.glob(os.path.join(REPO_ROOT, "tests", "proto_corpus", "*.json")))

# the real-knob scenarios whose reference exploration is under a second
QUICK = ("steady", "churn", "restart", "drain")


def _scenario(mod, name):
    return next(s for s in mod.SCENARIOS if s.name == name)


def _knobs(mod, knobs):
    return mod.Knobs(**{k: getattr(knobs, k) for k in mod.Knobs.__dataclass_fields__})


def test_wire_kinds_and_model_tables_match():
    for name in ("KIND_SOLVE", "KIND_RESULT", "KIND_ERROR", "KIND_PING", "KIND_PONG",
                 "KIND_SOLVE_DELTA", "KIND_EPOCH_RESYNC", "KIND_RETRY"):
        assert getattr(proto, name) == getattr(service, name) == getattr(ref_proto, name), name
    assert [s.__dict__ for s in proto.SCENARIOS] == [s.__dict__ for s in ref_proto.SCENARIOS]
    assert set(proto.PROTO_RULES) == set(ref_proto.PROTO_RULES)
    assert {k: (s, v.__dict__) for k, (s, v) in proto.BROKEN_KNOBS.items()} == {
        k: (s, v.__dict__) for k, (s, v) in ref_proto.BROKEN_KNOBS.items()
    }


@pytest.mark.parametrize("name", QUICK)
def test_explore_matches_the_reference(name):
    want = ref_proto.explore(ref_proto.Config(ref_proto.REAL_KNOBS, _scenario(ref_proto, name)))
    got = proto.explore(proto.Config(proto.REAL_KNOBS, _scenario(proto, name)))
    assert (got.states, got.truncated) == (want.states, want.truncated)
    assert got.counterexamples == want.counterexamples == []


@pytest.mark.parametrize("rule", sorted(ref_proto.BROKEN_KNOBS))
def test_broken_knobs_give_the_reference_counterexample(rule):
    scn, knobs = ref_proto.BROKEN_KNOBS[rule]
    want_cfg = ref_proto.Config(knobs, _scenario(ref_proto, scn))
    got_cfg = proto.Config(_knobs(proto, knobs), _scenario(proto, scn))
    want = ref_proto.explore(want_cfg, stop_on_first=True)
    got = proto.explore(got_cfg, stop_on_first=True)
    assert got.states == want.states
    assert [c.rule for c in got.counterexamples] == [c.rule for c in want.counterexamples] == [rule]
    w = ref_proto.shrink(want_cfg, want.counterexamples[0])
    g = proto.shrink(got_cfg, got.counterexamples[0])
    assert g.schedule == w.schedule and g.message == w.message
    _, viols = proto.replay(got_cfg, g.schedule)
    assert rule in {r for r, _ in viols}


@pytest.mark.parametrize("path", CORPUS, ids=[os.path.basename(p) for p in CORPUS])
def test_corpus_replays_and_both_judges_agree(path):
    with open(path, encoding="utf-8") as f:
        case = json.load(f)
    assert proto.replay_corpus_case(case) == ref_proto.replay_corpus_case(case)
    assert case["rule"] in proto.replay_corpus_case(case)
    scn = case["scenario"]
    ref_trace = ref_proto.trace_of(ref_proto.Config(ref_proto.Knobs(**case["knobs"]), _scenario(ref_proto, scn)), case["schedule"])
    trace = proto.trace_of(proto.Config(proto.Knobs(**case["knobs"]), _scenario(proto, scn)), case["schedule"])
    assert trace == ref_trace
    assert proto.check_refinement(trace) == ref_proto.check_refinement(trace)
    # the same schedule under the real knobs, where it replays
    real = proto.Config(proto.REAL_KNOBS, _scenario(proto, scn))
    if proto.replay(real, case["schedule"])[0] is not None:
        t = proto.trace_of(real, case["schedule"])
        assert proto.check_refinement(t) == ref_proto.check_refinement(t) == []


def _break(events, drop_ev, **match):
    """The trace with the first `drop_ev` event (whose fields include
    `match`) gone: a contract broken."""
    out, dropped = [], False
    for e in events:
        if not dropped and e.get("ev") == drop_ev and all(e.get(k) == v for k, v in match.items()):
            dropped = True
            continue
        out.append(e)
    assert dropped, drop_ev
    return out


@pytest.fixture(scope="module")
def live_traces():
    return {name: fn() for name, _, fn in proto.LIVE_SCENARIOS}


def test_live_traces_from_the_port_are_judged_alike(live_traces):
    assert set(live_traces) == {"live_breaker_retry", "live_drain"}
    for name, events in live_traces.items():
        assert events, name
        assert proto.check_refinement(events) == ref_proto.check_refinement(events) == [], name
    broken = {
        "stranded probe": _break(live_traces["live_breaker_retry"], "breaker_success"),
        "silent drain close": _break(live_traces["live_drain"], "srv_send", refusal=True),
    }
    for why, events in broken.items():
        got = proto.check_refinement(events)
        assert got and got == ref_proto.check_refinement(events), why
        sub = proto.shrink_trace(events, got[0])
        assert sub == ref_proto.shrink_trace(events, got[0])


def test_the_tier_never_writes_the_shared_corpus(tmp_path):
    before = {p: os.path.getmtime(p) for p in CORPUS}
    broken = proto.Knobs(snapshot_resyncable=True)
    report = proto.run_proto_analysis(
        REPO_ROOT, baseline_path=str(tmp_path / "none.json"), knobs=broken,
        scenarios=(_scenario(proto, "steady"),), live=False,
    )
    assert [f.rule for f in report["findings"]] == ["proto-resync-one-hop"]
    assert {p: os.path.getmtime(p) for p in CORPUS} == before
    assert sorted(glob.glob(os.path.join(REPO_ROOT, "tests", "proto_corpus", "*.json"))) == CORPUS
    # a corpus directory the caller names does get the shrunk schedule
    report = proto.run_proto_analysis(
        REPO_ROOT, baseline_path=str(tmp_path / "none.json"), knobs=broken,
        scenarios=(_scenario(proto, "steady"),), live=False, corpus_dir=str(tmp_path / "corpus"),
    )
    assert [os.path.basename(p) for p in glob.glob(str(tmp_path / "corpus" / "*.json"))] == [
        "proto-resync-one-hop__steady.json"
    ]


def test_proto_tier_exits_0_on_the_tree(capsys):
    assert cli(["--proto", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == [] and payload["errors"] == []
    assert set(payload["properties"].values()) == {"ok"}
    assert set(payload["conformance"]) == {"live_breaker_retry", "live_drain"}
    assert cli(["--proto", "--rules", "proto-converge"]) == 2
