"""proto — graftlint's protocol tier for the port: explicit-state model
checking of the solver wire/epoch/breaker protocol, conformance-pinned to
the port's live code.

A copy of the reference's `analysis/proto.py`: the model (`World`,
`Knobs`, `SCENARIOS`, `step`), the BFS checker (`explore`), the shrinker,
`trace_of`, the refinement judge (`check_refinement`, `shrink_trace`)
and the report are the reference's, line for line, so a state count, a
verdict or a counterexample in one package maps onto the other (the
port's tests hold the two against each other). What is the port's own:

- the live scenarios drive the port's `ResilientSolver`/`CircuitBreaker`
  (solver/hybrid.py) and `SolverServer` (solver/service.py), recorded by
  the port's `analysis/protorec.py` hooks, and the port's judge reads
  their traces;
- the shared corpus `tests/proto_corpus/*.json` is data: the port replays
  it (`replay_corpus_case`) and never writes it. `run_proto_analysis`
  writes a counterexample only into a `corpus_dir` its caller names.

The model:

1. **Model** — `World` is a frozen value-object snapshot of the whole
   composed system: the client request lifecycle (snapshot / delta /
   resync / RETRY-backoff / deadline / poison, service.py SolverClient),
   the server handler (admission gate, drain with the one-refusal
   bound, epoch commit store-before-answer, service.py _handle), the
   circuit breaker (closed/open/half-open with the single-probe and
   RETRY-records-success rules, hybrid.py CircuitBreaker), and the
   epoch section store — composed asynchronously over a fault-capable
   channel (drop / truncate / duplicate / reorder / kill-either-side,
   mirroring testing/faults.py's proxy modes). `Knobs` makes each
   pinned fix of the protocol an explicit model parameter, so the
   deliberately-broken variant of every property is one flag away.

2. **Checker** — `explore` runs explicit-state BFS with canonical-state
   dedup (epoch ids renumbered by first occurrence), bounded by
   per-scenario tick/fault/state budgets that the JSON report records
   (truncation is never silent). BFS finds the SHORTEST counterexample
   schedule; `shrink` then greedily drops labels while the replay still
   violates.

3. **Conformance** — `check_refinement` judges a RECORDED trace of the
   real code against the model's transition discipline: breaker
   transition legality and per-thread probe obligations, the drain
   answer-then-close contract, epoch commit-implies-store, and the
   client's resync one-hop rule. `run_proto_analysis` additionally
   DRIVES two live scenarios (a scripted ResilientSolver and a real
   drained SolverServer) and refinement-checks their traces.

Module-level imports are stdlib-only: importing this module never pulls
in torch, numpy or JAX; the live scenarios import the port's solver stack
lazily.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Iterable, Optional

from karpenter_tpu_torch.analysis.engine import (
    Baseline,
    Finding,
    PROTO_DEFAULT_BASELINE,
)

# Wire kind codes, mirrored from solver/service.py (which imports numpy
# and torch at module scope and therefore cannot be imported here; the
# port's tests pin the two tables equal).
KIND_SOLVE = 1
KIND_RESULT = 2
KIND_ERROR = 3
KIND_PING = 4
KIND_PONG = 5
KIND_SOLVE_DELTA = 6
KIND_EPOCH_RESYNC = 7
KIND_RETRY = 8

_SOLVE_KINDS = (KIND_SOLVE, KIND_SOLVE_DELTA)
_RESPONSE_KINDS = (KIND_RESULT, KIND_ERROR, KIND_PONG, KIND_EPOCH_RESYNC, KIND_RETRY)

PROTO_RULES = {
    "proto-converge": (
        "every solve converges to a RESULT or a bounded in-process degrade: "
        "no reachable state deadlocks or waits forever (the client deadline "
        "and bounded retry/backoff discipline, docs/resilience.md)"
    ),
    "proto-resync-one-hop": (
        "EPOCH_RESYNC converges in exactly one hop per solve: a resync "
        "falls back to the always-correct full snapshot, and a snapshot is "
        "never itself answered RESYNC (service.py _solve_delta contract)"
    ),
    "proto-drain-bounded": (
        "drain is bounded: a solve frame received during stop() is ANSWERED "
        "(one retriable refusal or the in-flight RESULT flush) before its "
        "connection closes, and no handler serves a second refusal "
        "(service.py _handle drain branch + _drain_close_check)"
    ),
    "proto-breaker-wedge": (
        "the breaker never wedges while the server is healthy: an admission "
        "RETRY is a transport SUCCESS, so it must resolve a half-open probe "
        "to closed instead of stranding it (hybrid.py RETRY-records-success)"
    ),
    "proto-epoch-consistent": (
        "epoch commit is consistent under faults and mid-delta kill: the "
        "sections the server solves from always equal the sections the "
        "client believes it acked — stored sections are COPIES, stores "
        "precede answers, and commits ride only RESULT frames"
    ),
    "proto-conformance": (
        "every recorded trace of the real client/server/breaker refines the "
        "model: transition legality, probe obligations, the drain "
        "answer-then-close bound, commit-implies-store, resync one-hop "
        "(analysis/protorec.py hooks; recorded by the port's service and "
        "resilient tests and by chip_smoke.py's sidecar phase)"
    ),
}

# -- model parameters -------------------------------------------------------

DEADLINE_TICKS = 3  # client waits this many ticks before SolverUnavailable
BR_THRESHOLD = 2  # consecutive failures to open the model breaker
BR_COOLDOWN_TICKS = 2  # open -> half-open (and probe-takeover) cooldown
MAX_RETRIES = 1  # transport resends inside one _roundtrip


@dataclass(frozen=True)
class Knobs:
    """Each field is a pinned fix of the protocol, default = the REAL
    code. Flipping one yields the deliberately-broken model whose
    counterexample the checker must find (and whose shrunk schedule the
    corpus pins). The mapping to properties lives in BROKEN_KNOBS."""

    drain_mode: str = "refuse"  # "refuse" | "close_silent" (the old bug)
    drain_single_refusal: bool = True  # False: handler survives past one
    retry_resolves_probe: bool = True  # False: RETRY strands the probe
    lost_probe_recovery: bool = True  # False: a lost probe wedges forever
    copy_sections: bool = True  # False: stored sections alias the client's
    snapshot_resyncable: bool = False  # True: snapshots answered RESYNC
    store_before_answer: bool = True  # False: answer, then store
    client_deadline: bool = True  # False: a lost response waits forever


REAL_KNOBS = Knobs()


@dataclass(frozen=True)
class Scenario:
    """One bounded exploration: which faults the adversary may inject,
    how many, and how much simulated time exists. Budgets are part of
    the JSON report — a truncated exploration is reported, not hidden."""

    name: str
    n_solves: int
    faults: tuple = ()
    fault_budget: int = 1
    max_ticks: int = 10
    allow_drain: bool = False
    over0: int = 0  # admission gate answers this many RETRYs
    max_states: int = 200_000


SCENARIOS = (
    Scenario(
        "steady",
        n_solves=3,
        faults=("drop_c2s", "drop_s2c", "dup_s2c", "trunc_s2c"),
        fault_budget=1,
        max_ticks=10,
    ),
    Scenario(
        "churn",
        n_solves=2,
        faults=("drop_s2c", "trunc_c2s", "reorder_s2c", "dup_c2s"),
        fault_budget=1,
        over0=1,
        max_ticks=10,
    ),
    Scenario(
        "restart",
        n_solves=3,
        faults=("kill_server",),
        fault_budget=1,
        max_ticks=12,
    ),
    Scenario(
        "drain",
        n_solves=2,
        faults=("kill_conn", "dup_c2s"),
        fault_budget=1,
        allow_drain=True,
        max_ticks=10,
    ),
    Scenario(
        "recover",
        n_solves=4,
        faults=("kill_server", "drop_s2c"),
        fault_budget=2,
        over0=1,
        max_ticks=16,
    ),
)

# property -> (scenario name, broken knobs): the deliberately-broken
# model per property. The tests assert each finds a counterexample AND
# that the real knobs stay clean; the shrunk schedules are pinned in the
# shared tests/proto_corpus/.
BROKEN_KNOBS = {
    "proto-converge": ("steady", Knobs(client_deadline=False)),
    "proto-resync-one-hop": ("steady", Knobs(snapshot_resyncable=True)),
    "proto-drain-bounded": ("drain", Knobs(drain_mode="close_silent")),
    "proto-breaker-wedge": ("recover", Knobs(retry_resolves_probe=False)),
    "proto-epoch-consistent": ("steady", Knobs(copy_sections=False)),
}


@dataclass(frozen=True)
class Config:
    knobs: Knobs
    scenario: Scenario


# -- the composed state -----------------------------------------------------
#
# Frames are tuples ("SOLVE", current, epoch, version) etc.; `current`
# is the client's correlation tripwire abstracted to one bit — a resend
# marks every in-flight frame stale, and reading a stale response
# poisons the stream exactly like a req_id mismatch does on the wire.


@dataclass(frozen=True)
class World:
    # client request lifecycle (service.py SolverClient + hybrid.py entry)
    solve: int = 0  # index of the solve in progress; done at n_solves
    phase: str = "idle"  # "idle" | "wait"
    sent: str = ""  # kind of the in-flight request: "snap" | "delta"
    acked_e: int = 0  # client-committed epoch id (0 = none)
    acked_v: int = 0  # ghost: true section version behind acked_e
    wait_age: int = 0  # ticks spent waiting on the in-flight request
    retries: int = 0  # transport resends used this roundtrip
    resyncs: int = 0  # RESYNC hops consumed by the CURRENT solve
    degrades: int = 0  # solves completed in-process (oracle floor)
    backoff: int = 0  # admission-backoff ticks remaining
    # circuit breaker (hybrid.py CircuitBreaker)
    br: str = "closed"  # "closed" | "open" | "half"
    brf: int = 0  # consecutive failures
    brcool: int = 0  # ticks until open->half / probe takeover
    probe: bool = False  # a half-open probe is outstanding
    # server handler + epoch store (service.py SolverServer)
    alive: bool = True
    drain: bool = False
    over: int = 0  # admission gate rejects this many more solves
    se: int = 0  # stored epoch id for the client (0 = none)
    sv: int = 0  # ghost: section version actually stored
    ssnap: bool = False  # stored sections came from a snapshot request
    pend: tuple = ()  # handler micro-ops: ("store",e,v,snap)/("send",f)/("close",)
    refusals: int = 0  # drain refusals sent on the CURRENT connection
    owed: int = 0  # received solve frames not yet answered (this conn)
    conn: bool = False  # the client connection is open
    # the fault-capable channel
    c2s: tuple = ()
    s2c: tuple = ()
    # budget counters (bounded => exploration terminates)
    ticks: int = 0
    faults: int = 0


def initial_world(scn: Scenario) -> World:
    return World(over=scn.over0)


def done(cfg: Config, w: World) -> bool:
    return w.solve >= cfg.scenario.n_solves and w.phase == "idle"


def canonical(w: World) -> tuple:
    """Hashable canonical form: epoch ids renumbered densely in order of
    first occurrence, so states differing only in epoch labeling dedup
    to one BFS node (the renumbering is what keeps the store/commit
    machinery finite-state under resyncs and restarts)."""
    mapping: dict[int, int] = {0: 0}

    def ren(e: int) -> int:
        if e not in mapping:
            mapping[e] = len(mapping)
        return mapping[e]

    def ren_frame(f: tuple) -> tuple:
        k = f[0]
        if k == "SOLVE":
            return (k, f[1], ren(f[2]), f[3])
        if k == "DELTA":
            return (k, f[1], ren(f[2]), f[3], ren(f[4]), f[5])
        if k == "RESULT":
            return (k, f[1], ren(f[2]), f[3])
        return f

    t = dataclasses.astuple(w)
    d = dataclasses.asdict(w)
    d["acked_e"] = ren(w.acked_e)
    d["se"] = ren(w.se)
    d["pend"] = tuple(
        ("store", ren(op[1]), op[2], op[3])
        if op[0] == "store"
        else (("send", ren_frame(op[1])) if op[0] == "send" else op)
        for op in w.pend
    )
    d["c2s"] = tuple(ren_frame(f) for f in w.c2s)
    d["s2c"] = tuple(ren_frame(f) for f in w.s2c)
    assert len(t) == len(d)
    return tuple(d.values())


# -- transition helpers -----------------------------------------------------


def _stale(frames: tuple) -> tuple:
    return tuple((f[0], False) + tuple(f[2:]) for f in frames)


def _dead_handler_unwind(w: World) -> dict:
    """The old connection's handler finishes against a closed socket:
    pending stores land in program order until the first send raises
    (EPIPE), which unwinds the handler — everything after (including an
    answer-then-store's late store) is genuinely lost, exactly as in
    the real code. Collapsed to one atomic action at reconnect to keep
    the model single-handler."""
    se, sv, ssnap = w.se, w.sv, w.ssnap
    for op in w.pend:
        if op[0] == "store":
            se, sv, ssnap = op[1], op[2], op[3]
        elif op[0] == "send":
            break
    return dict(pend=(), se=se, sv=sv, ssnap=ssnap, refusals=0, owed=0)


def _br_fail(w: World) -> dict:
    """record_failure: half-open or threshold -> open (fresh cooldown)."""
    brf = w.brf + 1
    if w.br == "half" or brf >= BR_THRESHOLD:
        return dict(br="open", brf=brf, brcool=BR_COOLDOWN_TICKS, probe=False)
    return dict(br=w.br, brf=brf, probe=False)


def _br_success() -> dict:
    return dict(br="closed", brf=0, brcool=0, probe=False)


def _advance(cfg: Config, w: World, fields: dict) -> dict:
    """Complete the current solve and prepare the next one. The client
    MUTATES its live world here — with copy_sections off, a
    snapshot-established store aliases that memory and its ghost version
    silently drifts (an aliased-sections bug, reproduced)."""
    fields.update(
        solve=w.solve + 1, resyncs=0, wait_age=0, retries=0, phase="idle",
        sent="",
    )
    if not cfg.knobs.copy_sections and w.ssnap and fields.get("se", w.se) != 0:
        fields["sv"] = fields.get("sv", w.sv) + 1
    return fields


def _request_frame(w: World) -> tuple[str, tuple]:
    e = v = w.solve + 1
    if w.acked_e:
        return "delta", ("DELTA", True, w.acked_e, w.acked_v, e, v)
    return "snap", ("SOLVE", True, e, v)


def _emit(trace, ev: str, **fields) -> None:
    if trace is not None:
        fields["ev"] = ev
        fields.setdefault("thread", 0)
        fields["i"] = len(trace.events)
        trace.events.append(fields)


def _brname(state: str) -> str:
    return {"half": "half-open"}.get(state, state)


def _emit_fail(trace, prev: str, bf: dict) -> None:
    """record_failure + attempt-failed, in the order the real code
    records them (hybrid.py records the transition, then the attempt)."""
    _emit(
        trace, "breaker_failure", prev=_brname(prev),
        state=_brname(bf["br"]), failures=bf["brf"],
        threshold=BR_THRESHOLD, name="model",
    )
    _emit(trace, "attempt", outcome="failure", breaker=bf["br"])


class _Trace:
    """Mutable companion for trace_of: protorec-schema events plus the
    model's connection-generation counter (connection identity is an
    emission detail, deliberately NOT part of World)."""

    def __init__(self) -> None:
        self.events: list[dict] = []
        self.conn = 0


# -- the successor relation -------------------------------------------------


def step(
    cfg: Config, w: World, trace: Optional[_Trace] = None
) -> list[tuple[str, World, tuple]]:
    """All enabled transitions: (label, successor, violated-properties).
    Labels are deterministic — one label names exactly one successor —
    so a schedule of labels replays bit-identically (the corpus/shrink
    contract)."""
    out: list[tuple[str, World, tuple]] = []
    kn, scn = cfg.knobs, cfg.scenario
    budget_left = w.faults < scn.fault_budget

    def add(label: str, viol: tuple = (), **fields) -> None:
        out.append((label, replace(w, **fields), viol))

    client_active = w.solve < scn.n_solves

    # ---- client -----------------------------------------------------------
    if w.phase == "idle" and client_active:
        if w.backoff > 0:
            # admission backoff is checked BEFORE breaker.allow() — the
            # probe slot must not be claimed by a caller that then skips
            # the sidecar (hybrid.py backoff-before-allow comment)
            _emit(trace, "attempt", outcome="backoff", breaker=w.br)
            add("c_attempt", **_advance(cfg, w, dict(degrades=w.degrades + 1)))
        else:
            allowed, claimed = False, False
            brfields: dict = {}
            if w.br == "closed":
                allowed = True
            elif w.br == "open" and w.brcool == 0:
                allowed, claimed = True, True
                brfields = dict(br="half", probe=True, brcool=BR_COOLDOWN_TICKS)
            elif (
                w.br == "half"
                and w.probe
                and w.brcool == 0
                and kn.lost_probe_recovery
            ):
                allowed, claimed = True, True  # lost probe; caller takes over
                brfields = dict(brcool=BR_COOLDOWN_TICKS)
            if not allowed:
                _emit(
                    trace, "breaker_allow", granted=False, probe=False,
                    state={"half": "half-open"}.get(w.br, w.br),
                    failures=w.brf, threshold=BR_THRESHOLD, name="model",
                )
                _emit(trace, "attempt", outcome="breaker_denied", breaker=w.br)
                add(
                    "c_attempt",
                    **_advance(cfg, w, dict(degrades=w.degrades + 1)),
                )
            else:
                post = brfields.get("br", w.br)
                _emit(
                    trace, "breaker_allow", granted=True, probe=claimed,
                    state={"half": "half-open"}.get(post, post),
                    failures=w.brf, threshold=BR_THRESHOLD, name="model",
                )
                if not w.alive or (w.drain and not w.conn):
                    # connect refused (dead or stop()ed accept loop):
                    # bounded retry exhausts -> SolverUnavailable ->
                    # record_failure + in-process degrade
                    f = _br_fail(replace(w, **brfields))
                    _emit_fail(trace, post, f)
                    fields = dict(brfields)
                    fields.update(f)
                    add(
                        "c_attempt",
                        **_advance(
                            cfg, w, dict(fields, degrades=w.degrades + 1)
                        ),
                    )
                else:
                    mode, frame = _request_frame(w)
                    if trace is not None and not w.conn:
                        trace.conn += 1
                    fields = dict(brfields)
                    if w.conn:
                        # same socket: old frames stay in flight but the
                        # correlation tripwire marks them stale
                        fields.update(
                            c2s=_stale(w.c2s) + (frame,), s2c=_stale(w.s2c)
                        )
                    else:
                        # fresh socket: empty buffers, and the old conn's
                        # handler unwinds against the closed peer
                        fields.update(_dead_handler_unwind(w))
                        fields.update(c2s=(frame,), s2c=())
                    fields.update(
                        conn=True, phase="wait", sent=mode, wait_age=0
                    )
                    add("c_attempt", **fields)

    if w.phase == "wait" and w.s2c:
        f, rest = w.s2c[0], w.s2c[1:]
        kindmap = {
            "SOLVE": KIND_SOLVE, "DELTA": KIND_SOLVE_DELTA,
        }
        sent_kind = kindmap.get(
            {"snap": "SOLVE", "delta": "DELTA"}.get(w.sent, ""), KIND_SOLVE
        )
        if f[0] == "JUNK" or not f[1]:
            # corrupted framing or a stale response: poison the stream
            # (correlation tripwire), ProtocolError propagates ->
            # record_failure + in-process degrade
            bf = _br_fail(w)
            _emit_fail(trace, w.br, bf)
            add(
                "c_recv",
                **_advance(
                    cfg, w,
                    dict(
                        bf, degrades=w.degrades + 1, s2c=(), c2s=(),
                        conn=False,
                    ),
                ),
            )
        elif f[0] == "RESULT":
            bs = _br_success()
            _emit(
                trace, "cli_roundtrip", client="model", kind=sent_kind,
                resp_kind=KIND_RESULT, req_id=w.solve + 1,
            )
            _emit(
                trace, "breaker_success", prev=w.br, state="closed",
                failures=0, threshold=BR_THRESHOLD, name="model",
            )
            _emit(trace, "attempt", outcome="success", breaker="closed")
            _emit(
                trace, "cli_epoch_commit", client="model", epoch=f[2],
                mode={"snap": "snapshot"}.get(w.sent, "delta"),
            )
            add(
                "c_recv",
                **_advance(
                    cfg, w, dict(bs, acked_e=f[2], acked_v=f[3], s2c=rest)
                ),
            )
        elif f[0] == "RESYNC":
            _emit(
                trace, "cli_roundtrip", client="model", kind=sent_kind,
                resp_kind=KIND_EPOCH_RESYNC, req_id=w.solve + 1,
            )
            viol = ()
            if w.sent == "snap":
                viol = (
                    (
                        "proto-resync-one-hop",
                        "a full-snapshot SOLVE was answered EPOCH_RESYNC: "
                        "the always-correct fallback has no fallback — the "
                        "client would loop",
                    ),
                )
            elif w.resyncs + 1 > 1:
                viol = (
                    (
                        "proto-resync-one-hop",
                        f"solve {w.solve} consumed {w.resyncs + 1} resync "
                        "hops; the contract is exactly one (delta -> "
                        "snapshot) per solve",
                    ),
                )
            add(
                "c_recv",
                viol,
                # capped: past 2 the one-hop property has already fired,
                # and an uncapped counter would make the broken
                # snapshot_resyncable model's state space infinite
                resyncs=min(w.resyncs + 1, 2),
                acked_e=0,
                acked_v=0,
                phase="idle",
                sent="",
                wait_age=0,
                s2c=rest,
            )
        elif f[0] == "RETRY":
            fields: dict
            if kn.retry_resolves_probe:
                fields = _br_success()
                _emit(
                    trace, "cli_roundtrip", client="model", kind=sent_kind,
                    resp_kind=KIND_RETRY, req_id=w.solve + 1,
                )
                _emit(
                    trace, "breaker_success", prev=w.br, state="closed",
                    failures=0, threshold=BR_THRESHOLD, name="model",
                )
            else:
                fields = {}
                _emit(
                    trace, "cli_roundtrip", client="model", kind=sent_kind,
                    resp_kind=KIND_RETRY, req_id=w.solve + 1,
                )
            post = fields.get("br", w.br)
            _emit(trace, "attempt", outcome="overloaded", breaker=post)
            viol = ()
            if post != "closed":
                viol = (
                    (
                        "proto-breaker-wedge",
                        "an admission RETRY round-tripped (the server is "
                        f"healthy) yet left the breaker {post!r}: the "
                        "half-open probe is stranded and every caller "
                        "degrades in-process for a cooldown it never owed",
                    ),
                )
            fields.update(backoff=f[2], degrades=w.degrades + 1, s2c=rest)
            add("c_recv", viol, **_advance(cfg, w, fields))
        elif f[0] == "ERRDRAIN":
            bf = _br_fail(w)
            _emit(
                trace, "cli_roundtrip", client="model", kind=sent_kind,
                resp_kind=KIND_ERROR, req_id=w.solve + 1,
            )
            _emit_fail(trace, w.br, bf)
            add(
                "c_recv",
                **_advance(
                    cfg, w, dict(bf, degrades=w.degrades + 1, s2c=rest)
                ),
            )
        elif f[0] == "ERROR":
            bf = _br_fail(w)
            _emit_fail(trace, w.br, bf)
            add(
                "c_recv",
                **_advance(
                    cfg, w, dict(bf, degrades=w.degrades + 1, s2c=rest)
                ),
            )

    if (
        w.phase == "wait"
        and kn.client_deadline
        and w.wait_age >= DEADLINE_TICKS
    ):
        bf = _br_fail(w)
        _emit_fail(trace, w.br, bf)
        add(
            "c_timeout",
            **_advance(
                cfg, w,
                dict(bf, degrades=w.degrades + 1, conn=False, c2s=(), s2c=()),
            ),
        )

    if w.phase == "wait" and not w.conn and not w.s2c:
        # the connection died under the request: _roundtrip resends
        # (bounded), then SolverUnavailable -> failure + degrade
        if w.retries < MAX_RETRIES and w.alive and not w.drain:
            mode = w.sent or "snap"
            frame = _request_frame(replace(w, acked_e=w.acked_e if mode == "delta" else 0))[1]
            if trace is not None:
                trace.conn += 1
            fields = _dead_handler_unwind(w)
            fields.update(
                retries=w.retries + 1, conn=True, c2s=(frame,), wait_age=0
            )
            add("c_conn_lost", **fields)
        else:
            bf = _br_fail(w)
            _emit_fail(trace, w.br, bf)
            add(
                "c_conn_lost",
                **_advance(cfg, w, dict(bf, degrades=w.degrades + 1)),
            )

    # ---- server -----------------------------------------------------------
    if w.alive and w.conn and not w.pend and w.c2s:
        f, rest = w.c2s[0], w.c2s[1:]
        if trace is not None:
            wire = {"SOLVE": KIND_SOLVE, "DELTA": KIND_SOLVE_DELTA}.get(f[0], 0)
            _emit(
                trace, "srv_recv", kind=wire, req_id=0, conn=trace.conn,
                draining=w.drain,
            )
        if f[0] == "JUNK":
            add(
                "s_recv",
                c2s=rest,
                pend=(("send", ("ERROR", f[1])), ("close",)),
            )
        elif w.drain:
            viol = ()
            refusals = w.refusals + 1
            if kn.drain_mode == "close_silent":
                pend: tuple = (("close",),)
                refusals = w.refusals
            elif kn.drain_single_refusal:
                pend = (("send", ("ERRDRAIN", f[1])), ("close",))
            else:
                pend = (("send", ("ERRDRAIN", f[1])),)
            if refusals > 1:
                viol = (
                    (
                        "proto-drain-bounded",
                        "a handler served a SECOND drain refusal on one "
                        "connection: a fast-sending peer holds its thread "
                        "and socket past stop()'s bounded join",
                    ),
                )
            add(
                "s_recv", viol, c2s=rest, pend=pend, refusals=refusals,
                owed=w.owed + 1,
            )
        elif w.over > 0:
            add(
                "s_recv",
                c2s=rest,
                over=w.over - 1,
                pend=(("send", ("RETRY", f[1], 1)),),
                owed=w.owed + 1,
            )
        elif f[0] == "SOLVE":
            if kn.snapshot_resyncable and w.se == 0:
                pend = (("send", ("RESYNC", f[1])),)
            else:
                store = ("store", f[2], f[3], True)
                send = ("send", ("RESULT", f[1], f[2], f[3]))
                pend = (store, send) if kn.store_before_answer else (send, store)
            add("s_recv", c2s=rest, pend=pend, owed=w.owed + 1)
        elif f[0] == "DELTA":
            if w.se != f[2]:
                add(
                    "s_recv", c2s=rest,
                    pend=(("send", ("RESYNC", f[1])),), owed=w.owed + 1,
                )
            else:
                applied = w.sv + (f[5] - f[3])
                viol = ()
                if applied != f[5]:
                    viol = (
                        (
                            "proto-epoch-consistent",
                            "silent epoch divergence: the delta applied "
                            f"cleanly (epoch ids match) but materialized "
                            f"version {applied} != the client's {f[5]} — "
                            "the stored sections were not a private copy",
                        ),
                    )
                store = ("store", f[4], applied, False)
                send = ("send", ("RESULT", f[1], f[4], f[5]))
                pend = (store, send) if kn.store_before_answer else (send, store)
                add("s_recv", viol, c2s=rest, pend=pend, owed=w.owed + 1)

    if w.alive and w.pend:
        op, rest = w.pend[0], w.pend[1:]
        if op[0] == "store":
            _emit(trace, "srv_epoch_store", client="model", epoch=op[1])
            add("s_step", pend=rest, se=op[1], sv=op[2], ssnap=op[3])
        elif op[0] == "send":
            f = op[1]
            if w.conn:
                if trace is not None:
                    wire = {
                        "RESULT": KIND_RESULT, "RESYNC": KIND_EPOCH_RESYNC,
                        "RETRY": KIND_RETRY, "ERRDRAIN": KIND_ERROR,
                        "ERROR": KIND_ERROR,
                    }[f[0]]
                    _emit(
                        trace, "srv_send", kind=wire, req_id=0,
                        conn=trace.conn, draining=w.drain,
                        refusal=f[0] == "ERRDRAIN",
                    )
                add(
                    "s_step",
                    pend=rest,
                    owed=max(0, w.owed - 1),
                    s2c=w.s2c + (f,),
                )
            else:
                # dead socket: the send raises EPIPE and the handler
                # unwinds — every later micro-op is lost
                add("s_step", pend=(), owed=0, refusals=0)
        else:  # close
            viol = ()
            if w.owed > 0 and w.drain:
                viol = (
                    (
                        "proto-drain-bounded",
                        "silent drain close: a solve frame received during "
                        "stop() was closed UNANSWERED — the client waits "
                        "out its full deadline instead of degrading now",
                    ),
                )
            _emit(trace, "srv_close", conn=trace.conn if trace else 0, draining=w.drain)
            add(
                "s_step", viol, pend=rest, conn=False, refusals=0, owed=0,
                c2s=(),
            )

    if w.alive and w.drain and w.conn and not w.pend and not w.c2s:
        _emit(trace, "srv_close", conn=trace.conn if trace else 0, draining=True)
        add("s_drain_close", conn=False, refusals=0, owed=0)

    # ---- environment ------------------------------------------------------
    if scn.allow_drain and w.alive and not w.drain:
        add("a_drain", drain=True)

    if not w.alive:
        add("a_server_up", alive=True)

    if budget_left:
        fb = w.faults + 1
        if "kill_server" in scn.faults and w.alive:
            add(
                "f_kill_server", alive=False, drain=False, conn=False,
                se=0, sv=0, ssnap=False, pend=(), over=0, refusals=0,
                owed=0, c2s=(), faults=fb,
            )
        if "kill_conn" in scn.faults and w.conn:
            add("f_kill_conn", conn=False, c2s=(), s2c=(), faults=fb)
        if "drop_c2s" in scn.faults and w.c2s:
            add("f_drop_c2s", c2s=w.c2s[1:], faults=fb)
        if "drop_s2c" in scn.faults and w.s2c:
            add("f_drop_s2c", s2c=w.s2c[1:], faults=fb)
        if "dup_c2s" in scn.faults and w.c2s and len(w.c2s) < 3:
            add("f_dup_c2s", c2s=(w.c2s[0],) + w.c2s, faults=fb)
        if "dup_s2c" in scn.faults and w.s2c and len(w.s2c) < 3:
            add("f_dup_s2c", s2c=(w.s2c[0],) + w.s2c, faults=fb)
        if "reorder_c2s" in scn.faults and len(w.c2s) >= 2:
            add(
                "f_reorder_c2s",
                c2s=(w.c2s[1], w.c2s[0]) + w.c2s[2:],
                faults=fb,
            )
        if "reorder_s2c" in scn.faults and len(w.s2c) >= 2:
            add(
                "f_reorder_s2c",
                s2c=(w.s2c[1], w.s2c[0]) + w.s2c[2:],
                faults=fb,
            )
        if "trunc_c2s" in scn.faults and w.c2s:
            add(
                "f_trunc_c2s",
                c2s=(("JUNK", w.c2s[0][1]),) + w.c2s[1:],
                faults=fb,
            )
        if "trunc_s2c" in scn.faults and w.s2c:
            add(
                "f_trunc_s2c",
                s2c=(("JUNK", w.s2c[0][1]),) + w.s2c[1:],
                faults=fb,
            )

    if w.ticks < scn.max_ticks and (
        (w.phase == "wait" and kn.client_deadline and w.wait_age < DEADLINE_TICKS)
        or w.backoff > 0
        or w.brcool > 0
    ):
        add(
            "tick",
            ticks=w.ticks + 1,
            wait_age=w.wait_age + 1
            if (w.phase == "wait" and w.wait_age < DEADLINE_TICKS)
            else w.wait_age,
            backoff=max(0, w.backoff - 1),
            brcool=max(0, w.brcool - 1),
        )

    return out


# -- exploration, replay, shrink --------------------------------------------


@dataclass
class Counterexample:
    rule: str
    scenario: str
    knobs: Knobs
    schedule: list
    message: str

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "scenario": self.scenario,
            "knobs": dataclasses.asdict(self.knobs),
            "schedule": list(self.schedule),
            "message": self.message,
            "repro": REPRO_HINT,
        }


REPRO_HINT = "pytest tests/test_torch_analysis_proto.py -k corpus -q"


@dataclass
class ExploreResult:
    scenario: str
    states: int
    truncated: bool
    seconds: float
    counterexamples: list


def explore(cfg: Config, stop_on_first: bool = False) -> ExploreResult:
    """Breadth-first exploration with canonical dedup: the FIRST
    counterexample found per property is a shortest one (every
    transition is one label). Deadlock (a live client with no enabled
    transition) violates proto-converge. `stop_on_first` abandons the
    frontier once any property has a counterexample — the
    deliberately-broken models in tests use it; the real tier always
    runs to exhaustion (or its recorded budget)."""
    t0 = time.monotonic()
    scn = cfg.scenario
    w0 = initial_world(scn)
    seen = {canonical(w0)}
    parent: dict[tuple, tuple] = {}  # canon -> (parent canon, label)
    frontier = deque([(w0, canonical(w0))])
    ces: dict[str, Counterexample] = {}
    truncated = False

    def path_to(key: tuple, last: Optional[str] = None) -> list:
        labels: list[str] = []
        while key in parent:
            key, lab = parent[key]
            labels.append(lab)
        labels.reverse()
        if last is not None:
            labels.append(last)
        return labels

    while frontier:
        if stop_on_first and ces:
            break
        w, key = frontier.popleft()
        if done(cfg, w):
            continue
        succs = step(cfg, w)
        if not succs:
            if step(cfg, replace(w, ticks=0)):
                # only the tick budget blocks progress: that is the
                # exploration bound biting, not a protocol deadlock —
                # report truncation, never a phantom converge violation
                truncated = True
                continue
            if "proto-converge" not in ces:
                ces["proto-converge"] = Counterexample(
                    "proto-converge", scn.name, cfg.knobs, path_to(key),
                    f"deadlock: solve {w.solve}/{scn.n_solves} can never "
                    "complete (no transition is enabled; the client waits "
                    "forever)",
                )
            continue
        for label, w2, viols in succs:
            for rule, msg in viols:
                if rule not in ces:
                    ces[rule] = Counterexample(
                        rule, scn.name, cfg.knobs, path_to(key, label), msg
                    )
            k2 = canonical(w2)
            if k2 in seen:
                continue
            if len(seen) >= scn.max_states:
                truncated = True
                continue
            seen.add(k2)
            parent[k2] = (key, label)
            frontier.append((w2, k2))

    return ExploreResult(
        scn.name, len(seen), truncated, time.monotonic() - t0,
        list(ces.values()),
    )


def replay(
    cfg: Config, schedule: Iterable[str]
) -> tuple[Optional[World], list]:
    """Deterministically re-run a label schedule. Returns (final world,
    violations seen); (None, []) if some label was not enabled (an
    invalid shrink candidate). A final live-but-stuck world appends the
    proto-converge deadlock violation, so converge counterexamples
    replay too."""
    w = initial_world(cfg.scenario)
    seen_viols: list = []
    for label in schedule:
        succs = {lab: (w2, v) for lab, w2, v in step(cfg, w)}
        if label not in succs:
            return None, []
        w, viols = succs[label]
        seen_viols.extend(viols)
    if (
        not done(cfg, w)
        and not step(cfg, w)
        and not step(cfg, replace(w, ticks=0))  # tick budget != deadlock
    ):
        seen_viols.append(("proto-converge", "deadlock"))
    return w, seen_viols


def shrink(cfg: Config, ce: Counterexample) -> Counterexample:
    """Greedy delta-shrink: drop one label at a time while the replay
    still violates the same property. BFS already returned a shortest
    PATH; shrinking prunes labels that only pad the schedule (extra
    ticks, unrelated faults), leaving the minimal fault story to pin in
    the corpus."""
    schedule = list(ce.schedule)
    changed = True
    while changed:
        changed = False
        for i in range(len(schedule) - 1, -1, -1):
            candidate = schedule[:i] + schedule[i + 1 :]
            _, viols = replay(cfg, candidate)
            if any(rule == ce.rule for rule, _ in viols):
                schedule = candidate
                changed = True
    return Counterexample(ce.rule, ce.scenario, ce.knobs, schedule, ce.message)


def trace_of(cfg: Config, schedule: Iterable[str]) -> list[dict]:
    """Replay a schedule while emitting protorec-schema events — the
    bridge that lets model runs be judged by the SAME acceptors as
    recorded real traces (model soundness half of the refinement story;
    the tests pin real-knob model traces clean)."""
    w = initial_world(cfg.scenario)
    tr = _Trace()
    for label in schedule:
        # step() emits for EVERY enabled transition; run one
        # trace-enabled pass, keep only the chosen label's slice. The
        # conn counter stays consistent because the only incrementers
        # (c_attempt / c_conn_lost while disconnected) are mutually
        # exclusive with every server-side emitter (which needs w.conn).
        probe = _Trace()
        probe.conn = tr.conn
        slices: dict[str, tuple[int, int]] = {}
        succs: dict[str, World] = {}
        start = 0
        for lab, w2, _ in step(cfg, w, trace=probe):
            slices[lab] = (start, len(probe.events))
            succs[lab] = w2
            start = len(probe.events)
        if label not in succs:
            raise ValueError(f"label {label!r} not enabled during trace_of")
        lo, hi = slices[label]
        for e in probe.events[lo:hi]:
            e["i"] = len(tr.events)
            tr.events.append(e)
        if label in ("c_attempt", "c_conn_lost") and succs[label].conn and not w.conn:
            tr.conn = probe.conn
        w = succs[label]
    return tr.events


# -- refinement: judging recorded traces ------------------------------------


def check_refinement(events: list[dict]) -> list[str]:
    """Is this recorded trace an accepted behavior of the model? The
    acceptors encode the model's transition discipline over the
    protorec event schema; a violation names the broken contract and
    the offending events. Used three ways: on the traces the port's
    service and resilient tests and chip_smoke.py's sidecar phase record,
    on the live scenarios `--proto` drives, and on model-generated traces
    (tests pin both directions)."""
    out: list[str] = []
    out += _check_breaker_legality(events)
    out += _check_attempt_obligations(events)
    out += _check_drain_conns(events)
    out += _check_epoch_commits(events)
    out += _check_client_roundtrips(events)
    return out


def _check_breaker_legality(events: list[dict]) -> list[str]:
    out = []
    for e in events:
        ev = e.get("ev")
        if ev == "breaker_allow":
            st, granted, probe = e.get("state"), e.get("granted"), e.get("probe")
            if granted and st == "closed" and probe:
                out.append(f"breaker: closed allow claimed a probe: {e}")
            elif granted and st == "half-open" and not probe:
                out.append(
                    f"breaker: half-open allow without the probe slot: {e}"
                )
            elif granted and st == "open":
                out.append(f"breaker: allow granted while open: {e}")
            elif not granted and st == "closed":
                out.append(f"breaker: allow denied while closed: {e}")
        elif ev == "breaker_success":
            if e.get("state") != "closed" or e.get("failures", 0) != 0:
                out.append(
                    f"breaker: record_success must close and zero: {e}"
                )
        elif ev == "breaker_failure":
            prev, st = e.get("prev"), e.get("state")
            must_open = prev in ("half-open", "open") or e.get(
                "failures", 0
            ) >= e.get("threshold", 1)
            if must_open and st != "open":
                out.append(
                    f"breaker: failure at/past threshold (or on a probe) "
                    f"must open: {e}"
                )
            if not must_open and st != "closed":
                out.append(f"breaker: premature open: {e}")
    return out


def _check_attempt_obligations(events: list[dict]) -> list[str]:
    """Per-thread request discipline: a granted allow() must be resolved
    by the matching record_* BEFORE the attempt outcome is declared —
    the RETRY-records-success rule makes `overloaded` require a
    breaker_success (hybrid.py admission-rejection branch); reverting it
    strands the probe and fails HERE, with the event pair named."""
    out = []
    lanes: dict[tuple, dict] = {}
    for e in events:
        ev = e.get("ev")
        if ev not in ("breaker_allow", "breaker_success", "breaker_failure", "attempt"):
            continue
        key = (e.get("thread"), e.get("name", ""))
        if ev == "attempt":
            # attempt events carry no breaker name; match any lane of
            # the thread (the solver drives one breaker per attempt)
            cand = [k for k in lanes if k[0] == e.get("thread")]
            lane = lanes.get(cand[0]) if cand else None
            outcome = e.get("outcome")
            if outcome in ("success", "overloaded"):
                if lane is None or not lane.get("granted"):
                    out.append(f"attempt {outcome!r} without a granted allow: {e}")
                elif not lane.get("success"):
                    tag = (
                        " — the half-open probe is STRANDED (RETRY must "
                        "record_success)"
                        if outcome == "overloaded" and lane.get("probe")
                        else ""
                    )
                    out.append(
                        f"attempt {outcome!r} without record_success{tag}: {e}"
                    )
            elif outcome == "failure":
                if lane is None or not lane.get("granted"):
                    out.append(f"attempt 'failure' without a granted allow: {e}")
                elif not lane.get("failure"):
                    out.append(f"attempt 'failure' without record_failure: {e}")
            elif outcome == "breaker_denied":
                if lane is None or lane.get("granted"):
                    out.append(
                        f"attempt 'breaker_denied' without a denied allow: {e}"
                    )
            elif outcome == "backoff":
                if lane is not None:
                    out.append(
                        "attempt 'backoff' after allow(): backoff must be "
                        f"checked BEFORE the probe is claimed: {e}"
                    )
            for k in cand:
                lanes.pop(k, None)
        elif ev == "breaker_allow":
            lanes[key] = {
                "granted": bool(e.get("granted")),
                "probe": bool(e.get("probe")),
                "success": False,
                "failure": False,
            }
        elif key in lanes:
            lanes[key]["success" if ev == "breaker_success" else "failure"] = True
    return out


def _check_drain_conns(events: list[dict]) -> list[str]:
    out = []
    conns: dict[int, dict] = {}
    for e in events:
        ev = e.get("ev")
        if ev not in ("srv_recv", "srv_send", "srv_close"):
            continue
        c = conns.setdefault(
            e.get("conn"), {"owed": [], "refusals": 0, "refused": False}
        )
        if ev == "srv_recv":
            if e.get("kind") in _SOLVE_KINDS:
                c["owed"].append(bool(e.get("draining")))
        elif ev == "srv_send":
            if c["refused"]:
                out.append(
                    f"drain: a frame was sent AFTER the refusal on conn "
                    f"{e.get('conn')} (one refusal, then close): {e}"
                )
            if e.get("kind") in _RESPONSE_KINDS and c["owed"]:
                c["owed"].pop(0)
            if e.get("refusal"):
                c["refusals"] += 1
                c["refused"] = True
                if c["refusals"] > 1:
                    out.append(
                        f"drain: second refusal on conn {e.get('conn')}: {e}"
                    )
        else:  # srv_close
            if c["owed"] and (e.get("draining") or any(c["owed"])):
                out.append(
                    f"drain: silent close — {len(c['owed'])} received solve "
                    f"frame(s) on conn {e.get('conn')} closed unanswered "
                    f"during drain: {e}"
                )
            conns.pop(e.get("conn"), None)
    return out


def _check_epoch_commits(events: list[dict]) -> list[str]:
    """Commit-implies-store, with the mixed-version carve-out: a
    DELTA commit requires a prior store (the server solved from sections
    it must hold), and a store that exists must PRECEDE the commit
    riding its answer (the store-before-answer fix). A snapshot commit
    with no store at all is accepted — that is the pre-epoch peer
    (mixed-version rollout: the old server ignores the epoch key), and
    the acked state is a deliberate fiction the first delta's
    'unknown kind' downgrade corrects (service.py pre-epoch branch)."""
    out = []
    first_store: dict = {}
    for pos, e in enumerate(events):
        if e.get("ev") in ("srv_epoch_store", "srv_epoch_store_skipped"):
            first_store.setdefault((e.get("client"), e.get("epoch")), pos)
    for pos, e in enumerate(events):
        if e.get("ev") != "cli_epoch_commit":
            continue
        # the model emits client="model" on both sides; real traces
        # carry the wire client id on both hooks
        stored_at = first_store.get(
            (e.get("client"), e.get("epoch")),
            first_store.get(("model", e.get("epoch"))),
        )
        if stored_at is not None and stored_at < pos:
            continue
        if stored_at is not None:
            out.append(
                "epoch: the server stored epoch "
                f"{e.get('epoch')!r} AFTER the client committed it — "
                f"store must precede answer: {e}"
            )
        elif e.get("mode") != "snapshot":
            out.append(
                "epoch: client committed epoch "
                f"{e.get('epoch')!r} that the server never stored (nor "
                f"deliberately skipped) — store must precede answer: {e}"
            )
    return out


def _check_client_roundtrips(events: list[dict]) -> list[str]:
    out = []
    must_snapshot: dict = {}
    for e in events:
        if e.get("ev") != "cli_roundtrip":
            continue
        k, rk, cl = e.get("kind"), e.get("resp_kind"), e.get("client")
        if k not in _SOLVE_KINDS:
            continue
        if k == KIND_SOLVE and rk == KIND_EPOCH_RESYNC:
            out.append(
                f"resync: a full-snapshot SOLVE was answered EPOCH_RESYNC "
                f"(the fallback has no fallback): {e}"
            )
        if must_snapshot.get(cl) and k != KIND_SOLVE:
            out.append(
                f"resync: after EPOCH_RESYNC the next solve frame must be "
                f"the full snapshot, got kind {k}: {e}"
            )
        must_snapshot[cl] = k == KIND_SOLVE_DELTA and rk == KIND_EPOCH_RESYNC
    return out


def shrink_trace(events: list[dict], violation: str) -> list[dict]:
    """Minimal violating sub-trace for a conformance finding: keep only
    the events whose stream (conn / thread / client) the violation
    implicates, so the repro in the report reads as the few frames that
    matter, not the whole fault matrix."""
    for sub_len in range(1, len(events) + 1):
        sub = events[:sub_len]
        if violation in check_refinement(sub):
            last = sub[-1]
            keys = {
                ("conn", last.get("conn")),
                ("thread", last.get("thread")),
                ("client", last.get("client")),
            }
            kept = [
                e
                for e in sub
                if any(e.get(k) == v for k, v in keys if v is not None)
            ]
            if violation in check_refinement(kept):
                return kept
            return sub
    return events


# -- live conformance scenarios ---------------------------------------------


def _empty_decoded() -> dict:
    return {
        "new_node_claims": [],
        "existing_assignments": {},
        "pod_errors": {},
        "timed_out": False,
    }


def live_breaker_scenario() -> list[dict]:
    """Drive the REAL ResilientSolver + CircuitBreaker through the
    pinned recovery story on a fake clock: two transport failures open
    the breaker, the cooldown elapses, the half-open probe lands on an
    admission RETRY (which MUST resolve it to closed —
    hybrid.py:~612), and the immediate next attempt reaches the
    sidecar. Recorded via protorec and judged by check_refinement: if
    the RETRY-records-success line is reverted, the trace itself fails
    (stranded-probe obligation), not a hand-written assert."""
    from karpenter_tpu_torch.analysis import protorec
    from karpenter_tpu_torch.solver import hybrid
    from karpenter_tpu_torch.solver.epochs import SolverOverloaded
    from karpenter_tpu_torch.solver.service import SolverUnavailable

    clock = {"t": 0.0}

    def fail():
        raise SolverUnavailable("sidecar unreachable (scripted)")

    def overloaded():
        raise SolverOverloaded(
            "admission rejected (scripted)",
            backoff_hint_seconds=0.0,
            queue_depth=1,
        )

    script = [fail, fail, overloaded, _empty_decoded]

    class _Scripted:
        def solve(self, *args, **kwargs):
            return script.pop(0)()

    rs = hybrid.ResilientSolver(
        client=_Scripted(),
        failure_threshold=2,
        cooldown_seconds=10.0,
        clock=lambda: clock["t"],
        device="cpu",  # the in-process floor: the oracle here
    )
    rec = protorec.install()
    try:
        for advance in (0.0, 0.0, 0.0, 11.0, 0.0):
            clock["t"] += advance
            rs.solve([], {}, [], force_oracle=True)
        # deliberately NO assertion that the script was fully consumed:
        # the refinement acceptors are the judge. With the RETRY-records-
        # success line reverted, attempt 4's `overloaded` event arrives
        # without its breaker_success and check_refinement names the
        # stranded probe — a finding (exit 1), not a crashed gate (2).
        return rec.snapshot()
    finally:
        protorec.uninstall()


def live_drain_scenario() -> list[dict]:
    """Drive a REAL SolverServer through the drain contract on raw
    sockets: one connection holds an in-flight solve across stop() (its
    RESULT must flush), a second sends a fresh SOLVE during the drain
    window (it must get the one retriable refusal, then close). The
    PING right before stop() re-phases the handler's poll so the
    post-stop SOLVE lands inside the grace read, same determinism
    discipline as tests/test_service_faults.py's drain tests."""
    import socket
    import struct
    import tempfile
    import threading

    from karpenter_tpu_torch.analysis import protorec
    from karpenter_tpu_torch.solver import service

    release = threading.Event()

    class _SlowServer(service.SolverServer):
        def _solve(self, payload: bytes, req_id: int = 0) -> bytes:
            release.wait(10.0)
            return b"{}"

    def send(sock, kind, payload=b"{}", req_id=1):
        sock.sendall(
            service.MAGIC
            + struct.pack("<III", kind, req_id, len(payload))
            + payload
        )

    def read_frame(sock):
        head = b""
        while len(head) < service.HEADER_LEN:
            chunk = sock.recv(service.HEADER_LEN - len(head))
            if not chunk:
                return None
            head += chunk
        kind, req_id, length = struct.unpack("<III", head[4:])
        body = b""
        while len(body) < length:
            body += sock.recv(length - len(body))
        return kind, req_id, body

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "solver.sock")
        srv = _SlowServer(path, drain_seconds=5.0, device="cpu")
        rec = protorec.install()
        stopper = None
        try:
            srv.start()
            s1 = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s1.settimeout(10.0)
            s1.connect(path)
            s2 = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s2.settimeout(10.0)
            s2.connect(path)
            try:
                send(s1, service.KIND_SOLVE, req_id=7)  # in-flight, stalls
                # re-phase conn 2's idle poll right before the drain
                send(s2, service.KIND_PING, b"", req_id=8)
                assert read_frame(s2)[0] == service.KIND_PONG
                stopper = threading.Thread(target=srv.stop, daemon=True)
                stopper.start()
                while not srv._stop.is_set():
                    time.sleep(0.001)
                # a fresh solve inside the drain window: one retriable
                # refusal, then the connection closes
                send(s2, service.KIND_SOLVE, req_id=9)
                refusal = read_frame(s2)
                trailing = s2.recv(1)
                release.set()  # flush the in-flight RESULT on conn 1
                flushed = read_frame(s1)
                if refusal is not None and refusal[0] == service.KIND_ERROR:
                    pass  # the healthy answer; refinement judges the trace
                if flushed is not None and flushed[0] != service.KIND_RESULT:
                    raise RuntimeError(
                        f"in-flight solve flushed kind {flushed[0]}, "
                        "expected RESULT"
                    )
                del trailing
            finally:
                release.set()
                s1.close()
                s2.close()
            if stopper is not None:
                stopper.join(timeout=10.0)
            return rec.snapshot()
        finally:
            release.set()
            protorec.uninstall()
            if stopper is not None and stopper.is_alive():
                stopper.join(timeout=10.0)


LIVE_SCENARIOS: tuple = (
    ("live_breaker_retry", "karpenter_tpu_torch/solver/hybrid.py", live_breaker_scenario),
    ("live_drain", "karpenter_tpu_torch/solver/service.py", live_drain_scenario),
)


# -- the tier entry point ---------------------------------------------------

MODEL_PATH = "karpenter_tpu_torch/analysis/proto.py"


def emit_counterexample(ce: Counterexample, corpus_dir: str) -> str:
    """Serialize a shrunk counterexample into `corpus_dir`, as the
    reference writes its replay corpus. Canonical serialization — sorted
    keys, LF, trailing newline — so a re-emit of the same schedule is
    byte-identical."""
    os.makedirs(corpus_dir, exist_ok=True)
    path = os.path.join(corpus_dir, f"{ce.rule}__{ce.scenario}.json")
    with open(path, "w") as fh:
        json.dump(ce.to_json(), fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def replay_corpus_case(case: dict) -> list:
    """Re-run a corpus entry; returns the violated rule names."""
    scn = next(s for s in SCENARIOS if s.name == case["scenario"])
    cfg = Config(Knobs(**case["knobs"]), scn)
    _, viols = replay(cfg, case["schedule"])
    return sorted({rule for rule, _ in viols})


def run_proto_analysis(
    repo_root: str,
    baseline_path: Optional[str] = None,
    knobs: Knobs = REAL_KNOBS,
    scenarios: Optional[tuple] = None,
    live: bool = True,
    corpus_dir: Optional[str] = None,
    live_fns: Optional[tuple] = None,
) -> dict:
    """The protocol tier: model-check every scenario under `knobs`, run
    the live conformance scenarios, apply the proto baseline. Mirrors
    the other tiers' report shape ({"findings", "stale", "unjustified",
    "errors", "total"}) plus the exploration budgets ("scenarios") and
    per-property verdicts ("properties") — a truncated exploration is
    visible in the report, never silent. A shrunk counterexample is
    written into `corpus_dir` only when one is given."""
    baseline_path = (
        baseline_path
        if baseline_path is not None
        else os.path.join(repo_root, PROTO_DEFAULT_BASELINE)
    )
    # the shared corpus (tests/proto_corpus/) is the reference's data: the
    # port replays it and writes a counterexample only where asked
    corpus_dir = corpus_dir or ""

    findings: list[Finding] = []
    errors: list[str] = []
    scen_report: dict[str, dict] = {}
    properties = {rule: "ok" for rule in PROTO_RULES}

    for scn in scenarios if scenarios is not None else SCENARIOS:
        cfg = Config(knobs, scn)
        res = explore(cfg)
        scen_report[scn.name] = {
            "states": res.states,
            "truncated": res.truncated,
            "seconds": round(res.seconds, 3),
            "n_solves": scn.n_solves,
            "fault_budget": scn.fault_budget,
            "max_ticks": scn.max_ticks,
            "max_states": scn.max_states,
        }
        for ce in res.counterexamples:
            ce = shrink(cfg, ce)
            properties[ce.rule] = "violated"
            repro = REPRO_HINT
            if corpus_dir:
                try:
                    emit_counterexample(ce, corpus_dir)
                except OSError as e:
                    errors.append(f"corpus write failed: {e}")
            findings.append(
                Finding(
                    rule=ce.rule,
                    path=MODEL_PATH,
                    line=1,
                    message=(
                        f"[{ce.scenario}] {ce.message} | shrunk schedule "
                        f"({len(ce.schedule)} steps): "
                        f"{' '.join(ce.schedule)} | repro: {repro}"
                    ),
                    text=f"{ce.scenario}:{ce.rule}",
                )
            )

    conformance: dict[str, int] = {}
    if live:
        for name, path, fn in live_fns if live_fns is not None else LIVE_SCENARIOS:
            try:
                events = fn()
            except Exception as e:  # a broken gate, not a finding
                errors.append(f"{name}: {type(e).__name__}: {e}")
                continue
            conformance[name] = len(events)
            for violation in check_refinement(events):
                properties["proto-conformance"] = "violated"
                sub = shrink_trace(events, violation)
                findings.append(
                    Finding(
                        rule="proto-conformance",
                        path=path,
                        line=1,
                        message=(
                            f"[{name}] recorded trace does not refine the "
                            f"model: {violation} | minimal sub-trace "
                            f"({len(sub)} events): "
                            + "; ".join(
                                f"{e.get('ev')}({_fmt_event(e)})" for e in sub
                            )
                            + f" | repro: pytest tests/test_torch_analysis_proto.py"
                            f" -k {name} -q"
                        ),
                        text=f"{name}:{violation.split(':', 1)[0]}",
                    )
                )

    findings.sort(key=lambda f: (f.rule, f.path, f.text))
    baseline = Baseline.load(baseline_path)
    fresh, stale = baseline.apply(findings)
    return {
        "findings": fresh,
        "all_findings": findings,
        "stale": stale,
        "unjustified": baseline.unjustified(),
        "errors": errors,
        "total": len(fresh),
        "scenarios": scen_report,
        "properties": properties,
        "conformance": conformance,
    }


def _fmt_event(e: dict) -> str:
    skip = {"ev", "i", "thread"}
    return ",".join(
        f"{k}={v}" for k, v in e.items() if k not in skip and v is not None
    )
