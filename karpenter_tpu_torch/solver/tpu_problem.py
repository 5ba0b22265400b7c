"""Host-side encoding of a scheduling problem into dense tensors.

The encoder consumes a *constructed oracle Scheduler* (karpenter_tpu.solver
.oracle.Scheduler) so template filtering, daemon overhead, existing-node
ordering, and topology-group construction are byte-identical to the oracle —
the kernel then reproduces the oracle's per-pod decisions on tensors
(reference call stack: scheduler.go:377 Solve / nodeclaim.go:114 CanAdd).

Structural choices (SURVEY.md §7 "tensorization"):
- hostname is not a vocab key: a node IS its hostname domain, so hostname
  topologies count per node-slot (existing nodes then claim slots);
- every other topology key counts per vocab value id ("zone-family");
- instance types live in one global table; each template owns a bitmask of
  it; each claim carries a surviving-types bitmask.

Problems the tensor encoding can't express exactly raise UnsupportedBySolver
and the caller falls back to the oracle (the hybrid dispatch documented in
solver/tpu.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import NodeInclusionPolicy, Operator, Pod
from karpenter_tpu_torch.ops.encode import Reqs, empty_reqs, encode_requirements
from karpenter_tpu_torch.ops.vocab import ResourceTable, UnsupportedProblem, Vocab, WORD_BITS
from karpenter_tpu_torch.scheduling import Requirements, Taints
from karpenter_tpu_torch.scheduling.hostports import get_host_ports
from karpenter_tpu_torch.solver import buckets
from karpenter_tpu_torch.solver.oracle import Scheduler
from karpenter_tpu_torch.solver.topology import TopologyGroup, TopologyType
from karpenter_tpu_torch.utils import resources as res


class UnsupportedBySolver(Exception):
    """Problem uses a feature outside the tensor encoding; use the oracle."""


TERMINAL_PHASES = ("Succeeded", "Failed")


# topology-slot kinds in the per-pod constraint table
TOPO_NONE = 0
TOPO_SPREAD_V = 1  # zone-family (vocab-key) spread
TOPO_AFFINITY_V = 2
TOPO_ANTI_V = 3
TOPO_SPREAD_H = 4  # hostname-family
TOPO_AFFINITY_H = 5
TOPO_ANTI_H = 6

# hard cap on per-pod constraint slots; the encoded table is sized to the
# actual per-problem maximum (usually 1) so the kernel's unrolled topology
# evaluation stays as small as the problem allows
MAX_OWNED_TOPOLOGIES = 8
MAX_FILTER_ALTERNATIVES = 2


@dataclass
class VGroup:
    """Zone-family group: domain counts per vocab value id of its key."""

    group: TopologyGroup
    kid: int
    skew: int
    min_domains: int  # -1 = unset
    # filter alternative indices into the stacked filter Reqs (-1 = none)
    filt: tuple[int, int] = (-1, -1)


@dataclass
class HGroup:
    """Hostname-family group: domain counts per node slot."""

    group: TopologyGroup
    skew: int
    inverse: bool
    filt: tuple[int, int] = (-1, -1)


@dataclass
class EncodedProblem:
    vocab: Vocab
    table: ResourceTable
    scheduler: Scheduler  # the oracle object encoding was derived from

    # dims
    num_templates: int = 0
    num_types: int = 0
    num_existing: int = 0
    max_claims: int = 0
    vmax: int = 0

    # templates [T]
    treq: Optional[Reqs] = None
    tdaemon: Optional[np.ndarray] = None  # [T, R] i32 initial claim requests
    ttypes: Optional[np.ndarray] = None  # [T, IW] u32 type membership
    tlimit_def: Optional[np.ndarray] = None  # [T, R] bool
    tlimit_rem: Optional[np.ndarray] = None  # [T, R] i32
    thas_limits: Optional[np.ndarray] = None  # [T] bool

    # instance types [I]
    ireq: Optional[Reqs] = None
    ialloc: Optional[np.ndarray] = None  # [I, R] i32
    icap: Optional[np.ndarray] = None  # [I, R] i32

    # offerings (flattened) [O]; rows past num_offerings_real are bucket
    # padding with ovalid=False (solver/buckets.py pad_offerings)
    otype: Optional[np.ndarray] = None  # [O] i32 owning type
    oword: Optional[np.ndarray] = None  # [O, 3] i32 word of zone/ct/rid bit (-1 = n/a)
    obit: Optional[np.ndarray] = None  # [O, 3] i32
    ovalid: Optional[np.ndarray] = None  # [O] bool — real offering rows
    num_offerings_real: int = 0
    # reserved-capacity bookkeeping (reservationmanager.go:28; round 5)
    orid: Optional[np.ndarray] = None  # [O] i32 reservation index (-1 none)
    num_reservations: int = 0
    rid_names: list[str] = field(default_factory=list)  # [NRES]
    rescap0: Optional[np.ndarray] = None  # [NRES] i32 initial capacities
    # host ports (hostportusage.go:35; round 5): HP distinct triples
    num_host_ports: int = 0
    php_own_c: Optional[np.ndarray] = None  # [NC, HPW] u32 own triple bits
    php_conf_c: Optional[np.ndarray] = None  # [NC, HPW] u32 conflict mask
    thp: Optional[np.ndarray] = None  # [T, HPW] daemonset port seeds
    ehp: Optional[np.ndarray] = None  # [E, HPW] existing-node usage seeds

    # existing nodes [E]
    ereq: Optional[Reqs] = None
    eavail: Optional[np.ndarray] = None  # [E, R] i32
    ezone_seg: Optional[np.ndarray] = None  # [E, TW] — labels-derived, = ereq.mask

    # zone-family topology groups [Gv]
    vgroups: list[VGroup] = field(default_factory=list)
    v_kid: Optional[np.ndarray] = None  # [Gv] i32
    v_word: Optional[np.ndarray] = None  # [Gv, VMAX] i32 (global word; -1 pad)
    v_bit: Optional[np.ndarray] = None  # [Gv, VMAX] i32
    v_reg: Optional[np.ndarray] = None  # [Gv, VMAX] bool registered
    v_cnt: Optional[np.ndarray] = None  # [Gv, VMAX] i32 initial counts
    v_skew: Optional[np.ndarray] = None  # [Gv] i32
    v_mindom: Optional[np.ndarray] = None  # [Gv] i32 (-1 unset)
    v_filt: Optional[np.ndarray] = None  # [Gv, 2] i32 filter alt rows (-1 none)

    # hostname-family topology groups [Gh] over slots [S = E + N]
    hgroups: list[HGroup] = field(default_factory=list)
    h_seed: list[tuple[int, int, int]] = field(default_factory=list)  # (g, slot, count)
    h_skew: Optional[np.ndarray] = None  # [Gh] i32
    h_filt: Optional[np.ndarray] = None  # [Gh, 2] i32

    # stacked node-filter alternatives
    filter_reqs: Optional[Reqs] = None  # [F]

    # per-pod index tables (built per solve() call). Everything heavier
    # than an index is stored per CLASS: a 50k-pod batch dedupes into a
    # few hundred encode classes, and the per-pod Python loops + [cls]
    # broadcasts used to dominate solve wall-clock (VERDICT r3 weak #1).
    pods: list[Pod] = field(default_factory=list)
    pod_class: Optional[np.ndarray] = None  # [P] i32 — encode-class index
    srow: Optional[np.ndarray] = None  # [P] i32 — selection-row index
    class_reps: list[int] = field(default_factory=list)  # [NC] rep pod idx
    rcls_of: Optional[np.ndarray] = None  # [NC] i32 — requirement class
    rclass_creps: list[int] = field(default_factory=list)  # [NR] class idx

    # per-class tables [NC, ...]
    preq_c: Optional[Reqs] = None
    prequests_c: Optional[np.ndarray] = None  # [NC, R] i32
    ptol_t_c: Optional[np.ndarray] = None  # [NC, T] bool tolerates template
    ptol_e_c: Optional[np.ndarray] = None  # [NC, E] bool tolerates existing
    ptopo_kind_c: Optional[np.ndarray] = None  # [NC, C] i32
    ptopo_gid_c: Optional[np.ndarray] = None  # [NC, C] i32
    ptopo_sel_c: Optional[np.ndarray] = None  # [NC, C] bool selects self
    pinv_h_c: Optional[np.ndarray] = None  # [NC, Gh] bool inverse-anti applies
    pown_h_c: Optional[np.ndarray] = None  # [NC, Gh] bool owner (inverse record)

    # selection rows: unique per (namespace, labels) — per-pod record rows
    # are sel_rows_*[srow]
    sel_rows_v: Optional[np.ndarray] = None  # [U, Gv] bool
    sel_rows_h: Optional[np.ndarray] = None  # [U, Gh] bool

    # relaxation tiers (preferences.go:38 ladder, walked host-side per
    # requirement class; a pod's kernel step attempts tiers in order —
    # tpu_kernel._step_relax). Tier tables are stored only for RELAXABLE
    # rclasses (rrow_of_rcls maps into them); L = num_tiers.
    num_tiers: int = 1
    ntiers_r: Optional[np.ndarray] = None  # [NR] i32
    rrow_of_rcls: Optional[np.ndarray] = None  # [NR] i32 (0 when not relaxable)
    rt_tier_reqs: list = field(default_factory=list)  # [NRx][L] Requirements
    rt_preq: Optional[Reqs] = None  # [NRx, L, ...]
    rt_tol_t: Optional[np.ndarray] = None  # [NRx, L, T]
    rt_tol_e: Optional[np.ndarray] = None  # [NRx, L, E]
    rt_kind: Optional[np.ndarray] = None  # [NRx, L, C]
    rt_gid: Optional[np.ndarray] = None  # [NRx, L, C]
    rt_sel: Optional[np.ndarray] = None  # [NRx, L, C]


def _pow2(n: int, floor: int = 8) -> int:
    """Back-compat alias for the bucket ladder (solver/buckets.py owns
    the pow-2 rung definition; importers of _pow2 predate it)."""
    return buckets.bucket(n, floor)


def _gate(cond: bool, why: str) -> None:
    if cond:
        raise UnsupportedBySolver(why)


MAX_RELAX_TIERS = 12


def pod_unsupported_reason(
    pod: Pod, ignore_preferences: bool = False
) -> Optional[str]:
    """Why the kernel can't encode this pod (None = fully supported).

    Round 4: the relaxation ladder (preferences.go:38) rides the kernel —
    tiers are precomputed per requirement class at encode time and a pod's
    step attempts them in order (tpu_kernel._step_relax mirrors
    scheduler.go:434 trySchedule's inline relax-on-a-copy), so preferred
    affinities, ScheduleAnyway TSCs, and required OR-terms are no longer
    fallback reasons. Round 5: host ports ride the kernel too — the
    distinct (ip, proto, port) triples become bit positions, conflicts a
    precomputed relation mask, and per-slot usage a State bitmask
    (hostportusage.go:35). What remains gated: volume claims, hostname
    requirements (a node IS its hostname slot — no vocab id), and
    pathologically long ladders."""
    if pod.volume_claims:
        return "pod volume claims"
    if well_known.HOSTNAME_LABEL_KEY in pod.node_selector:
        return "hostname node selector"
    na = pod.node_affinity
    rungs = 0
    if na is not None:
        for term in na.required_terms:
            for e in term.match_expressions:
                if e.key == well_known.HOSTNAME_LABEL_KEY:
                    return "hostname affinity term"
        for w in na.preferred:
            for e in w.preference.match_expressions:
                if e.key == well_known.HOSTNAME_LABEL_KEY:
                    return "hostname preferred-affinity term"
        rungs += max(0, len(na.required_terms) - 1)
        if not ignore_preferences:
            rungs += len(na.preferred)
    if not ignore_preferences:
        # under Ignore, preference rungs don't change the strict problem —
        # the ladder walk collapses them to zero effective tiers
        rungs += len(pod.pod_affinity_preferred)
        rungs += len(pod.pod_anti_affinity_preferred)
        rungs += sum(
            1
            for t in pod.topology_spread_constraints
            if t.when_unsatisfiable != "DoNotSchedule"
        )
    if rungs + 2 > MAX_RELAX_TIERS:  # +1 tier 0, +1 PreferNoSchedule rung
        return "relaxation ladder too long"
    return None


def _check_pod_supported(pod: Pod, ignore_preferences: bool = False) -> None:
    reason = pod_unsupported_reason(pod, ignore_preferences)
    _gate(reason is not None, reason or "")


def _tier_key(pod: Pod, ignore_preferences: bool):
    """The EFFECTIVE constraint signature of a tier. Under Respect this is
    the full class key; under PreferencePolicy=Ignore only strict
    requirements and tolerations matter (preferences are dropped up front,
    so rungs that strip them are no-ops and must collapse)."""
    from karpenter_tpu_torch.solver.ordering import pod_class_key

    if not ignore_preferences:
        return pod_class_key(pod)
    reqs = Requirements.strict_from_pod(pod)
    return (
        tuple(
            sorted(
                (r.key, str(r.operator()), tuple(sorted(r.values)), r.complement)
                for r in reqs.values()
            )
        ),
        tuple((t.key, t.operator, t.value, t.effect) for t in pod.tolerations),
    )


def _walk_ladder(scheduler, pod: Pod) -> list[Pod]:
    """Tier pod copies, tier 0 first: the oracle's own Preferences walks
    the rungs (preferences.go:38 order cannot drift between paths).
    Consecutive tiers with equal EFFECTIVE constraints collapse — an
    attempt with identical constraints against the same state returns the
    same verdict, so the duplicate rung is a no-op (this is what keeps
    PreferencePolicy=Ignore ladders short: preference rungs don't change
    the strict problem)."""
    ignore = scheduler.opts.ignore_preferences
    tiers = [pod.deep_copy()]
    keys = [_tier_key(tiers[0], ignore)]
    copy = pod.deep_copy()
    while scheduler.preferences.relax(copy):  # relax invalidates key caches
        k = _tier_key(copy, ignore)
        if k != keys[-1]:
            tiers.append(copy.deep_copy())
            keys.append(k)
        _gate(len(tiers) > MAX_RELAX_TIERS, "relaxation ladder too long")
    return tiers


def encode_problem(scheduler: Scheduler, pods: list[Pod]) -> EncodedProblem:
    """Build the full tensor problem from an oracle Scheduler + pod batch."""
    if scheduler.opts.reserved_capacity_enabled:
        # Round 5: NON-STRICT reserved capacity rides the kernel — the
        # stateful per-reservation counting (reservationmanager.go:57-98)
        # is a device-side capacity vector consumed at claim commits
        # (tpu_kernel._step reservation bookkeeping; decisions themselves
        # are unchanged in non-strict mode, only the held sets and the
        # finalize-time requirements). STRICT mode can fail a can_add on
        # reservation exhaustion (nodeclaim.go:227) — that per-candidate
        # error path stays on the oracle.
        def is_reserved(o):
            if o.requirements.has(well_known.RESERVATION_ID_LABEL_KEY):
                return True
            if o.requirements.has(well_known.CAPACITY_TYPE_LABEL_KEY):
                r = o.requirements.get(well_known.CAPACITY_TYPE_LABEL_KEY)
                if well_known.CAPACITY_TYPE_RESERVED in r.values:
                    return True
            return False

        has_reserved = any(
            is_reserved(o)
            for nct in scheduler.templates
            for it in nct.instance_type_options
            for o in it.offerings
        )
        _gate(
            has_reserved and scheduler.opts.reserved_offering_strict,
            "strict reserved-offering mode with reserved offerings present",
        )
        _gate(
            any(
                o.requirements.has(well_known.CAPACITY_TYPE_LABEL_KEY)
                and well_known.CAPACITY_TYPE_RESERVED
                in o.requirements.get(well_known.CAPACITY_TYPE_LABEL_KEY).values
                and not o.requirements.has(well_known.RESERVATION_ID_LABEL_KEY)
                for nct in scheduler.templates
                for it in nct.instance_type_options
                for o in it.offerings
            ),
            "reserved offering without a reservation id",
        )

    # the oracle handles the all-types-filtered-out case with per-pod errors
    # (scheduler.go:489); zero templates would also give zero-width tensors
    _gate(
        not scheduler.templates,
        "no templates survived nodepool requirement filtering",
    )

    p = EncodedProblem(vocab=Vocab(), table=ResourceTable(), scheduler=scheduler)
    topo = scheduler.topology

    # ---- vocab + resource universe ------------------------------------
    vocab, table = p.vocab, p.table
    all_types: list = []
    type_index: dict[int, int] = {}
    for nct in scheduler.templates:
        vocab.observe_requirements(nct.requirements)
        for it in nct.instance_type_options:
            if id(it) not in type_index:
                type_index[id(it)] = len(all_types)
                all_types.append(it)
    for it in all_types:
        vocab.observe_requirements(it.requirements)
        for o in it.offerings:
            vocab.observe_requirements(o.requirements)
        table.observe(it.allocatable())
        table.observe(it.capacity)

    # ---- pod class pass (the ONLY per-pod Python loop) -----------------
    class_reqs = _class_pass(p, scheduler, pods)
    for c, i in enumerate(p.class_reps):
        pod = pods[i]
        # every gated field is a class field
        _check_pod_supported(pod, scheduler.opts.ignore_preferences)
        for r in class_reqs[c].values():
            if r.key != well_known.HOSTNAME_LABEL_KEY:
                vocab.observe_requirement(r)
        table.observe(pod.requests)
    table.observe({res.PODS: 1000})

    # ---- relaxation ladders (per requirement class) --------------------
    # tier requirements must be in the vocab BEFORE finalize; the tier
    # TABLES are built later (_encode_pod_classes) once group ids exist
    from_pod_fn = (
        Requirements.strict_from_pod
        if scheduler.opts.ignore_preferences
        else Requirements.from_pod
    )
    ladders: list[Optional[list]] = []  # per rclass: None or [(pod, reqs)]
    for rid, c0 in enumerate(p.rclass_creps):
        rep = pods[p.class_reps[c0]]
        tiers = _walk_ladder(scheduler, rep)
        if len(tiers) == 1:
            ladders.append(None)
            continue
        tier_rows = []
        for tp in tiers:
            reqs = from_pod_fn(tp)
            _gate(
                reqs.has(well_known.HOSTNAME_LABEL_KEY),
                "hostname requirement on a relaxation tier",
            )
            for r in reqs.values():
                vocab.observe_requirement(r)
            tier_rows.append((tp, reqs))
        ladders.append(tier_rows)
    p._ladders = ladders
    for node in scheduler.existing_nodes:
        vocab.observe_labels(node.view.labels)
        table.observe(node.remaining_resources)
    for nct in scheduler.templates:
        table.observe(scheduler.daemon_overhead[nct])
        if nct.nodepool_name in scheduler.remaining_resources:
            table.observe(scheduler.remaining_resources[nct.nodepool_name])
    # topology group domains must be in vocab (they come from nodepool/type
    # requirements or live node labels)
    groups = list(topo.topology_groups.values()) + list(
        topo.inverse_topology_groups.values()
    )
    for tg in groups:
        if tg.key != well_known.HOSTNAME_LABEL_KEY:
            for d in tg.domains:
                vocab.observe_labels({tg.key: d})
        for freq in tg.node_filter.requirements:
            vocab.observe_requirements(freq)
    try:
        # bucket the vocab layout (words per key, key count) so label/key
        # churn between solves reuses compiled shapes (solver/buckets.py)
        if buckets.enabled():
            vocab.finalize(
                pad_words=buckets.bucket_words, pad_keys=buckets.bucket_keys
            )
        else:
            vocab.finalize()
        table.finalize()
    except UnsupportedProblem as e:
        raise UnsupportedBySolver(str(e)) from e
    _gate(vocab.total_words == 0, "empty requirement vocabulary")

    # ---- templates + types --------------------------------------------
    T = len(scheduler.templates)
    I = len(all_types)
    R = table.num_resources
    p.num_templates, p.num_types = T, I
    IW = max(1, (I + WORD_BITS - 1) // WORD_BITS)
    try:
        p.treq = encode_requirements(
            vocab, [nct.requirements for nct in scheduler.templates]
        )
        p.tdaemon = np.stack(
            [table.encode(scheduler.daemon_overhead[nct]) for nct in scheduler.templates]
        ) if T else np.zeros((0, R), np.int32)
        p.ireq = encode_requirements(vocab, [it.requirements for it in all_types])
        p.ialloc = (
            np.stack([table.encode(it.allocatable()) for it in all_types])
            if I
            else np.zeros((0, R), np.int32)
        )
        p.icap = (
            np.stack([table.encode(it.capacity) for it in all_types])
            if I
            else np.zeros((0, R), np.int32)
        )
    except UnsupportedProblem as e:
        raise UnsupportedBySolver(str(e)) from e

    p.ttypes = np.zeros((T, IW), dtype=np.uint32)
    for t, nct in enumerate(scheduler.templates):
        for it in nct.instance_type_options:
            i = type_index[id(it)]
            p.ttypes[t, i // WORD_BITS] |= np.uint32(1 << (i % WORD_BITS))

    p.tlimit_def = np.zeros((T, R), dtype=bool)
    p.tlimit_rem = np.zeros((T, R), dtype=np.int32)
    p.thas_limits = np.zeros(T, dtype=bool)
    for t, nct in enumerate(scheduler.templates):
        rem = scheduler.remaining_resources.get(nct.nodepool_name)
        if rem is None:
            continue
        p.thas_limits[t] = True
        for name, v in rem.items():
            ri = table.index.get(name)
            if ri is None:
                raise UnsupportedBySolver(f"limit on unobserved resource {name!r}")
            p.tlimit_def[t, ri] = True
            # limits can go negative (over-subscribed pools); clamp encode
            q, mod = divmod(int(v), table.scale[ri])
            _gate(mod != 0, f"limit {name!r} not divisible by resource scale")
            p.tlimit_rem[t, ri] = max(min(q, (1 << 30) - 1), -(1 << 30))

    # ---- offerings -----------------------------------------------------
    off_rows: list[tuple[int, list[int], list[int]]] = []
    off_rids: list[int] = []  # reservation index per offering (-1 none)
    rid_index: dict[str, int] = {}  # reservation id -> index
    p.rid_names = []
    off_keys = (
        well_known.TOPOLOGY_ZONE_LABEL_KEY,
        well_known.CAPACITY_TYPE_LABEL_KEY,
        well_known.RESERVATION_ID_LABEL_KEY,
    )
    for it in all_types:
        i = type_index[id(it)]
        for o in it.offerings:
            if not o.available:
                continue
            words, bits = [], []
            for key in off_keys:
                r = o.requirements.get(key) if o.requirements.has(key) else None
                if r is None:
                    words.append(-1)
                    bits.append(0)
                    continue
                _gate(
                    r.complement or len(r.values) != 1,
                    f"offering requirement {key!r} must be a single In value",
                )
                kid = vocab.key_index[key]
                vid = vocab.value_index[kid][next(iter(r.values))]
                words.append(vocab.word_offset[kid] + vid // WORD_BITS)
                bits.append(vid % WORD_BITS)
            for key in o.requirements.keys() - set(off_keys):
                raise UnsupportedBySolver(f"offering requirement on {key!r}")
            # reservation bookkeeping rides capacity-type == reserved
            # (nodes.py _offerings_to_reserve keys on capacity type)
            rid = -1
            if (
                scheduler.opts.reserved_capacity_enabled
                and o.capacity_type() == well_known.CAPACITY_TYPE_RESERVED
            ):
                name = o.reservation_id()
                got = rid_index.get(name)
                if got is None:
                    got = len(rid_index)
                    rid_index[name] = got
                    p.rid_names.append(name)
                rid = got
            off_rows.append((i, words, bits))
            off_rids.append(rid)
    O = len(off_rows)
    p.otype = np.array([r[0] for r in off_rows], dtype=np.int32).reshape(O)
    p.oword = np.array([r[1] for r in off_rows], dtype=np.int32).reshape(O, 3)
    p.obit = np.array([r[2] for r in off_rows], dtype=np.int32).reshape(O, 3)
    p.orid = np.array(off_rids, dtype=np.int32).reshape(O)
    p.num_reservations = len(rid_index)
    p.rescap0 = np.array(
        [
            scheduler.reservation_manager.capacity.get(name, 0)
            for name in p.rid_names
        ],
        dtype=np.int32,
    )

    # ---- existing nodes ------------------------------------------------
    E = len(scheduler.existing_nodes)
    p.num_existing = E
    try:
        p.ereq = encode_requirements(
            vocab, [n.requirements for n in scheduler.existing_nodes]
        )
    except UnsupportedProblem as e:
        raise UnsupportedBySolver(str(e)) from e
    try:
        p.eavail = (
            np.stack(
                [table.encode(n.remaining_resources) for n in scheduler.existing_nodes]
            )
            if E
            else np.zeros((0, R), np.int32)
        )
    except UnsupportedProblem as e:
        raise UnsupportedBySolver(str(e)) from e

    # Pad existing-node slots to a pow2 bucket so compiled kernel shapes
    # (and the XLA compile cache) survive cluster growth: a live control
    # plane's node count changes every tick, and exact-E shapes would
    # recompile per solve. Padded slots are inert — eavail=-1 fails every
    # fits check (tpu_kernel cand_e / tpu_runs _pod_units) and
    # encode_pod_classes leaves their toleration rows False.
    E_pad = _pow2(E) if E else 0
    if E_pad > E:
        pad_reqs = empty_reqs(vocab, (E_pad - E,))
        p.ereq = Reqs(
            *(np.concatenate([a, b]) for a, b in zip(p.ereq, pad_reqs))
        )
        p.eavail = np.concatenate(
            [p.eavail, np.full((E_pad - E, R), -1, np.int32)]
        )
        p.num_existing = E_pad

    # ---- topology groups ----------------------------------------------
    filter_sets: list[Requirements] = []

    def encode_filter(tg: TopologyGroup) -> tuple[int, int]:
        nf = tg.node_filter
        _gate(
            nf.taint_policy == NodeInclusionPolicy.HONOR,
            "nodeTaintsPolicy=Honor topology filter",
        )
        if nf.affinity_policy != NodeInclusionPolicy.HONOR or not nf.requirements:
            return (-1, -1)
        # a filter of one empty Requirements matches everything
        alts = [r for r in nf.requirements if len(r) > 0]
        if not alts:
            return (-1, -1)
        _gate(
            len(alts) > MAX_FILTER_ALTERNATIVES,
            "too many topology node-filter alternatives",
        )
        out = []
        for alt in alts:
            _gate(
                alt.has(well_known.HOSTNAME_LABEL_KEY),
                "hostname in topology node filter",
            )
            filter_sets.append(alt)
            out.append(len(filter_sets) - 1)
        while len(out) < MAX_FILTER_ALTERNATIVES:
            out.append(-1)
        return tuple(out)  # type: ignore[return-value]

    # _ordered_groups is the single source of group index order (the class
    # pass built selection rows against the same lists)
    v_tgs, h_tgs, inv_start = _ordered_groups(topo)
    group_vid: dict[int, tuple[str, int]] = {}  # id(tg) -> (family, index)
    for tg in v_tgs:
        kid = vocab.key_index.get(tg.key)
        _gate(kid is None, f"topology key {tg.key!r} has no vocab values")
        _gate(
            tg.type != TopologyType.SPREAD and tg.min_domains is not None,
            "minDomains on non-spread group",
        )
        group_vid[id(tg)] = ("v", len(p.vgroups))
        p.vgroups.append(
            VGroup(
                tg,
                kid,
                _clip_skew(tg.max_skew),
                -1 if tg.min_domains is None else tg.min_domains,
                encode_filter(tg),
            )
        )
    for g, tg in enumerate(h_tgs):
        if g < inv_start:
            group_vid[id(tg)] = ("h", len(p.hgroups))
            p.hgroups.append(
                HGroup(tg, _clip_skew(tg.max_skew), inverse=False, filt=encode_filter(tg))
            )
        else:
            _gate(
                tg.key != well_known.HOSTNAME_LABEL_KEY,
                f"inverse anti-affinity on key {tg.key!r}",
            )
            group_vid[id(tg)] = ("h", len(p.hgroups))
            p.hgroups.append(HGroup(tg, _clip_skew(tg.max_skew), inverse=True))

    Gv, Gh = len(p.vgroups), len(p.hgroups)
    p.vmax = VMAX = max(
        [len(vocab.values[g.kid]) for g in p.vgroups], default=1
    )
    p.v_kid = np.array([g.kid for g in p.vgroups], dtype=np.int32).reshape(Gv)
    p.v_skew = np.array([g.skew for g in p.vgroups], dtype=np.int32).reshape(Gv)
    p.v_mindom = np.array([g.min_domains for g in p.vgroups], dtype=np.int32).reshape(Gv)
    p.v_filt = np.array([g.filt for g in p.vgroups], dtype=np.int32).reshape(Gv, 2)
    p.v_word = np.full((Gv, VMAX), -1, dtype=np.int32)
    p.v_bit = np.zeros((Gv, VMAX), dtype=np.int32)
    p.v_reg = np.zeros((Gv, VMAX), dtype=bool)
    p.v_cnt = np.zeros((Gv, VMAX), dtype=np.int32)
    for g, vg in enumerate(p.vgroups):
        kid = vg.kid
        nvals = len(vocab.values[kid])
        for vid in range(nvals):
            p.v_word[g, vid] = vocab.word_offset[kid] + vid // WORD_BITS
            p.v_bit[g, vid] = vid % WORD_BITS
        for d, c in vg.group.domains.items():
            vid = vocab.value_index[kid].get(d)
            if vid is None:
                raise UnsupportedBySolver(f"domain {d!r} missing from vocab")
            p.v_reg[g, vid] = True
            p.v_cnt[g, vid] = c

    p.h_skew = np.array([g.skew for g in p.hgroups], dtype=np.int32).reshape(Gh)
    p.h_filt = np.array(
        [g.filt for g in p.hgroups], dtype=np.int32
    ).reshape(Gh, 2) if Gh else np.zeros((0, 2), np.int32)
    # the full h_cnt is sized at solve time (needs max_claims); seed counts
    # for existing-node hostnames here
    host_slot = {
        n.view.hostname: e for e, n in enumerate(scheduler.existing_nodes)
    }
    for g, hg in enumerate(p.hgroups):
        for d, c in hg.group.domains.items():
            if c == 0:
                continue
            slot = host_slot.get(d)
            if slot is None:
                # counts on hostnames we don't model (e.g. unmanaged nodes
                # outside the state-node set) can't be attributed to a slot
                raise UnsupportedBySolver(
                    f"hostname domain {d!r} with count outside known nodes"
                )
            p.h_seed.append((g, slot, c))

    try:
        p.filter_reqs = (
            encode_requirements(vocab, filter_sets)
            if filter_sets
            else empty_reqs(vocab, (0,))
        )
    except UnsupportedProblem as e:
        raise UnsupportedBySolver(str(e)) from e

    # ---- pods ----------------------------------------------------------
    _encode_pod_classes(p, pods, group_vid, class_reqs)
    # Best-effort minValues (MinValuesPolicy=BestEffort): the oracle's
    # can_add LOWERS an unsatisfiable floor per add and keeps packing
    # (nodes.py filter_instance_types relax_min_values —
    # scheduling/nodeclaim.go BestEffort), while the kernel's
    # _min_values_ok enforces the encoded floor strictly — a pod the
    # oracle still packs would open a fresh claim on device (found by the
    # differential fuzzer, corpus pin seed8073). Like strict reserved
    # offerings above, the policy's per-add mutation stays on the oracle.
    _gate(
        scheduler.opts.min_values_best_effort
        and bool(
            (p.treq.minv != -1).any()
            or (p.preq_c.minv != -1).any()
            or (p.num_existing and (p.ereq.minv != -1).any())
        ),
        "best-effort minValues policy with minValues floors present",
    )
    # bucket the remaining compiled axes (instance types, offerings) —
    # sentinel invisibility arguments live in solver/buckets.py
    buckets.pad_problem(p)
    return p


def _clip_skew(skew: int) -> int:
    return int(min(skew, (1 << 30)))


def _ordered_groups(topo) -> tuple[list, list, int]:
    """(v_tgs, h_tgs, inv_start): topology groups in the EXACT order the
    encode assigns vgroup/hgroup indices. The class pass (selection rows,
    inverse-anti class splits) and the group-table section both consume
    this — a single definition so they cannot drift."""
    v_tgs = [
        tg
        for tg in topo.topology_groups.values()
        if tg.key != well_known.HOSTNAME_LABEL_KEY
    ]
    h_tgs = [
        tg
        for tg in topo.topology_groups.values()
        if tg.key == well_known.HOSTNAME_LABEL_KEY
    ]
    inv_start = len(h_tgs)
    h_tgs += list(topo.inverse_topology_groups.values())
    return v_tgs, h_tgs, inv_start


def _class_pass(
    p: EncodedProblem, scheduler: Scheduler, pods: list[Pod]
) -> list[Requirements]:
    """The single per-pod Python loop of the encode: class dedup +
    selection rows, before the vocab exists. Everything downstream is per
    class (a few hundred for a 50k-pod batch) or a vectorized broadcast.

    Dedup key: (pod_class_repr bytes, request vector) — bytes cache their
    hash, so the per-pod cost is one cached-hash dict lookup, not a deep
    tuple hash. Inverse-anti selection feeds per-pod FEASIBILITY (kernel
    inv_bad) and ownership feeds in-run budget dynamics, so both split
    classes even though plain selection rows don't (selection rides the
    per-pod srow index instead).

    Returns the per-class Requirements (hostname stripped), reused for
    vocab observation and the class encode so Requirements.from_pod runs
    once per class, not once per pod."""
    topo = scheduler.topology
    v_tgs, h_tgs, inv_start = _ordered_groups(topo)
    inv_tgs = h_tgs[inv_start:]
    Gh = len(h_tgs)

    from karpenter_tpu_torch.solver.ordering import pod_class_repr

    P = len(pods)
    sel_cache: dict[tuple, int] = {}
    rows_v: list[list[bool]] = []
    rows_h: list[list[bool]] = []
    inv_keys: list[tuple] = []  # per srow: inverse-selection tuple
    class_map: dict[tuple, int] = {}
    rkey_map: dict[bytes, int] = {}
    cls = [0] * P
    srow = [0] * P
    reps: list[int] = []
    rcls_of: list[int] = []
    inv_rows: list[tuple] = []  # per class, over inverse groups
    own_rows: list[tuple] = []
    # inverse OWNERSHIP is per-uid: invert the owner sets once instead of
    # scanning every inverse group per pod (the per-pod tuple builds were
    # ~half of encode wall-clock at 50k pods)
    owners_rev: dict[str, tuple[int, ...]] = {}
    if inv_tgs:
        tmp: dict[str, list[int]] = {}
        for k, tg in enumerate(inv_tgs):
            for uid in tg.owners:
                tmp.setdefault(uid, []).append(k)
        owners_rev = {u: tuple(ks) for u, ks in tmp.items()}
    for i, pod in enumerate(pods):
        labels = pod.metadata.labels
        skey = (pod.namespace, tuple(sorted(labels.items())) if labels else ())
        s = sel_cache.get(skey)
        if s is None:
            s = len(rows_v)
            sel_cache[skey] = s
            rows_v.append([tg.selects(pod) for tg in v_tgs])
            hrow = [tg.selects(pod) for tg in h_tgs]
            rows_h.append(hrow)
            # inverse groups act as anti-affinity on any pod they select
            # (topology.go:528) — selection is label-based, so the row is
            # a per-srow fact
            inv_keys.append(tuple(hrow[inv_start:]))
        srow[i] = s
        rkey = pod_class_repr(pod)
        rq = pod.requests
        qkey = tuple(sorted(rq.items())) if rq else ()
        if inv_tgs:
            own_t = owners_rev.get(pod.uid, ())
            key = (rkey, qkey, inv_keys[s], own_t)
        else:
            own_t = ()
            key = (rkey, qkey)
        c = class_map.get(key)
        if c is None:
            c = len(reps)
            class_map[key] = c
            reps.append(i)
            inv_rows.append(inv_keys[s] if inv_tgs else ())
            own_rows.append(own_t)
            rid = rkey_map.get(rkey)
            if rid is None:
                rid = len(p.rclass_creps)
                rkey_map[rkey] = rid
                p.rclass_creps.append(c)
            rcls_of.append(rid)
        cls[i] = c

    NC = len(reps)
    p.pods = pods
    p.pod_class = np.asarray(cls, dtype=np.int32)
    p.srow = np.asarray(srow, dtype=np.int32)
    p.class_reps = reps
    p.rcls_of = np.asarray(rcls_of, dtype=np.int32)
    Gv = len(v_tgs)
    p.sel_rows_v = (
        np.asarray(rows_v, dtype=bool)
        if Gv
        else np.zeros((max(1, len(rows_v)), 0), bool)
    )
    p.sel_rows_h = (
        np.asarray(rows_h, dtype=bool)
        if Gh
        else np.zeros((max(1, len(rows_h)), 0), bool)
    )
    p.pinv_h_c = np.zeros((NC, Gh), dtype=bool)
    p.pown_h_c = np.zeros((NC, Gh), dtype=bool)
    for c in range(NC):
        row = inv_rows[c]
        if row:
            p.pinv_h_c[c, inv_start:] = row
        for k in own_rows[c]:  # owned inverse-group indices
            p.pown_h_c[c, inv_start + k] = True

    # per-class Requirements, shared by vocab observation and encode.
    # PreferencePolicy=Ignore drops preferred terms up front
    # (scheduler.go:74-85; strict_from_pod keeps required_terms[0] only)
    from_pod = (
        Requirements.strict_from_pod
        if scheduler.opts.ignore_preferences
        else Requirements.from_pod
    )
    class_reqs: list[Requirements] = []
    for i in reps:
        reqs = from_pod(pods[i])
        reqs.pop(well_known.HOSTNAME_LABEL_KEY)
        class_reqs.append(reqs)
    return class_reqs


def _encode_pod_classes(
    p: EncodedProblem,
    pods: list[Pod],
    group_vid: dict[int, tuple[str, int]],
    class_reqs: list[Requirements],
) -> None:
    """Per-CLASS tensors (the class pass already ran): requirements,
    requests, tolerations, topology ownership. No [P]-sized array is built
    here — the kernel gathers class rows through pod_class/srow on
    device."""
    vocab, table, scheduler = p.vocab, p.table, p.scheduler
    topo = scheduler.topology
    T, E = p.num_templates, p.num_existing
    reps = p.class_reps
    NC = len(reps)

    prequests_c = np.zeros((NC, table.num_resources), dtype=np.int32)
    for c, i in enumerate(reps):
        prequests_c[c] = table.encode(res.requests_for_pods([pods[i]]))
    try:
        p.preq_c = encode_requirements(vocab, class_reqs)
    except UnsupportedProblem as e:
        raise UnsupportedBySolver(str(e)) from e
    p.prequests_c = prequests_c

    # taint toleration (static per class x template/node)
    tol_cache: dict[tuple, bool] = {}

    def tolerates(taints, pod) -> bool:
        key = (
            tuple((t.key, t.value, t.effect) for t in taints),
            tuple(
                (t.key, t.operator, t.value, t.effect) for t in pod.tolerations
            ),
        )
        got = tol_cache.get(key)
        if got is None:
            got = Taints(taints).tolerates_pod(pod) is None
            tol_cache[key] = got
        return got

    p.ptol_t_c = np.zeros((NC, T), dtype=bool)
    for t, nct in enumerate(scheduler.templates):
        for c, i in enumerate(reps):
            p.ptol_t_c[c, t] = tolerates(nct.taints, pods[i])
    p.ptol_e_c = np.zeros((NC, E), dtype=bool)
    for e, node in enumerate(scheduler.existing_nodes):
        for c, i in enumerate(reps):
            p.ptol_e_c[c, e] = tolerates(node.cached_taints, pods[i])

    # ---- host ports (hostportusage.go:35; round 5) ---------------------
    # universe = every distinct (ip, proto, port) triple observed on pods,
    # template daemonsets, and existing nodes; conflict is a precomputed
    # RELATION over triples (same proto+port, ips equal or either
    # wildcard), so the kernel's screen is one mask AND per candidate
    triples: dict = {}

    def intern(hp):
        got = triples.get(hp)
        if got is None:
            got = len(triples)
            triples[hp] = got
        return got

    class_ports = [get_host_ports(pods[i]) for i in reps]
    for ports in class_ports:
        for hp in ports:
            intern(hp)
    tmpl_ports = []
    for nct in scheduler.templates:
        usage = scheduler.daemon_host_ports.get(nct)
        ports = (
            [hp for plist in usage._by_pod.values() for hp in plist]
            if usage is not None
            else []
        )
        tmpl_ports.append(ports)
        for hp in ports:
            intern(hp)
    node_ports = []
    for node in scheduler.existing_nodes:
        ports = [
            hp for plist in node.host_port_usage._by_pod.values() for hp in plist
        ]
        node_ports.append(ports)
        for hp in ports:
            intern(hp)
    HP = len(triples)
    HPW = (HP + 31) // 32
    p.num_host_ports = HP
    all_triples = list(triples)

    def pack_bits(idxs) -> np.ndarray:
        out = np.zeros(HPW, np.uint32)
        for i in idxs:
            out[i // 32] |= np.uint32(1) << np.uint32(i % 32)
        return out

    from karpenter_tpu_torch.scheduling.hostports import _conflicts

    conflict_of = [
        [u for u, hpu in enumerate(all_triples) if _conflicts(hpt, hpu)]
        for hpt in all_triples
    ]

    def pack_ports(ports) -> tuple[np.ndarray, np.ndarray]:
        idxs = [triples[hp] for hp in ports]
        own = pack_bits(idxs)
        conf = pack_bits([u for i in idxs for u in conflict_of[i]])
        return own, conf

    p.php_own_c = np.zeros((NC, HPW), np.uint32)
    p.php_conf_c = np.zeros((NC, HPW), np.uint32)
    for c, ports in enumerate(class_ports):
        if ports:
            p.php_own_c[c], p.php_conf_c[c] = pack_ports(ports)
    p.thp = np.zeros((T, HPW), np.uint32)
    for t, ports in enumerate(tmpl_ports):
        if ports:
            p.thp[t] = pack_ports(ports)[0]
    p.ehp = np.zeros((E, HPW), np.uint32)
    for e, ports in enumerate(node_ports):
        if ports:
            p.ehp[e] = pack_ports(ports)[0]

    # topology ownership tables (same groups for every pod of a class: the
    # Topology hashes groups by constraint spec, which the class signature
    # covers)
    kind_of = {
        ("v", TopologyType.SPREAD): TOPO_SPREAD_V,
        ("v", TopologyType.POD_AFFINITY): TOPO_AFFINITY_V,
        ("v", TopologyType.POD_ANTI_AFFINITY): TOPO_ANTI_V,
        ("h", TopologyType.SPREAD): TOPO_SPREAD_H,
        ("h", TopologyType.POD_AFFINITY): TOPO_AFFINITY_H,
        ("h", TopologyType.POD_ANTI_AFFINITY): TOPO_ANTI_H,
    }
    owned_by_uid: dict[str, list[TopologyGroup]] = {}
    for tg in topo.topology_groups.values():
        for uid in tg.owners:
            owned_by_uid.setdefault(uid, []).append(tg)
    C = max([len(owned_by_uid.get(pods[i].uid, ())) for i in reps], default=0)
    C = max(1, C)
    _gate(C > MAX_OWNED_TOPOLOGIES, "pod owns too many topology constraints")
    p.ptopo_kind_c = np.zeros((NC, C), dtype=np.int32)
    p.ptopo_gid_c = np.zeros((NC, C), dtype=np.int32)
    p.ptopo_sel_c = np.zeros((NC, C), dtype=bool)
    for c, i in enumerate(reps):
        pod = pods[i]
        s = int(p.srow[i])
        vrow, hrow = p.sel_rows_v[s], p.sel_rows_h[s]
        slot = 0
        for tg in owned_by_uid.get(pod.uid, ()):
            fam, gid = group_vid[id(tg)]
            p.ptopo_kind_c[c, slot] = kind_of[(fam, tg.type)]
            p.ptopo_gid_c[c, slot] = gid
            p.ptopo_sel_c[c, slot] = vrow[gid] if fam == "v" else hrow[gid]
            slot += 1

    # ---- relaxation tier tables (per relaxable requirement class) ------
    # tier 0 = the pod as submitted; tier t = after t effective relax
    # rungs (encode_problem walked the ladder pre-finalize and observed
    # every tier's requirement values). Tiers repeat their last row up to
    # L — the kernel's tier loop stops at ntiers, padding is unreachable.
    ladders = getattr(p, "_ladders", [])
    NR = len(p.rclass_creps)
    p.ntiers_r = np.ones(NR, np.int32)
    p.rrow_of_rcls = np.zeros(NR, np.int32)
    relax_rows: list[tuple[int, list]] = []
    for rid, ladder in enumerate(ladders):
        if ladder is None:
            continue
        p.ntiers_r[rid] = len(ladder)
        p.rrow_of_rcls[rid] = len(relax_rows)
        relax_rows.append((rid, ladder))
    NRx = len(relax_rows)
    L = max((len(ladder) for _, ladder in relax_rows), default=1)
    p.num_tiers = L
    if NRx:
        # inverse-anti rows are tier-INDEPENDENT by construction: inverse
        # group OWNERSHIP comes from required anti terms only
        # (topology.py _update_inverse_anti_affinity — required anti never
        # relaxes), and inverse SELECTION is label-based — so the class
        # rows pinv_h_c/pown_h_c stay correct at every tier
        p.rt_tol_t = np.zeros((NRx, L, T), bool)
        p.rt_tol_e = np.zeros((NRx, L, E), bool)
        p.rt_kind = np.zeros((NRx, L, C), np.int32)
        p.rt_gid = np.zeros((NRx, L, C), np.int32)
        p.rt_sel = np.zeros((NRx, L, C), bool)
        reqs_flat: list[Requirements] = []
        for x_i, (rid, ladder) in enumerate(relax_rows):
            rep_i = reps[p.rclass_creps[rid]]
            s = int(p.srow[rep_i])
            vrow, hrow = p.sel_rows_v[s], p.sel_rows_h[s]
            tier_reqs = []
            for t_i in range(L):
                tp, reqs = ladder[min(t_i, len(ladder) - 1)]
                tier_reqs.append(reqs)
                reqs_flat.append(reqs)
                for t, nct in enumerate(scheduler.templates):
                    p.rt_tol_t[x_i, t_i, t] = tolerates(nct.taints, tp)
                for e, node in enumerate(scheduler.existing_nodes):
                    p.rt_tol_e[x_i, t_i, e] = tolerates(node.cached_taints, tp)
                groups = topo._new_for_topologies(tp) + topo._new_for_affinities(tp)
                _gate(len(groups) > C, "tier owns too many topology constraints")
                slot = 0
                for tg_new in groups:
                    tg = topo.topology_groups.get(tg_new.hash_key())
                    if tg is None or id(tg) not in group_vid:
                        raise UnsupportedBySolver(
                            "relaxation tier topology group missing from encode"
                        )
                    fam, gid = group_vid[id(tg)]
                    p.rt_kind[x_i, t_i, slot] = kind_of[(fam, tg.type)]
                    p.rt_gid[x_i, t_i, slot] = gid
                    p.rt_sel[x_i, t_i, slot] = (
                        vrow[gid] if fam == "v" else hrow[gid]
                    )
                    slot += 1
            p.rt_tier_reqs.append(tier_reqs)
        try:
            flat = encode_requirements(vocab, reqs_flat)
        except UnsupportedProblem as e:
            raise UnsupportedBySolver(str(e)) from e
        p.rt_preq = Reqs(
            *(a.reshape((NRx, L) + a.shape[1:]) for a in flat)
        )
    else:
        # uniform shapes for Tables even with nothing to relax; the tier
        # branch is unreachable (every pod has ntiers == 1)
        p.rt_preq = empty_reqs(vocab, (1, 1))
        p.rt_tol_t = np.zeros((1, 1, T), bool)
        p.rt_tol_e = np.zeros((1, 1, E), bool)
        p.rt_kind = np.zeros((1, 1, C), np.int32)
        p.rt_gid = np.zeros((1, 1, C), np.int32)
        p.rt_sel = np.zeros((1, 1, C), bool)


# ---------------------------------------------------------------------------
# batched-sweep hooks (controllers/disruption/{sweep,setsweep}.py)
#
# The delta-state consolidation kernels treat FFD of a class-grouped pod
# sequence as one masked cumsum per encode class. That identity needs two
# host-side ingredients this module owns (they are properties of the
# ENCODING, not of the disruption controller): the contiguity of classes
# in the shared FFD order, and the per-group class-count matrix every
# batching scheme derives its per-lane valid-pod counts from.


def contiguous_class_seq(ordered_cls: np.ndarray):
    """Distinct encode classes in first-appearance order IF every class is
    one contiguous run of `ordered_cls` (the pod classes permuted into the
    shared FFD order, ordering.ffd_sort_key); None otherwise.

    The delta-state sweep kernels replace the per-pod FFD scan with one
    cumsum per class, which is only exact when the oracle would also place
    each class's pods consecutively — a signature collision that
    interleaves two classes in FFD order voids the identity."""
    ordered_cls = np.asarray(ordered_cls)
    if len(ordered_cls) == 0:
        return np.zeros(0, dtype=np.int64)
    change = np.flatnonzero(np.diff(ordered_cls))
    class_seq = ordered_cls[np.r_[0, change + 1]]
    if len(set(class_seq.tolist())) != len(class_seq):
        return None
    return class_seq


def group_class_counts(
    ordered_cls: np.ndarray,
    class_seq: np.ndarray,
    group: np.ndarray,
    n_groups: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(base[C], M[n_groups, C]) int64 pod counts per (group,
    class-position) over a class-contiguous FFD order; group[i] < 0
    accumulates into `base` (pods valid in every lane, e.g. pending pods
    in a consolidation sweep). Groups with no pods keep zero rows.

    This is THE batching hook behind the removal-set subsystem: a lane
    with membership row m over the groups sees base + m @ M valid pods per
    class (setsweep.py, a device matmul), and the prefix sweep's per-lane
    counts are base + cumsum(M, axis=0) (sweep.py) — the lower-triangular
    special case of the same matrix. Counts stay int64 on the host; the
    callers own the documented int32 guards before any device cast."""
    ordered_cls = np.asarray(ordered_cls)
    group = np.asarray(group)
    C = len(class_seq)
    pos_of_class = {int(c): i for i, c in enumerate(class_seq)}
    base = np.zeros(C, np.int64)
    M = np.zeros((n_groups, C), np.int64)
    for g, c in zip(group, ordered_cls):
        cpos = pos_of_class[int(c)]
        if g < 0:
            base[cpos] += 1
        else:
            M[int(g), cpos] += 1
    return base, M
