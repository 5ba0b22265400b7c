"""Operator options: the flat flag/env/feature-gate config system
(reference pkg/operator/options/options.go:67-216); a copy of the JAX
package's `options.py`, which imports only the standard library. The one
value that differs is `tpu_min_pods`, the card's own crossover, which it
takes from the solver (`solver.oracle.TPU_MIN_PODS`).

One dataclass carries every knob; `from_env` applies KARPENTER_* environment
fallbacks; feature gates parse from the same comma-separated string the
reference uses. Controllers receive Options explicitly (the reference
injects it through context.Context — explicit wiring is the Python idiom).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from karpenter_tpu_torch.solver.oracle import TPU_MIN_PODS


@dataclass
class FeatureGates:
    """options.go:110 FeatureGates string:
    NodeRepair,ReservedCapacity,SpotToSpotConsolidation,NodeOverlay,StaticCapacity"""

    node_repair: bool = False
    reserved_capacity: bool = False
    spot_to_spot_consolidation: bool = False
    node_overlay: bool = False
    static_capacity: bool = False

    @classmethod
    def parse(cls, gates: str) -> "FeatureGates":
        out = cls()
        mapping = {
            "NodeRepair": "node_repair",
            "ReservedCapacity": "reserved_capacity",
            "SpotToSpotConsolidation": "spot_to_spot_consolidation",
            "NodeOverlay": "node_overlay",
            "StaticCapacity": "static_capacity",
        }
        for part in gates.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                name, val = part.split("=", 1)
                enabled = val.strip().lower() == "true"
            else:
                name, enabled = part, True
            attr = mapping.get(name.strip())
            if attr is not None:
                setattr(out, attr, enabled)
        return out


@dataclass
class Options:
    # batching (options.go:126-127)
    batch_idle_duration_seconds: float = 1.0
    batch_max_duration_seconds: float = 10.0
    # scheduling
    preference_policy: str = "Respect"  # Respect | Ignore
    min_values_policy: str = "Strict"  # Strict | BestEffort
    solve_timeout_seconds: float = 60.0  # provisioner.go:366
    tpu_claim_slot_div: int = 16  # SchedulerOptions.claim_slot_div
    tpu_min_pods: int = TPU_MIN_PODS  # SchedulerOptions.tpu_min_pods; 0 disables routing
    # disruption
    disruption_poll_seconds: float = 10.0  # disruption/controller.go:69
    multinode_consolidation_timeout_seconds: float = 60.0
    # singlenodeconsolidation.go:31 SingleNodeConsolidationTimeoutDuration:
    # the per-candidate walk gets 3 minutes, distinct from the multi-node
    # bisection's 1-minute budget above
    singlenode_consolidation_timeout_seconds: float = 180.0
    # MultiNodeConsolidation search strategy ladder entry rung:
    # "sets" (arbitrary removal sets, disruption/setsweep.py) |
    # "batched" (prefix sweep) | "binary" (reference bisection);
    # unsupported shapes fall down the ladder automatically
    multinode_sweep_strategy: str = "sets"
    # termination reconciler pool width (termination/controller.go:58-60
    # scales 100->5000 in the reference; 1 keeps the sim deterministic)
    termination_workers: int = 1
    # lifecycle liveness TTLs (lifecycle/liveness.go)
    launch_ttl_seconds: float = 300.0
    registration_ttl_seconds: float = 900.0
    # client emulation
    kube_client_qps: int = 200
    kube_client_burst: int = 300
    # observability
    log_level: str = "info"
    # start the /healthz /readyz /metrics HTTP surface on this port when
    # set (0 = pick a free port); None = no HTTP server (tests, benchmarks)
    probe_port: "int | None" = None
    enable_profiling: bool = False
    # HA: when lease_path is set, step() acts only while holding the lease
    # (operator.go:157-182 leader election); standbys keep informers warm
    leader_elect_lease_path: "str | None" = None
    leader_elect_lease_seconds: float = 15.0
    leader_elect_renew_seconds: float = 5.0
    feature_gates: FeatureGates = field(default_factory=FeatureGates)

    @classmethod
    def from_env(cls, env: dict | None = None) -> "Options":
        env = dict(os.environ if env is None else env)
        opts = cls()

        def f(key: str, cast, attr: str) -> None:
            raw = env.get(key)
            if raw is not None:
                try:
                    setattr(opts, attr, cast(raw))
                except ValueError:
                    pass

        f("KARPENTER_BATCH_IDLE_DURATION", float, "batch_idle_duration_seconds")
        f("KARPENTER_BATCH_MAX_DURATION", float, "batch_max_duration_seconds")
        f("KARPENTER_PREFERENCE_POLICY", str, "preference_policy")
        f("KARPENTER_MIN_VALUES_POLICY", str, "min_values_policy")
        f("KARPENTER_KUBE_CLIENT_QPS", int, "kube_client_qps")
        f("KARPENTER_KUBE_CLIENT_BURST", int, "kube_client_burst")
        f("KARPENTER_LOG_LEVEL", str, "log_level")
        f("KARPENTER_PROBE_PORT", int, "probe_port")
        f("KARPENTER_TERMINATION_WORKERS", int, "termination_workers")
        f("KARPENTER_TPU_CLAIM_SLOT_DIV", int, "tpu_claim_slot_div")
        f("KARPENTER_TPU_MIN_PODS", int, "tpu_min_pods")
        f(
            "KARPENTER_SINGLENODE_CONSOLIDATION_TIMEOUT",
            float,
            "singlenode_consolidation_timeout_seconds",
        )
        f("KARPENTER_MULTINODE_SWEEP_STRATEGY", str, "multinode_sweep_strategy")
        f("KARPENTER_LEADER_ELECT_LEASE_PATH", str, "leader_elect_lease_path")
        f("KARPENTER_LEADER_ELECT_LEASE_SECONDS", float, "leader_elect_lease_seconds")
        f("KARPENTER_LEADER_ELECT_RENEW_SECONDS", float, "leader_elect_renew_seconds")
        gates = env.get("KARPENTER_FEATURE_GATES")
        if gates:
            opts.feature_gates = FeatureGates.parse(gates)
        return opts
