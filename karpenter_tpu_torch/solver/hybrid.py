"""TorchHybridScheduler: the solver dispatch — the card first, the oracle
for what the tensor encoding does not cover.

A port of the reference's `solver/hybrid.py` (`HybridScheduler`, `solve`,
`_pristine_oracle_solve`, `solve_in_process`). It is the entry point the
provisioner and the disruption simulation call:

- a topology-free batch below `SchedulerOptions.tpu_min_pods` (the card's
  crossover, solver/oracle.py) runs on the oracle;
- otherwise pods the encoding supports (`tpu_problem.pod_unsupported_reason`
  is None) ride `TorchScheduler` on the device, and the rest continue on the
  oracle against the state the kernels leave behind (the decode writes the
  claims, existing-node usage, pool limits and topology counts back onto
  the shared oracle);
- `UnsupportedBySolver` from encode (raised before any state is mutated)
  falls back to the same oracle;
- any other error during the kernel solve is the last-resort guard: it is
  logged at error level, counted as `tpu_error`, and the whole batch is
  re-solved on a pristine oracle (fresh Topology, fresh Scheduler);
- except a failure of the card itself (`device_failure`: a kernel that did
  not build, load or launch, a CUDA error or out-of-memory from torch),
  which propagates: degrading it to the oracle would hide the card.

The device is chosen when the scheduler is built: `TorchScheduler`'s
constructor resolves `device` (None = the card) outside the guard, so a
machine without CUDA raises there instead of degrading to the oracle.

After `solve()`: `used_tpu`, `fallback_reason` (the reference's message
strings), `fallback_kind` (the reason class: forced, small_batch,
unsupported, tpu_error, partition_continuation; None when every pod rode
the kernel) and `last_phases` (host seconds of the kernel solve and the
oracle part). `SOLVE_FALLBACKS` counts the reason classes.

The sidecar boundary (`CircuitBreaker`, `ResilientSolver`), the solve
traces and the device table cache come with the service slice.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from karpenter_tpu_torch import _build
from karpenter_tpu_torch import logging as klog
from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.api.objects import NodePool, Pod
from karpenter_tpu_torch.cloudprovider.types import InstanceTypes
from karpenter_tpu_torch.solver.nodes import StateNodeView
from karpenter_tpu_torch.solver.oracle import Results, Scheduler, SchedulerOptions
from karpenter_tpu_torch.solver.topology import ClusterSource, Topology
from karpenter_tpu_torch.solver.tpu import TorchScheduler
from karpenter_tpu_torch.solver.tpu_problem import UnsupportedBySolver, pod_unsupported_reason

SOLVE_FALLBACKS = metrics.REGISTRY.counter(
    "karpenter_solve_oracle_fallback_total",
    "Solves (or solve partitions) that ran on the oracle, by reason.",
    ("reason",),
)

_log = klog.root.named("solver")

# torch's errors of the device: out of memory, and (torch 2.8 on) a CUDA
# runtime error; older torch raises the latter as RuntimeError "CUDA error: ..."
_TORCH_DEVICE_ERRORS = (torch.OutOfMemoryError,) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ()
)


def device_failure(e: BaseException) -> bool:
    """True where the card failed, not the host code around it: a kernel
    that did not build, load or launch, or a CUDA error or out-of-memory
    raised by torch. The last-resort guard lets these through."""
    return isinstance(e, (_build.DeviceError, *_TORCH_DEVICE_ERRORS)) or (
        isinstance(e, RuntimeError) and "CUDA error" in str(e)
    )


class TorchHybridScheduler:
    """Same constructor and solve() surface as oracle.Scheduler, plus
    `force_oracle`, `fleet` (a fleet.FleetCoalescer for TorchScheduler) and
    `device` (None = the card; "cpu" for the plain versions)."""

    def __init__(
        self,
        node_pools: list[NodePool],
        instance_types_by_pool: dict[str, InstanceTypes],
        topology: Topology,
        state_nodes: Optional[list[StateNodeView]] = None,
        daemonset_pods: Optional[list[Pod]] = None,
        options: Optional[SchedulerOptions] = None,
        force_oracle: bool = False,
        fleet=None,
        device=None,
    ):
        self.force_oracle = force_oracle
        self.used_tpu: Optional[bool] = None
        self.fallback_reason: Optional[str] = None
        self.fallback_kind: Optional[str] = None
        self.last_phases: dict[str, float] = {}
        # kept for the last-resort guard: a pristine oracle re-solve needs
        # the raw inputs, not the possibly half-mutated shared state
        self._node_pools = node_pools
        self._its_by_pool = instance_types_by_pool
        self._state_nodes = state_nodes
        self._daemonset_pods = daemonset_pods
        self._topology = topology
        if force_oracle:
            self.tpu: Optional[TorchScheduler] = None
            self.oracle = Scheduler(
                node_pools, instance_types_by_pool, topology, state_nodes, daemonset_pods, options
            )
        else:
            self.tpu = TorchScheduler(
                node_pools,
                instance_types_by_pool,
                topology,
                state_nodes,
                daemonset_pods,
                options,
                device=device,
                fleet=fleet,
            )
            self.oracle = self.tpu.oracle
        self.opts = self.oracle.opts

    def _fall_back(self, kind: str, reason: Optional[str]) -> None:
        self.used_tpu = False
        self.fallback_reason = reason
        self.fallback_kind = kind
        SOLVE_FALLBACKS.inc({"reason": kind})

    def _timed(self, phase: str, solve, pods: list[Pod]) -> Results:
        t0 = time.monotonic()
        try:
            return solve(pods)
        finally:
            self.last_phases[phase] = time.monotonic() - t0

    def _oracle_solve(self, pods: list[Pod]) -> Results:
        return self._timed("oracle", self.oracle.solve, pods)

    def solve(self, pods: list[Pod]) -> Results:
        """Never raises UnsupportedBySolver (hybrid.py:150 `solve`)."""
        self.fallback_reason = None
        self.fallback_kind = None
        self.last_phases = {}
        if self.tpu is None:
            self._fall_back("forced", None)
            return self._oracle_solve(pods)

        # below the card's crossover a topology-free batch solves faster on
        # the oracle; topology-bearing problems always ride the kernel
        topo = self.oracle.topology
        if (
            self.opts.tpu_min_pods
            and len(pods) < self.opts.tpu_min_pods
            and not topo.topology_groups
            and not topo.inverse_topology_groups
        ):
            self._fall_back(
                "small_batch",
                f"small topology-free batch ({len(pods)} pods < crossover "
                f"{self.opts.tpu_min_pods}) routed to oracle",
            )
            return self._oracle_solve(pods)

        ignore = self.opts.ignore_preferences
        reasons = [pod_unsupported_reason(p, ignore) for p in pods]
        supported = [p for p, r in zip(pods, reasons) if r is None]
        unsupported = [p for p, r in zip(pods, reasons) if r is not None]
        first_reason = next((r for r in reasons if r is not None), None)
        if unsupported and not supported:
            self._fall_back("unsupported", first_reason)
            return self._oracle_solve(pods)
        try:
            results = self._timed("kernel", self.tpu.solve, supported)
        except UnsupportedBySolver as e:
            # encode_problem raises before mutating the oracle or the
            # shared Topology, so the oracle can run on the same state
            self._fall_back("unsupported", str(e))
            return self._oracle_solve(pods)
        except Exception as e:
            if device_failure(e):
                raise
            # the last-resort guard: an arbitrary failure may have left the
            # shared oracle/topology half-written, so degrade onto PRISTINE
            # state
            self._fall_back(
                "tpu_error",
                f"unexpected TPU-path error, degraded to oracle: {type(e).__name__}: {e}",
            )
            _log.error(
                "TPU path raised unexpectedly; re-solving on a pristine oracle",
                error=f"{type(e).__name__}: {e}",
                pods=len(pods),
            )
            return self._timed("oracle", self._pristine_oracle_solve, pods)
        self.used_tpu = True
        if not unsupported:
            return results
        # continuation: the oracle packs the leftovers into the decoded
        # claims/existing nodes (state and topology already synced)
        self.fallback_reason = f"{len(unsupported)} pod(s) continued on the oracle: {first_reason}"
        self.fallback_kind = "partition_continuation"
        SOLVE_FALLBACKS.inc({"reason": "partition_continuation"})
        cont = self._oracle_solve(unsupported)
        cont.pod_errors.update(results.pod_errors)
        cont.timed_out = cont.timed_out or results.timed_out
        return cont

    def _pristine_oracle_solve(self, pods: list[Pod]) -> Results:
        """Rebuild Topology + Scheduler from the stored constructor inputs
        and solve the FULL pod set (hybrid.py:274). StateNodeViews are
        read-only to the solve, so the fresh scheduler shares them."""
        topology = Topology(
            self._node_pools,
            self._its_by_pool,
            pods,
            cluster=self._topology.cluster,
            state_node_views=self._state_nodes,
            ignore_preferences=self.opts.ignore_preferences,
        )
        self.oracle = Scheduler(
            self._node_pools,
            self._its_by_pool,
            topology,
            self._state_nodes,
            self._daemonset_pods,
            self.opts,
        )
        return self.oracle.solve(pods)


def solve_in_process(
    node_pools: list[NodePool],
    instance_types_by_pool: dict[str, InstanceTypes],
    pods: list[Pod],
    state_node_views: Optional[list[StateNodeView]] = None,
    daemonset_pods: Optional[list[Pod]] = None,
    options: Optional[SchedulerOptions] = None,
    cluster: Optional[ClusterSource] = None,
    force_oracle: bool = False,
    fleet=None,
    device=None,
) -> tuple[Results, TorchHybridScheduler]:
    """The in-process solve assembly (hybrid.py:300): Topology +
    TorchHybridScheduler with the options threaded consistently. The
    scheduler's `last_phases` gains the Topology build's host seconds."""
    t0 = time.monotonic()
    topology = Topology(
        node_pools,
        instance_types_by_pool,
        pods,
        cluster=cluster or ClusterSource(),
        state_node_views=state_node_views,
        ignore_preferences=bool(options and options.ignore_preferences),
    )
    dt = time.monotonic() - t0
    scheduler = TorchHybridScheduler(
        node_pools,
        instance_types_by_pool,
        topology,
        state_node_views,
        daemonset_pods,
        options,
        force_oracle=force_oracle,
        fleet=fleet,
        device=device,
    )
    results = scheduler.solve(pods)
    scheduler.last_phases["topology"] = dt
    return results, scheduler

