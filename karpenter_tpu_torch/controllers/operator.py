"""The operator runtime: assembles the store, state cache, provider, and
controllers, and drives them as one simulation-friendly loop.

A copy of the JAX package's `controllers/operator.py` (reference
pkg/operator/operator.go:117-249 + kwok/main.go:29-51). The reference runs
controllers on a manager with watches and leader election; here the same
controllers are driven by an explicit `step()` tick, which is what the
tests call (the reference's envtest suites drive reconcilers manually the
same way).

`device` (None = the card, "cpu" for the plain versions) goes to the
Provisioner and the DisruptionController, which resolve it: without a card
the constructor raises. On the card the kernels' libraries are built at
construction (`_build.build_all`, a no-op where the build's hash directory
holds them), where the JAX package configures its compilation cache, so a
Solve never pays nvcc. A `force_oracle` Operator runs no device code."""

from __future__ import annotations

import time
from typing import Optional

from karpenter_tpu_torch import _build
from karpenter_tpu_torch.api.objects import Pod
from karpenter_tpu_torch.cloudprovider.decorators import (
    InstanceTypeStore,
    MetricsCloudProvider,
    OverlayCloudProvider,
)
from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
from karpenter_tpu_torch.controllers.disruption import DisruptionController
from karpenter_tpu_torch.controllers.kube import FakeClock, SimKube
from karpenter_tpu_torch.controllers.metrics_controllers import (
    NodeMetricsController,
    NodePoolMetricsController,
    PodMetricsController,
)
from karpenter_tpu_torch.controllers.nodeoverlay import NodeOverlayController
from karpenter_tpu_torch.controllers.static import StaticDeprovisioning, StaticProvisioning
from karpenter_tpu_torch.controllers.lifecycle import NodeClaimLifecycle
from karpenter_tpu_torch.controllers.nodeclaim_aux import (
    Consistency,
    Expiration,
    GarbageCollection,
    Hydration,
    NodeClaimDisruptionConditions,
    PodEvents,
)
from karpenter_tpu_torch.controllers.nodepool_aux import (
    NodeHealth,
    NodePoolCounter,
    NodePoolHash,
    NodePoolReadiness,
    NodePoolValidation,
    RegistrationHealth,
)
from karpenter_tpu_torch.controllers.provisioning import Provisioner
from karpenter_tpu_torch.controllers.state import Cluster, is_provisionable, wire_informers
from karpenter_tpu_torch.controllers.termination import NodeTermination
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.events import Recorder
from karpenter_tpu_torch.options import Options


class Operator:
    """NewOperator + WithControllers + Start, in simulation time."""

    def __init__(
        self,
        clock=None,
        cloud_provider=None,
        options: Optional[Options] = None,
        force_oracle: bool = False,
        solver=None,
        device=None,
    ):
        self.clock = clock or FakeClock()
        self.opts = options or Options()
        self.device = None if force_oracle else resolve_device(device)
        # a restarted operator must not pay nvcc inside a Solve
        # (provisioner.go:366 1-min budget): build, or find built, every
        # library of the sources' hash before the first reconcile
        if self.device is not None and self.device.type == "cuda":
            _build.build_all()
        # structured logging (reference operator/logging/logging.go): one
        # JSON-lines root, level from options, timestamps from the sim clock
        from karpenter_tpu_torch import logging as klog

        klog.root.set_level(self.opts.log_level)
        klog.root.set_clock(self.clock)
        self.kube = SimKube(self.clock)
        self.cluster = Cluster(self.clock)
        wire_informers(self.kube, self.cluster)
        self.recorder = Recorder(self.clock)
        raw_cloud = cloud_provider or KwokCloudProvider(self.kube, self.clock)
        # decorator stack (kwok/main.go:31-38): overlay over metrics over raw
        self.raw_cloud = raw_cloud
        self.overlay_store = InstanceTypeStore()
        decorated = MetricsCloudProvider(raw_cloud)
        if self.opts.feature_gates.node_overlay:
            decorated = OverlayCloudProvider(decorated, self.overlay_store)
        self.cloud = decorated
        self.provisioner = Provisioner(
            self.kube,
            self.cluster,
            self.cloud,
            self.clock,
            self.opts,
            self.recorder,
            force_oracle=force_oracle,
            device=self.device,
            # optional ResilientSolver: route solves through the sidecar
            # boundary with the in-process ladder as the floor
            solver=solver,
        )
        self.lifecycle = NodeClaimLifecycle(
            self.kube, self.cluster, self.cloud, self.clock, self.opts, self.recorder
        )
        self.termination = NodeTermination(
            self.kube, self.cluster, self.cloud, self.clock, self.recorder,
            workers=self.opts.termination_workers,
        )
        self.disruption = DisruptionController(
            self.kube,
            self.cluster,
            self.cloud,
            self.provisioner,
            self.clock,
            self.opts,
            self.recorder,
            force_oracle=force_oracle,
            device=self.device,
        )
        # aux controllers (reference pkg/controllers/controllers.go:66 registry)
        self.nodepool_hash = NodePoolHash(self.kube)
        self.nodepool_counter = NodePoolCounter(self.kube, self.cluster)
        self.nodepool_readiness = NodePoolReadiness(self.kube, self.cloud)
        self.nodepool_validation = NodePoolValidation(self.kube, self.recorder)
        self.registration_health = RegistrationHealth(self.kube)
        self.lifecycle.registration_health = self.registration_health
        self.hydration = Hydration(self.kube)
        self.pod_events = PodEvents(self.kube, self.cluster, self.clock)
        self.claim_conditions = NodeClaimDisruptionConditions(
            self.kube, self.cluster, self.cloud, self.clock
        )
        self.expiration = Expiration(self.kube, self.clock, self.recorder)
        self.garbage_collection = GarbageCollection(self.kube, self.cloud, self.clock)
        self.consistency = Consistency(self.kube, self.cluster, self.recorder)
        self.node_health = (
            NodeHealth(self.kube, self.cluster, self.cloud, self.clock, self.recorder)
            if self.opts.feature_gates.node_repair
            else None
        )
        # static-capacity pools provision via their own loop (controllers.go:139
        # gate; provisioning.py excludes replicas!=None pools for this reason)
        self.static_provisioning = (
            StaticProvisioning(self.kube, self.cluster, self.recorder)
            if self.opts.feature_gates.static_capacity
            else None
        )
        self.static_deprovisioning = (
            StaticDeprovisioning(self.kube, self.cluster, self.recorder)
            if self.opts.feature_gates.static_capacity
            else None
        )
        self.node_overlay = (
            NodeOverlayController(self.kube, self.raw_cloud, self.overlay_store)
            if self.opts.feature_gates.node_overlay
            else None
        )
        # HTTP probe surface (operator.go:183-221), opt-in via probe_port
        self.probes = None
        if self.opts.probe_port is not None:
            from karpenter_tpu_torch.controllers.probes import ProbeServer

            self.probes = ProbeServer(
                self.kube,
                self.cluster,
                port=self.opts.probe_port,
                enable_profiling=self.opts.enable_profiling,
            )
            self.probes.start()
        # leader election (operator.go:157-182): configured via lease_path;
        # a standby keeps its informers/cache warm but acts on nothing
        self.elector = None
        if self.opts.leader_elect_lease_path:
            from karpenter_tpu_torch.leaderelection import LeaderElector

            # lease timestamps are persisted and compared ACROSS process
            # lifetimes, so only a wall clock is valid there — RealClock is
            # monotonic (epoch = host boot) and would wedge every candidate
            # in standby after a reboot. The sim's FakeClock is fine: tests
            # control it explicitly and share it between candidates.
            self.elector = LeaderElector(
                self.opts.leader_elect_lease_path,
                lease_duration=self.opts.leader_elect_lease_seconds,
                renew_period=self.opts.leader_elect_renew_seconds,
                clock=self.clock if isinstance(self.clock, FakeClock) else None,
            )
        self.node_metrics = NodeMetricsController(self.cluster)
        self.nodepool_metrics = NodePoolMetricsController(self.kube)
        self.pod_metrics = PodMetricsController(self.kube, self.cluster, self.clock)
        # pure observability: poll on an interval like the reference's
        # metrics controllers, not every reconcile round
        self._metrics_interval = 10.0
        self._metrics_last = -1e18
        self.last_phases: dict[str, float] = {}

        # trigger controllers (provisioning/controller.go:44): watch events
        def triggers(event: str, kind: str, obj) -> None:
            if kind == "Pod" and event in ("added", "updated"):
                if isinstance(obj, Pod) and is_provisionable(obj):
                    self.provisioner.trigger_pod(obj)
            if kind == "Node" and event == "updated":
                if obj.metadata.deletion_timestamp is not None:
                    self.provisioner.trigger_node_deletion(obj.name)

        self.kube.subscribe(triggers)

    def stop(self) -> None:
        """Release process-level resources: the probe HTTP server's socket
        and thread, and the global logger's reference to this sim's clock.
        Like the reference's one-manager-per-process model, logging config
        (level) is process-global — two concurrent Operators share it."""
        if self.probes is not None:
            self.probes.stop()
            self.probes = None
        if self.elector is not None:
            self.elector.release()  # hand off without waiting out the lease
        from karpenter_tpu_torch import logging as klog

        if klog.root._clock is self.clock:
            klog.root.set_clock(None)

    # -- loop -------------------------------------------------------------

    def step(self, advance_seconds: float = 1.0) -> None:
        """One control-plane tick: advance time, flush provider async work,
        run every controller once (informer updates flow synchronously via
        the store subscription). `last_phases` holds each controller's host
        seconds in this tick, in the order they ran."""
        if isinstance(self.clock, FakeClock):
            self.clock.advance(advance_seconds)
        self.last_phases = {}
        if self.elector is not None and not self.elector.ensure():
            return  # standby: informers stay warm via store subscriptions
        for name, reconcile in self._controllers():
            t0 = time.monotonic()
            reconcile()
            self.last_phases[name] = self.last_phases.get(name, 0.0) + time.monotonic() - t0

    def _controllers(self):
        """(name, reconcile) of every controller a tick runs, in order."""
        if hasattr(self.cloud, "reconcile"):
            yield "cloud", self.cloud.reconcile  # KWOK registration delays
        yield "nodepool_hash", self.nodepool_hash.reconcile_all
        yield "nodepool_readiness", self.nodepool_readiness.reconcile_all
        yield "nodepool_validation", self.nodepool_validation.reconcile_all
        yield "registration_health", self.registration_health.reconcile_all
        yield "hydration", self.hydration.reconcile_all
        yield "lifecycle", self.lifecycle.reconcile_all
        yield "termination", self.termination.reconcile_all
        yield "expiration", self.expiration.reconcile_all
        yield "garbage_collection", self.garbage_collection.reconcile
        yield "pod_events", self.pod_events.reconcile_all
        yield "claim_conditions", self.claim_conditions.reconcile_all
        yield "nodepool_counter", self.nodepool_counter.reconcile_all
        yield "consistency", self.consistency.reconcile_all
        if self.node_health is not None:
            yield "node_health", self.node_health.reconcile_all
        if self.node_overlay is not None:
            yield "node_overlay", self.node_overlay.reconcile_all
        if self.static_provisioning is not None:
            yield "static_provisioning", self.static_provisioning.reconcile_all
        if self.static_deprovisioning is not None:
            yield "static_deprovisioning", self.static_deprovisioning.reconcile_all
        if self.clock.now() - self._metrics_last >= self._metrics_interval:
            self._metrics_last = self.clock.now()
            yield "metrics", self._reconcile_metrics
        yield "provisioner", self._provision
        if self.disruption is not None:
            yield "disruption", self.disruption.reconcile

    def _reconcile_metrics(self) -> None:
        self.node_metrics.reconcile_all()
        self.nodepool_metrics.reconcile_all()
        self.pod_metrics.reconcile_all()

    def _provision(self) -> None:
        # the pod trigger controller requeues provisionable pods continuously
        # (provisioning/controller.go:60); without it a pod that failed or
        # awaits a node would never reopen the batch window
        for pod in self.kube.pending_pods():
            self.provisioner.trigger_pod(pod)
        self.provisioner.reconcile()

    def run_until_settled(self, max_ticks: int = 60, advance_seconds: float = 2.0) -> int:
        """Step until no pending pods remain and all claims are initialized
        (or the tick budget runs out). Returns ticks used."""
        for tick in range(1, max_ticks + 1):
            self.step(advance_seconds)
            if self.settled():
                return tick
        return max_ticks

    def settled(self) -> bool:
        from karpenter_tpu_torch.api.objects import COND_INITIALIZED

        if self.kube.pending_pods():
            return False
        for claim in self.kube.list("NodeClaim"):
            if claim.metadata.deletion_timestamp is not None:
                return False
            if claim.status.conditions.get(COND_INITIALIZED) != "True":
                return False
        for node in self.kube.list("Node"):
            if node.metadata.deletion_timestamp is not None:
                return False
        return True
