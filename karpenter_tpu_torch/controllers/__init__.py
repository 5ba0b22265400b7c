"""The control plane: a copy of the JAX package's `controllers/` on the
port's solver (reference pkg/controllers/ and pkg/operator/).

- kube.py          — the in-memory API store (SimKube) + watches + clocks
- state.py         — the cluster-state cache (Cluster, StateNode)
- provisioning.py  — Batcher + Provisioner (provisioner.go:119-586)
- lifecycle.py     — NodeClaim launch/registration/initialization/liveness
- termination.py   — node drain + removal (termination/controller.go)
- nodeclaim_aux.py, nodepool_aux.py, static.py, nodeoverlay.py,
  metrics_controllers.py, probes.py — the auxiliary controllers
- disruption/      — the consolidation sweeps (K6, K7, K8) and controllers
- operator.py      — wires it all into one step()-driven runtime
"""

from karpenter_tpu_torch.controllers.kube import Conflict, FakeClock, RealClock, SimKube
from karpenter_tpu_torch.controllers.lifecycle import NodeClaimLifecycle
from karpenter_tpu_torch.controllers.operator import Operator
from karpenter_tpu_torch.controllers.provisioning import Batcher, Provisioner, VolumeTopology
from karpenter_tpu_torch.controllers.state import Cluster, StateNode, wire_informers
from karpenter_tpu_torch.controllers.termination import NodeTermination

__all__ = [
    "Batcher",
    "Cluster",
    "Conflict",
    "FakeClock",
    "NodeClaimLifecycle",
    "NodeTermination",
    "Operator",
    "Provisioner",
    "RealClock",
    "SimKube",
    "StateNode",
    "VolumeTopology",
    "wire_informers",
]
