"""The control plane's host copies (the reference's `controllers/`): the
in-memory API store, the cluster-state cache and, under `disruption/`, the
consolidation sweeps. The provisioner, lifecycle and disruption
controllers come with the control-plane slice."""
