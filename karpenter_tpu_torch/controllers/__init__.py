"""The control plane's host copies (the reference's `controllers/`): the
in-memory API store, the cluster-state cache, the Provisioner, the static
pools' node limit and, under `disruption/`, the consolidation sweeps and
controllers. The lifecycle and termination controllers come with the rest
of the Operator's controllers."""
