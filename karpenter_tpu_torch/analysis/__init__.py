"""The port's analysis: runtime budgets and protocol hooks.

- `budgets.py`, `runtime.py`, `__main__.py`: the runtime budgets,
  `torch_budgets.json` measured and checked (`python -m
  karpenter_tpu_torch.analysis --budgets`), in place of the reference's IR
  and SPMD tiers.
- `protorec`, a copy of the reference's recorder: the solver boundary
  (solver/service.py, solver/hybrid.py) appends events to
  `protorec.RECORDER` while one is installed; the reference's
  `analysis.proto.check_refinement` judges the recorded trace.

The rest of the reference's `analysis` package (the lint tiers, which read
JAX's IR or the reference's sources) is not part of the port.
"""
