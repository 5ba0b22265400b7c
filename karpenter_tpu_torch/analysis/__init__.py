"""Runtime protocol hooks: `protorec`, a copy of the reference's recorder.

The solver boundary (solver/service.py, solver/hybrid.py) appends events
to `protorec.RECORDER` while one is installed; the reference's
`analysis.proto.check_refinement` judges the recorded trace. The rest of
the reference's `analysis` package (the lint tiers, which read JAX's IR)
is not part of the port.
"""
