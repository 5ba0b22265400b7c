"""Consolidation (the reference's `controllers/disruption/`): candidates,
the scheduling simulation that referees a removal, and the batched
feasibility sweeps over candidate removal sets (`sweep.py`,
`setsweep.py`)."""
