"""The coflow-aware collective planner (port of `repro.collectives`)."""
