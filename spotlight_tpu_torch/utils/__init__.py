"""Shared utilities: training machinery, parameter conversion,
serialization, result logs and profiling."""
