"""Shared utilities: training machinery, parameter conversion,
serialization."""
