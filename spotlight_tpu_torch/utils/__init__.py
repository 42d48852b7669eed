"""Shared utilities: generators, padding, parameter conversion."""
