"""Continuous-batching serving runtime and its policy objects."""
