"""Utilities: ragged batching/padding, profiling counters, checkpoints."""
