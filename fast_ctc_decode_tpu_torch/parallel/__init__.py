"""Batched decode pipeline: one device per process, chosen by the caller."""
