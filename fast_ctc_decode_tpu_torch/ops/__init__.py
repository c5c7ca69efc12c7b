"""Device engines and kernel wrappers for batched 1D CTC beam search."""
