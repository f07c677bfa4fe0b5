"""Continuous-batching serving on the dense KV cache."""
