"""Bucket-based result buffer, batched collectors and re-rank planning."""
