"""IVF + PQ index, batched searchers and the serving engine."""
