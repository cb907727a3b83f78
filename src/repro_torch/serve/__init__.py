"""Serving of the port (counterpart of ``repro.serve``): the batched CNN
engine, its slot table and graceful degradation."""
