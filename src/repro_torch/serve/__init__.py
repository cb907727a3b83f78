"""Serving of the port (counterpart of ``repro.serve``): the batched CNN
engine, its slot table, graceful degradation and multi-tenant serving."""
