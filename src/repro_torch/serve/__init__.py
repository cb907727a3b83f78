"""Serving of the port (counterpart of ``repro.serve``): the batched CNN
engine, the LM decode engine (``engine``), their slot table, graceful
degradation and multi-tenant serving."""
