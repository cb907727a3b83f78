"""Checkpoints of the port (counterpart of ``repro.checkpoint``): atomic
float32 and packed-BFP artifacts, readable by either package."""
