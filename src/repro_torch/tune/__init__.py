"""Tile tables of the port (counterpart of ``repro.tune``); only what the
kernel wrappers need so far."""
