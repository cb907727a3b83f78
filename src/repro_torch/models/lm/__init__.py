"""LM models of the port (counterpart of ``repro.models.lm``): shared
transformer components (``common``), the MoE layer (``moe``) and the
config-driven model (``model``) for the attention families."""
