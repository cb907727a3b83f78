"""LM models of the port (counterpart of ``repro.models.lm``): shared
transformer components (``common``), the MoE layer (``moe``), RWKV-6's
time and channel mixing (``rwkv6``), Griffin's RG-LRU block
(``griffin``) and the config-driven model (``model``) for every
family."""
