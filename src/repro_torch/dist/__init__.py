"""Distributed-execution utilities of the port (counterpart of
``repro.dist``): the BFP gradient wire (``compress``: ``quantize_leaf``
the in-graph model, ``pack_leaf`` / ``wire_report`` the bit-packed
bytes, pinned bit-exact against each other), the logical-axis sharding
annotations on a torch ``DeviceMesh`` (``sharding``: ``axis_rules``,
``shard``, ``resolve_spec``) and the parameter and decode-cache specs
(``specs``: ``param_specs``, ``cache_specs``)."""
from repro_torch.dist import compress, sharding, specs

__all__ = ["compress", "sharding", "specs"]
