"""Distributed-execution utilities of the port (counterpart of
``repro.dist``): so far the BFP gradient wire, ``compress``
(``quantize_leaf`` the in-graph model, ``pack_leaf`` / ``wire_report``
the actual bit-packed bytes, pinned bit-exact against each other).  The
sharding annotations and parameter specs (``repro.dist.sharding`` /
``specs``) are not ported yet."""
