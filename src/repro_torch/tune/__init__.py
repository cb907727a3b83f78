"""repro_torch.tune — tile autotuning and the per-site precision search
(counterpart of ``repro.tune``).

* :mod:`~repro_torch.tune.tables` — the default tile table.
* :mod:`~repro_torch.tune.cache` — the persistent JSON cache of tuned
  tiles (``repro``'s file format and keys; the card's entries under
  their own target, ``cache.CARD_TARGET``) and the process-wide active
  cache ``kernels.ops`` consults at every call.
* :mod:`~repro_torch.tune.autotune` — the hillclimber that fills it
  (``python -m repro_torch.tune``).
* :mod:`~repro_torch.tune.precision` — the per-site mantissa-width
  search (``python -m repro_torch.tune --precision``).

``engine.bind(..., tune_cache=cache)`` attaches a cache to a Plan; every
GEMM and conv the plan executes then launches with its tuned tile.
"""
from repro_torch.tune.autotune import time_us, tune_conv, tune_gemm
from repro_torch.tune.cache import (CARD_TARGET, SCHEMA, TuneCache,
                                    get_cache, lookup_tiles, set_cache,
                                    use_cache)
from repro_torch.tune.precision import (PrecisionResult,
                                        PrecisionSearchError, SiteReport,
                                        search_precision)
from repro_torch.tune.tables import (aligned_tile, conv_row_tile,
                                     fallback_tiles, overflow_cap)

__all__ = ["TuneCache", "SCHEMA", "CARD_TARGET", "set_cache", "get_cache",
           "use_cache", "lookup_tiles", "tune_gemm", "tune_conv", "time_us",
           "aligned_tile", "fallback_tiles", "overflow_cap",
           "conv_row_tile", "search_precision", "PrecisionResult",
           "PrecisionSearchError", "SiteReport"]
