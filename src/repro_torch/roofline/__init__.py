"""Roofline analysis of the port (counterpart of ``repro.roofline``): the
per-device cost counter over fake-tensor traces (``counter``), the H100
roofline terms (``analysis``), per-call FLOP attribution (``hlo_flops``),
the markdown report over the dry run's JSONs (``report``) and the SPMD
rules a traced step is split by (``partition``)."""
from repro_torch.roofline import (analysis, counter, hlo_flops, partition,
                                  report)

__all__ = ["analysis", "counter", "hlo_flops", "partition", "report"]
