"""Hand-written Hopper kernels of the BFP datapath and their plain
PyTorch versions (counterpart of ``repro.kernels``).

``launch_counts()`` / ``reset_launch_counts()`` read and clear the
per-wrapper kernel launch counters, so a run can show which kernels the
main path went through; ``bfp_matmul_epilogue`` / ``bfp_conv2d_epilogue``
count the calls that ran the requantize epilogue (on the tile kernel in
its launch, on the mma core as the output format pass counted under
``*_oformat``).
"""
from typing import Dict

from repro_torch.kernels import bfp_conv, bfp_matmul, bfp_quantize

__all__ = ["launch_counts", "reset_launch_counts"]

_COUNTERS = (bfp_matmul.LAUNCHES, bfp_conv.LAUNCHES, bfp_quantize.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for name in c:
            c[name] = 0
