"""Core BFP library of the port (counterpart of ``repro.core``)."""
from repro_torch.core.bfp import (BFPBlock, Rounding, Scheme, quantize,
                                  dequantize, bfp_quantize_matrix,
                                  block_exponent, pow2,
                                  average_bits_per_element,
                                  num_block_exponents, accumulator_bits,
                                  max_safe_k)
from repro_torch.core.bfp_dot import bfp_dot, bfp_matmul_2d
from repro_torch.core.policy import (BFPPolicy, PAPER_DEFAULT, TPU_TILED,
                                     PALLAS_TILED)

__all__ = [
    "BFPBlock", "Rounding", "Scheme", "quantize", "dequantize",
    "bfp_quantize_matrix", "block_exponent", "pow2",
    "average_bits_per_element", "num_block_exponents", "accumulator_bits",
    "max_safe_k", "bfp_dot", "bfp_matmul_2d", "BFPPolicy", "PAPER_DEFAULT",
    "TPU_TILED", "PALLAS_TILED",
]
