"""BFP policy — how block floating point is applied across a model
(counterpart of ``repro.core.policy``).

``None`` means pure float math.  The default policy reproduces the
paper's chosen configuration: scheme eq. (4), 8-bit mantissas (incl.
sign) for both W and I, round-off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.bfp import Rounding, Scheme

__all__ = ["BFPPolicy", "PAPER_DEFAULT", "TPU_TILED", "PALLAS_TILED"]


@dataclasses.dataclass(frozen=True)
class BFPPolicy:
    """Static (hashable) configuration for BFP GEMMs.

    Attributes:
      l_w / l_i: weight / input mantissa bits, INCLUDING sign.
      scheme: matrix partition scheme (paper eq. 2-5, or TILED).
      block_k: K-tile size for Scheme.TILED (None = whole K).
      rounding: ROUND (paper's choice), TRUNCATE, or STOCHASTIC.
      exp_bits: stored exponent width (storage accounting only).
      quantize_weights / quantize_inputs: per-operand enable switches.
      straight_through: gradient estimator: True (the default) gives a
        float backward over the dequantized operands, False quantizes the
        backward GEMMs under this policy (``repro_torch.grad``).
      backend: execution backend name; None selects via ``use_kernel``.
        ``"pallas"`` names the fused kernel backend, which the port runs
        as its CUDA kernels (also registered as ``"cuda"``).
      use_kernel: legacy alias for ``backend="pallas"``.
    """

    l_w: int = 8
    l_i: int = 8
    scheme: Scheme = Scheme.EQ4
    block_k: Optional[int] = None
    rounding: Rounding = Rounding.ROUND
    exp_bits: int = 8
    quantize_weights: bool = True
    quantize_inputs: bool = True
    straight_through: bool = True
    backend: Optional[str] = None
    use_kernel: bool = False

    def __post_init__(self):
        for name, v in (("l_w", self.l_w), ("l_i", self.l_i)):
            if not 2 <= v <= 24:
                raise ValueError(f"{name}={v} out of range [2, 24]")

    @property
    def backend_name(self) -> str:
        """Requested backend, folding in the legacy use_kernel flag."""
        if self.backend is not None:
            return self.backend
        return "pallas" if self.use_kernel else "emulated"

    def with_(self, **kw) -> "BFPPolicy":
        return dataclasses.replace(self, **kw)


#: The paper's headline configuration: eq. (4), 8-bit mantissas, rounding.
PAPER_DEFAULT = BFPPolicy()

#: Tiled variant: K-tiles of 128; strictly lower quantization noise
#: than EQ4.
TPU_TILED = BFPPolicy(scheme=Scheme.TILED, block_k=128)

#: TPU_TILED executed by the fused kernel backend (the CUDA kernels here).
PALLAS_TILED = TPU_TILED.with_(backend="pallas")
