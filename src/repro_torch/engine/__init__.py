"""Unified BFP GEMM execution engine of the port (counterpart of
``repro.engine``): backend registry, per-layer policies, bound plans,
taps (observers on every GEMM/conv site the engine executes) and
first-class pre-quantized weights."""
from repro_torch.core.prequant import (act_block, dequantize_act, is_prequant,
                                       prequant_act)
from repro_torch.engine.backends import (BackendFallbackWarning,
                                         BackendUnsupportedError,
                                         available_backends, get_backend,
                                         register_backend, select_backend)
from repro_torch.engine.core import (conv2d, conv2d_im2col, gemm,
                                     prequantize, prequantize_cnn)
from repro_torch.engine.plan import Plan, Site, bind, unpack_packed
from repro_torch.engine.policy_map import (PolicyLike, PolicyMap, join_path,
                                           resolve_policy)
from repro_torch.engine.taps import TapEvent, taps

__all__ = [
    "gemm", "conv2d", "conv2d_im2col", "prequantize", "prequantize_cnn",
    "is_prequant", "prequant_act", "dequantize_act", "act_block",
    "bind", "Plan", "Site", "unpack_packed",
    "taps", "TapEvent",
    "PolicyMap", "PolicyLike", "resolve_policy", "join_path",
    "register_backend", "get_backend", "available_backends",
    "select_backend", "BackendFallbackWarning", "BackendUnsupportedError",
]
