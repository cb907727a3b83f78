"""Backend registry for the BFP GEMM engine (counterpart of
``repro.engine.backends``).

  float     disabled-quant baseline: plain ``x @ w`` (prequant weights are
            dequantized first) — the paper's floating-point reference.
  emulated  the integer datapath in plain PyTorch (``core.bfp_dot``):
            exact fixed-point MACs, every scheme and rounding; no kernel.
  cuda      the hand-written Hopper kernels (``repro_torch.kernels``):
            Scheme.TILED only; with prequant weights it runs the
            sidecar-consuming kernel variant, with wire-format activations
            the x-prequant variants, and it runs the requantize epilogue
            in the same kernel call (``act_prequant``/``out_quant``).  Registered under "pallas"
            too, so policies and PolicyMap JSON written by ``repro`` (whose
            fused-kernel backend has that name) load unchanged.

``select_backend`` honours ``policy.backend`` but falls back to
``emulated`` when the requested backend cannot execute the policy
faithfully (a paper scheme, stochastic or truncating rounding, an int16
prequant mantissa on the kernels) — with a
:class:`BackendFallbackWarning`, or a :class:`BackendUnsupportedError`
under ``strict``, exactly as ``repro`` does.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Optional, Set, Tuple

import torch

from repro_torch.core.bfp import Rounding, Scheme
from repro_torch.core.bfp_dot import bfp_matmul_2d, bfp_matmul_2d_prequant
from repro_torch.core.policy import BFPPolicy
from repro_torch.core.prequant import dequantize_prequant, is_prequant

__all__ = ["Backend", "register_backend", "get_backend",
           "available_backends", "select_backend",
           "BackendFallbackWarning", "BackendUnsupportedError"]

#: (x2d, w_or_prequant, policy[, noise=]) -> out [B, N]; ``noise`` (the
#: uniform noise of x's STOCHASTIC rounding) is passed only when given
MatmulFn = Callable[[torch.Tensor, object, Optional[BFPPolicy]],
                    torch.Tensor]

#: (x_nhwc, w_hwio_or_prequant, policy, stride, padding) -> out NHWC
ConvFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    matmul: MatmulFn
    supports: Callable[[BFPPolicy, object], bool]
    #: optional fused convolution; ``None`` means engine.conv2d routes
    #: this backend through the materialized-im2col + matmul fallback
    conv: Optional[ConvFn] = None
    #: (policy, w, stride, padding) -> can ``conv`` honour this faithfully?
    conv_supports: Callable[..., bool] = lambda pol, w, stride, pad: False
    #: can ``matmul``/``conv`` consume the activation wire format
    #: ``{"m", "s"}`` natively (cuda: the x-prequant kernels)?  False means
    #: the engine dequantizes it first — bit-identical by quantization
    #: idempotence, one more round-trip through device memory.
    act_prequant: bool = False
    #: do ``matmul``/``conv`` take ``out_policy=`` and emit the wire format
    #: themselves (the kernel call's requantize epilogue)?  False means
    #: the engine requantizes the float output in a second step.
    out_quant: bool = False


_REGISTRY: Dict[str, Backend] = {}


def register_backend(name: str, matmul: MatmulFn,
                     supports: Optional[Callable] = None,
                     conv: Optional[ConvFn] = None,
                     conv_supports: Optional[Callable] = None,
                     act_prequant: bool = False,
                     out_quant: bool = False) -> None:
    _REGISTRY[name] = Backend(
        name, matmul, supports or (lambda pol, w: True), conv,
        conv_supports or (lambda pol, w, stride, pad: conv is not None),
        act_prequant, out_quant)


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown BFP backend {name!r}; available: "
                       f"{available_backends()}") from None


def available_backends():
    return sorted(_REGISTRY)


class BackendFallbackWarning(UserWarning):
    """A requested backend could not honour a policy and was downgraded."""


class BackendUnsupportedError(ValueError):
    """strict mode: the requested backend cannot honour the policy."""


#: (backend, path) pairs already warned about on the bare per-call path:
#: a downgrade is warned once per site, not per forward.  ``engine.bind``
#: passes a fresh set per bind, so every plan reports its own downgrades.
_WARNED: Set[Tuple[str, Optional[str]]] = set()


def select_backend(policy: BFPPolicy, w, *, strict: bool = False,
                   path: Optional[str] = None,
                   warned: Optional[Set] = None) -> Backend:
    """The requested backend if it supports (policy, w); else emulated.

    The downgrade is never silent: it emits a
    :class:`BackendFallbackWarning`, once per (backend, site) against
    ``warned`` (callers like ``engine.bind`` pass a fresh set per bind;
    per-call dispatch shares a process-wide one); with ``strict=True`` it
    raises :class:`BackendUnsupportedError` instead, so a deployment that
    asked for the kernels fails loudly rather than drifting onto the
    emulated path.
    """
    be = get_backend(policy.backend_name)
    if be.supports(policy, w):
        return be
    msg = (f"backend {be.name!r} cannot honour policy "
           f"(scheme={policy.scheme}, rounding={policy.rounding}, "
           f"l_w={policy.l_w})" + (f" at site {path!r}" if path else ""))
    if strict:
        raise BackendUnsupportedError(
            msg + "; refusing the emulated fallback (strict mode)")
    reg = _WARNED if warned is None else warned
    if (be.name, path) not in reg:
        reg.add((be.name, path))
        warnings.warn(msg + "; falling back to 'emulated'",
                      BackendFallbackWarning, stacklevel=2)
    return _REGISTRY["emulated"]


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------

def _float_matmul(x2d, w, policy=None, noise=None):
    if is_prequant(w):
        w = dequantize_prequant(w, x2d.dtype)
    dt = torch.promote_types(x2d.dtype, w.dtype)    # as jnp's @ promotes
    return x2d.to(dt) @ w.to(dt)


def _emulated_matmul(x2d, w, policy, noise=None):
    if is_prequant(w):
        out = bfp_matmul_2d_prequant(x2d, w["m"], w["s"], policy, noise)
        return out.to(x2d.dtype)
    out = bfp_matmul_2d(x2d, w, policy, noise)
    return out.to(torch.result_type(x2d, w))


def _cuda_matmul(x2d, w, policy, out_policy=None, noise=None):
    # x2d may be the activation wire format (a previous layer's epilogue
    # output): ops dispatches the x-prequant kernels; out_policy asks for
    # the requantize epilogue.
    from repro_torch.kernels import ops
    if is_prequant(w):
        return ops.bfp_matmul_prequant(x2d, w["m"], w["s"], policy,
                                       out_policy=out_policy)
    return ops.bfp_matmul(x2d, w, policy, out_policy=out_policy)


def _cuda_supports(policy: BFPPolicy, w) -> bool:
    # The kernels implement exactly Scheme.TILED with block == K tile,
    # round-to-nearest, both operands quantized, int8 prequant mantissas.
    if policy.scheme is not Scheme.TILED or policy.block_k is None:
        return False
    if policy.rounding is not Rounding.ROUND:
        return False
    if not (policy.quantize_weights and policy.quantize_inputs):
        return False
    if is_prequant(w) and w["m"].dtype != torch.int8:
        return False
    return True


def _cuda_conv(x, w, policy, stride, padding, out_policy=None):
    from repro_torch.kernels import ops
    if is_prequant(w):
        return ops.bfp_conv2d_prequant(x, w["m"], w["s"], policy, stride,
                                       padding, out_policy=out_policy)
    return ops.bfp_conv2d(x, w, policy, stride, padding,
                          out_policy=out_policy)


def _cuda_conv_supports(policy: BFPPolicy, w, stride, padding) -> bool:
    if padding not in ("SAME", "VALID"):
        return False
    if not isinstance(stride, int) or stride < 1:
        return False
    return _cuda_supports(policy, w)


register_backend("float", _float_matmul)
register_backend("emulated", _emulated_matmul)
for _name in ("cuda", "pallas"):
    register_backend(_name, _cuda_matmul, _cuda_supports, conv=_cuda_conv,
                     conv_supports=_cuda_conv_supports, act_prequant=True,
                     out_quant=True)
