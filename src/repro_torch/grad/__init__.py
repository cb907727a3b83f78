"""BFP autodiff: quantized backward GEMMs on the engine datapath
(counterpart of ``repro.grad``).

``engine.gemm`` / ``engine.conv2d`` route a call whose float operands
require grad through the autograd functions built here, so the two
backward GEMMs of every site,

    dL/dx = dy @ W^T        (the data gradient)
    dL/dw = x^T @ dy        (the weight gradient)

execute through the same backend registry (float / emulated / cuda,
honest fallback) as the forward, under their own policies resolved on
DERIVED GRAD PATHS: a site ``features/conv1`` owns the backward sites
``features/conv1#dx`` and ``features/conv1#dw``.  A :class:`PolicyMap`
rule whose pattern contains ``#`` is a grad rule and wins on grad paths;
without one, the backward precision follows the forward site policy
(``straight_through=True`` keeps the float straight-through gradients).

Backward executions emit ``engine.taps`` events (``kind="gemm_dx" |
"gemm_dw" | "conv_dx" | "conv_dw"``), so measured gradient NSR is
observable on the real datapath and comparable against the
``core.nsr`` bounds (:func:`measure_gradient_nsr`).
"""
from repro_torch.grad.nsr import GradNSRRecord, measure_gradient_nsr
from repro_torch.grad.paths import (GRAD_KINDS, GradSpec, fit_grad_policy,
                                    grad_path, resolve_grad_policy)
from repro_torch.grad.vjp import conv2d, conv2d_bound, gemm, gemm_bound

__all__ = [
    "GRAD_KINDS", "GradSpec", "grad_path", "resolve_grad_policy",
    "fit_grad_policy",
    "gemm", "gemm_bound", "conv2d", "conv2d_bound",
    "measure_gradient_nsr", "GradNSRRecord",
]
