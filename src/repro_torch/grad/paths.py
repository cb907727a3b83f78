"""Derived grad paths and backward-policy resolution (counterpart of
``repro.grad.paths``).

Every forward site ``path`` owns two backward GEMM sites, named by
suffixing the forward path:

    features/conv1  ->  features/conv1#dx   (data gradient  dy @ W^T)
                        features/conv1#dw   (weight gradient x^T @ dy)

``#`` never appears in a model layer path, so a PolicyMap rule whose
PATTERN contains ``#`` is an explicit grad rule, consulted only for grad
paths; forward resolution is untouched.

Resolution order for a backward GEMM at ``path#dx`` / ``path#dw``:

  1. explicit grad rules (pattern contains ``#``), in rule order, matched
     against the grad path: the first match wins and its policy is used
     as it is (``None`` pins the backward GEMM to float;
     ``straight_through`` configures the forward estimator and is
     ignored on an explicit grad rule);
  2. otherwise the forward site's resolved policy: ``None`` -> float
     backward; ``straight_through=True`` (the default) -> float backward
     over the dequantized operands (the ``core.bfp_dot`` estimator);
     ``straight_through=False`` -> the backward GEMMs quantize under the
     site policy itself.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core import bfp
from repro_torch.core.bfp import Scheme
from repro_torch.core.policy import BFPPolicy
from repro_torch.engine.policy_map import (PolicyLike, PolicyMap, _compiled,
                                           resolve_policy)

__all__ = ["GRAD_KINDS", "GradSpec", "grad_path", "resolve_grad_policy",
           "fit_grad_policy"]

#: The two backward GEMMs of a site, in path-suffix form.
GRAD_KINDS = ("dx", "dw")


@dataclasses.dataclass(frozen=True)
class GradSpec:
    """Bound configuration of one backward GEMM (hashable).

    ``policy=None`` is a float backward GEMM.  ``backend`` is a
    pre-selected :class:`repro_torch.engine.backends.Backend` (``bind``
    fills it in); ``None`` selects per call, which also happens whenever
    :func:`fit_grad_policy` had to change the K-tile for the backward
    contraction depth.
    """

    policy: Optional[BFPPolicy] = None
    backend: Any = None


def grad_path(path: Optional[str], which: str) -> Optional[str]:
    """``path#dx`` / ``path#dw``; anonymous sites stay anonymous."""
    if which not in GRAD_KINDS:
        raise ValueError(f"which must be one of {GRAD_KINDS}, got {which!r}")
    return None if path is None else f"{path}#{which}"


_MISS = object()


def _explicit_grad_rule(policy: PolicyLike, gpath: Optional[str]):
    """First PolicyMap rule with ``#`` in its pattern matching ``gpath``;
    ``_MISS`` when there is none (distinct from a matching None rule,
    which pins the backward GEMM to float)."""
    if isinstance(policy, PolicyMap) and gpath is not None:
        for pattern, pol in policy.rules:
            if "#" in pattern and _compiled(pattern).search(gpath):
                return pol
    return _MISS


def resolve_grad_policy(policy: PolicyLike, path: Optional[str],
                        which: str) -> Optional[BFPPolicy]:
    """Effective policy of one backward GEMM (None = float backward)."""
    hit = _explicit_grad_rule(policy, grad_path(path, which))
    if hit is not _MISS:
        return hit
    pol = resolve_policy(policy, path)
    if pol is None or pol.straight_through:
        return None
    return pol


def fit_grad_policy(pol: Optional[BFPPolicy],
                    k: int) -> Optional[BFPPolicy]:
    """Adapt a TILED policy's K-tile to a backward contraction depth.

    dL/dx contracts over N (out features) and dL/dw over the flattened
    batch M, which rarely divide a forward ``block_k`` like 128.  The
    largest divisor of ``k`` that fits both the requested tile and the
    int32 accumulation bound (``bfp.max_safe_k``) is used instead; the
    fitted policy is what executes, what the backward tap reports and
    what the NSR bound is evaluated against.  Non-TILED schemes have no
    K-tile and pass through unchanged.
    """
    if pol is None or pol.scheme is not Scheme.TILED:
        return pol
    cap = max(1, min(k, bfp.max_safe_k(pol.l_w, pol.l_i)))
    bk = min(pol.block_k or k, cap)
    while k % bk:
        bk -= 1
    return pol if bk == pol.block_k else pol.with_(block_k=bk)
