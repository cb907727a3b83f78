"""Per-layer BFP policy resolution — paper Table 3 as configuration
(counterpart of ``repro.engine.policy_map``).

A :class:`PolicyMap` is an ordered list of (regex, policy) rules matched
against a layer path ("conv1_1", "fc6", ...); first match wins, a rule
whose policy is ``None`` pins that layer to float, unmatched paths fall
through to ``default``.  JSON written by ``repro``'s ``to_dict`` loads
unchanged through :meth:`PolicyMap.from_dict`.
"""
from __future__ import annotations

import dataclasses
import re
from functools import lru_cache
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.core.bfp import Rounding, Scheme
from repro_torch.core.policy import BFPPolicy

__all__ = ["PolicyMap", "PolicyLike", "resolve_policy", "join_path"]


@lru_cache(maxsize=1024)
def _compiled(pattern: str) -> "re.Pattern[str]":
    return re.compile(pattern)


@dataclasses.dataclass(frozen=True)
class PolicyMap:
    """Ordered (pattern, policy) rules; first ``re.search`` match wins."""

    rules: Tuple[Tuple[str, Optional[BFPPolicy]], ...] = ()
    default: Optional[BFPPolicy] = None

    @classmethod
    def of(cls, *pairs: Tuple[str, Optional[BFPPolicy]],
           default: Optional[BFPPolicy] = None) -> "PolicyMap":
        return cls(rules=tuple((str(p), pol) for p, pol in pairs),
                   default=default)

    def resolve(self, path: Optional[str]) -> Optional[BFPPolicy]:
        """Policy for ``path`` (None path -> default)."""
        if path is not None:
            for pattern, pol in self.rules:
                if _compiled(pattern).search(path):
                    return pol
        return self.default

    def with_default(self, default: Optional[BFPPolicy]) -> "PolicyMap":
        """The same rules with ``default`` for unmatched paths."""
        return dataclasses.replace(self, default=default)

    @classmethod
    def from_dict(cls, cfg: Dict[str, Any]) -> "PolicyMap":
        """Build from plain data (e.g. JSON): {"rules": [{"pattern": ...,
        "policy": {...} or null}], "default": {...} or null}."""
        def mk(d):
            if d is None:
                return None
            kw = dict(d)
            if "scheme" in kw:
                kw["scheme"] = Scheme(kw["scheme"])
            if "rounding" in kw:
                kw["rounding"] = Rounding(kw["rounding"])
            return BFPPolicy(**kw)

        rules = tuple((r["pattern"], mk(r.get("policy")))
                      for r in cfg.get("rules", ()))
        return cls(rules=rules, default=mk(cfg.get("default")))

    def to_dict(self) -> Dict[str, Any]:
        """Plain-data form, the exact inverse of :meth:`from_dict`."""
        def dd(p: Optional[BFPPolicy]) -> Optional[Dict[str, Any]]:
            if p is None:
                return None
            d = dataclasses.asdict(p)
            d["scheme"] = p.scheme.value
            d["rounding"] = p.rounding.value
            return d

        return {"rules": [{"pattern": pat, "policy": dd(pol)}
                          for pat, pol in self.rules],
                "default": dd(self.default)}


#: None (float), a BFPPolicy (uniform), a PolicyMap (per-layer rules), or
#: a bound ``repro_torch.engine.Plan``.
PolicyLike = Union[None, BFPPolicy, PolicyMap, "repro_torch.engine.plan.Plan"]


def resolve_policy(policy: PolicyLike,
                   path: Optional[str] = None) -> Optional[BFPPolicy]:
    """Collapse a PolicyLike to a concrete per-GEMM policy (or None);
    PolicyMap and Plan both implement ``.resolve(path)``."""
    if policy is None or isinstance(policy, BFPPolicy):
        return policy
    return policy.resolve(path)


def join_path(*parts: Optional[str]) -> Optional[str]:
    """'/'-join non-empty path components; None if all empty."""
    ps = [p for p in parts if p]
    return "/".join(ps) if ps else None
