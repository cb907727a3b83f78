"""Automated per-layer mantissa-width search (Ristretto-style; counterpart
of ``repro.tune.precision``).

The paper's headline answer — 8-bit mantissas cost < 0.3% accuracy —
is global: one L for every layer.  :func:`search_precision` asks it per
site, on the real datapath, step for step as ``repro`` does:

  1. a float forward and a global-``l_max`` baseline forward run under
     ``engine.taps``;
  2. phase A: per site, the weight width ``l_w`` descends greedily from
     ``l_max`` while the site's measured output NSR against the float
     run stays within ``nsr_budget`` and the batch top-1 agreement with
     the baseline stays within ``top1_tol``;
  3. phase B: the joint assignment is validated and repaired: while a
     site is over budget or the agreement slips, the worst-margin site
     (or, for agreement alone, the narrowest) gains a bit back;
  4. the winner runs once more with ``want_float`` taps, and each site's
     fresh quantization NSR is reported beside the analytic
     :func:`repro_torch.core.nsr.gemm_nsr_upper_bound`.

The result is a :class:`~repro_torch.engine.PolicyMap` (an exact-match
rule per site, ``l_max`` default) and a per-site report; saved with
``checkpoint.store.save(format="bfp_packed_v2", policy=map)`` it shrinks
each narrowed site below the fixed-L container.  An unsatisfiable budget
raises :class:`PrecisionSearchError` up front.  Activations keep
``l_i = l_max``.

What differs from ``repro``, and why:

* **Inputs.** ``jax.random`` streams cannot be reproduced, so ``seed``
  draws the params (``spec.init``) and the images from
  ``torch.Generator`` s; ``params=`` and ``x=`` take given ones instead
  (``repro``'s exported tree and inputs, in the parity test).
* **NSR on the device.** The per-site energies are float64 sums on the
  tensors' device (one VGG16 batch-8 run taps ~430 MB, and a search
  makes ~100 runs), not numpy's: the reduction order differs, so NSRs
  agree with ``repro``'s to a relative tolerance, not to the bit.
* **The bound at a ragged block.** Where a TILED block does not divide a
  site's K (VGG16's conv1_1 at block 128 on the kernels), ``repro``'s
  quantizer raises; the port takes the bound over the kernels'
  zero-padded K-tiles, the blocks the kernels multiply, which still
  bounds the fresh NSR (a padded zero adds no error).
* **The datapath.** The default base policy (``TPU_TILED`` with no
  block) runs on the emulated datapath, as in ``repro``.  A base on the
  kernel backend with a block the int8 mma core takes (``PALLAS_TILED``:
  block 128) runs every L_w 2-8 with L_i 8 on the core; a kernel policy
  with ``block_k=None`` is refused by the kernel backend (in both
  packages) and falls back to the emulated datapath, warned.

Runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import engine as EG
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import nsr
from repro_torch.core.bfp import Scheme
from repro_torch.core.policy import TPU_TILED, BFPPolicy
from repro_torch.engine import PolicyMap
from repro_torch.engine.plan import params_to
from repro_torch.models.cnn import MODELS, head_logits
from repro_torch.models.cnn.analysis import _site_matrices

__all__ = ["PrecisionSearchError", "SiteReport", "PrecisionResult",
           "search_precision"]

_TINY = float(np.finfo(np.float32).tiny)


class PrecisionSearchError(ValueError):
    """The declared budget cannot be met: the global-``l_max`` baseline
    already violates the NSR budget at some site (or the repair loop
    would have to exceed ``l_max``); the message names the site."""


@dataclasses.dataclass
class SiteReport:
    """One searched site of the emitted PolicyMap."""
    path: str
    kind: str                 #: "gemm" | "conv"
    l_w: int                  #: chosen weight mantissa width (incl. sign)
    nsr_measured: float       #: site output NSR vs the float run
    nsr_fresh: float          #: fresh quantization NSR (``want_float``)
    nsr_bound: float          #: analytic gemm_nsr_upper_bound at l_w


@dataclasses.dataclass
class PrecisionResult:
    """A winning per-site width assignment and its evidence."""
    model: str
    seed: int
    l_max: int
    l_min: int
    nsr_budget: float
    top1_tol: float
    policy_map: PolicyMap
    sites: List[SiteReport]
    top1_agreement: float     #: final map vs global-l_max baseline
    n_evals: int              #: tapped forwards the search spent

    @property
    def assignment(self) -> Dict[str, int]:
        return {s.path: s.l_w for s in self.sites}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model, "seed": self.seed,
            "l_max": self.l_max, "l_min": self.l_min,
            "nsr_budget": self.nsr_budget, "top1_tol": self.top1_tol,
            "top1_agreement": self.top1_agreement,
            "n_evals": self.n_evals,
            "policy_map": self.policy_map.to_dict(),
            "sites": [dataclasses.asdict(s) for s in self.sites],
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


def _site_nsrs(ev_f: List[EG.TapEvent],
               ev_q: List[EG.TapEvent]) -> Dict[str, float]:
    """Per-path measured output NSR of a candidate run against the float
    run (energies summed in float64 on the device over repeat visits)."""
    if len(ev_f) != len(ev_q):
        raise RuntimeError(
            f"float/candidate runs executed different site counts "
            f"({len(ev_f)} vs {len(ev_q)})")
    sig: Dict[str, torch.Tensor] = {}
    err: Dict[str, torch.Tensor] = {}
    for f, q in zip(ev_f, ev_q):
        if f.path != q.path:
            raise RuntimeError(f"site order diverged: {f.path} vs {q.path}")
        if q.policy is None:
            continue
        yf, yq = f.y.double(), q.y.double()
        p = f.path or "?"
        sig[p] = sig.get(p, 0.0) + torch.sum(yf * yf)
        err[p] = err.get(p, 0.0) + torch.sum(torch.square(yq - yf))
    return {p: float(err[p]) / max(float(sig[p]), _TINY) for p in sig}


def _agreement(logits: torch.Tensor, ref_labels: torch.Tensor) -> float:
    return float((torch.argmax(logits, dim=-1) == ref_labels)
                 .double().mean())


def _site_map(base: BFPPolicy, widths: Dict[str, int]) -> PolicyMap:
    """Exact-match rule per site (escaped, anchored), base as default."""
    rules = tuple((f"^{re.escape(p)}$", base.with_(l_w=l))
                  for p, l in widths.items())
    return PolicyMap(rules=rules, default=base)


def _bound_operands(x2d: torch.Tensor, w2d: torch.Tensor,
                    policy: BFPPolicy) -> Tuple[torch.Tensor, torch.Tensor]:
    """The site's GEMM operands, K zero-padded to the kernels' TILED
    blocks where the block does not divide K (``repro`` raises there)."""
    k, bk = x2d.shape[1], policy.block_k
    if policy.scheme is not Scheme.TILED or not bk or k % bk == 0:
        return x2d, w2d
    pad = -k % bk
    return F.pad(x2d, (0, pad)), F.pad(w2d, (0, 0, 0, pad))


def search_precision(model: str = "lenet", *, seed: int = 0,
                     batch: int = 8, l_max: int = 8, l_min: int = 2,
                     nsr_budget: float = 1e-3, top1_tol: float = 0.0,
                     base_policy: Optional[BFPPolicy] = None,
                     reduced: bool = True, verbose: bool = False,
                     params: Any = None, x: Any = None,
                     device: DeviceLike = "cuda") -> PrecisionResult:
    """Greedy per-site ``l_w`` search over one registry CNN (``repro``'s
    arguments, plus ``params=`` / ``x=`` / ``device=``).

    ``nsr_budget`` bounds each site's measured output NSR against the
    float forward (1e-3 ~= 30 dB); ``top1_tol`` is the tolerated fraction
    of the batch whose top-1 class may differ from the global-``l_max``
    baseline's.  Raises :class:`PrecisionSearchError` when the budget is
    unsatisfiable even at ``l_max``.
    """
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r} (have "
                         f"{sorted(MODELS)})")
    if not 2 <= l_min <= l_max <= 24:
        raise ValueError(f"need 2 <= l_min <= l_max <= 24, got "
                         f"l_min={l_min}, l_max={l_max}")
    if nsr_budget < 0:
        raise ValueError(f"nsr_budget must be >= 0, got {nsr_budget}")
    dev = resolve_device(device)
    spec = MODELS[model]
    if params is None:
        params = spec.init(torch.Generator().manual_seed(seed),
                           reduced=reduced, device=dev)
    else:
        params = params_to(params, dev)
    if x is None:
        x = torch.randn((batch, *spec.input_shape(reduced=reduced)),
                        generator=torch.Generator().manual_seed(seed + 1))
    x = torch.as_tensor(x).to(dev)
    base = (base_policy if base_policy is not None
            else TPU_TILED.with_(block_k=None))
    base = base.with_(l_w=l_max, l_i=l_max, straight_through=False)
    n_evals = 0

    def run(policy, want_float: bool = False
            ) -> Tuple[List[EG.TapEvent], torch.Tensor]:
        nonlocal n_evals
        evs: List[EG.TapEvent] = []
        with torch.no_grad(), EG.taps(evs.append, want_float=want_float):
            out = spec.apply(params, x, policy)
        n_evals += 1
        return evs, head_logits(out)

    ev_float, _ = run(None)

    # --- global-l_max baseline: the budget's feasibility gate -------------
    ev_base, logits_base = run(base)
    ref_labels = torch.argmax(logits_base, dim=-1)
    base_nsr = _site_nsrs(ev_float, ev_base)
    if not base_nsr:
        raise ValueError(f"model {model!r} executed no quantizable sites "
                         f"under the base policy — nothing to search")
    for p, v in base_nsr.items():
        if v > nsr_budget:
            raise PrecisionSearchError(
                f"nsr_budget {nsr_budget:g} is unsatisfiable: site "
                f"{p!r} measures NSR {v:.3g} already at the maximum "
                f"width l_w={l_max} — no narrower assignment can meet "
                f"the budget; raise the budget or l_max")
    order: List[str] = []
    for ev in ev_base:
        p = ev.path or "?"
        if ev.policy is not None and p not in order:
            order.append(p)
    del ev_base

    # --- phase A: independent per-site descent (Ristretto sweep) ----------
    chosen = {p: l_max for p in order}
    for p in order:
        for L in range(l_max - 1, l_min - 1, -1):
            evs, logits = run(_site_map(base, {p: L}))
            ok = (_site_nsrs(ev_float, evs)[p] <= nsr_budget
                  and _agreement(logits, ref_labels) >= 1.0 - top1_tol)
            del evs
            if not ok:
                break
            chosen[p] = L
        if verbose:
            print(f"[precision] {model}/{p}: l_w {l_max} -> {chosen[p]}",
                  flush=True)

    # --- phase B: joint validation + hillclimb repair ---------------------
    max_repairs = sum(l_max - chosen[p] for p in order)
    for _ in range(max_repairs + 1):
        evs, logits = run(_site_map(base, chosen))
        nsrs = _site_nsrs(ev_float, evs)
        del evs
        agree = _agreement(logits, ref_labels)
        over = {p: nsrs[p] / max(nsr_budget, _TINY)
                for p in order if nsrs[p] > nsr_budget}
        if not over and agree >= 1.0 - top1_tol:
            break
        raisable = [p for p in order if chosen[p] < l_max]
        if not raisable:
            raise PrecisionSearchError(
                f"joint repair exhausted: every site is back at "
                f"l_max={l_max} yet the budget is still violated "
                f"(agreement {agree:.3f}, over-budget {sorted(over)})")
        # worst NSR margin first; pure-agreement violations raise the
        # narrowest (noisiest-per-bit) site instead
        over_raisable = [p for p in raisable if p in over]
        target = (max(over_raisable, key=lambda p: over[p])
                  if over_raisable
                  else min(raisable, key=lambda p: chosen[p]))
        chosen[target] += 1
        if verbose:
            print(f"[precision] repair: {target} -> l_w "
                  f"{chosen[target]}", flush=True)

    # --- final evidence: fresh NSR vs the analytic bound ------------------
    final_map = _site_map(base, chosen)
    evs, logits = run(final_map, want_float=True)
    nsrs = _site_nsrs(ev_float, evs)
    agree = _agreement(logits, ref_labels)
    fresh: Dict[str, float] = {}
    bound: Dict[str, float] = {}
    kinds: Dict[str, str] = {}
    for ev in evs:
        if ev.policy is None:
            continue
        p = ev.path or "?"
        if p in fresh:
            continue
        yf = ev.y_float.double()
        e = float(torch.sum(torch.square(ev.y.double() - yf)))
        fresh[p] = e / max(float(torch.sum(yf * yf)), _TINY)
        x2d, w2d = _bound_operands(*_site_matrices(ev), ev.policy)
        bound[p] = float(nsr.gemm_nsr_upper_bound(x2d, w2d, ev.policy))
        kinds[p] = ev.kind
    sites = [SiteReport(path=p, kind=kinds[p], l_w=chosen[p],
                        nsr_measured=float(nsrs[p]),
                        nsr_fresh=float(fresh[p]),
                        nsr_bound=float(bound[p])) for p in order]
    return PrecisionResult(model=model, seed=seed, l_max=l_max,
                           l_min=l_min, nsr_budget=nsr_budget,
                           top1_tol=top1_tol, policy_map=final_map,
                           sites=sites, top1_agreement=agree,
                           n_evals=n_evals)
