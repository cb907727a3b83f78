"""Bound execution plans — resolve/select/quantize ONCE, then just run
(counterpart of ``repro.engine.plan``).

``engine.bind(params, policy)`` walks the param tree once, resolves each
GEMM/conv site's policy on its layer path, selects the backend up front
(raising under ``strict`` when it cannot honour the policy), moves the
weights to ``device`` and pre-quantizes every eligible weight into the
``{"m", "s"}`` wire format:

    plan = engine.bind(params, policy)
    logits = vgg.apply(plan.params, x, plan)     # plan rides the policy arg

Chained layers hand activations over in the wire format:

    y = plan.conv2d(x, w1, path="conv3_1",
                    out_policy=plan.out_policy_for("conv3_2"))
    z = plan.conv2d(y, w2, path="conv3_2")

Backward plans (``Site.dx``/``dw``) are bound with the forward: each
site's two backward GEMMs resolve on the derived grad paths
(``path#dx`` / ``path#dw``, ``repro_torch.grad``) and select their
backend at bind time, so a strict bind refuses an unsupported backward
backend before any training step runs.  A call whose float operands
require grad takes the autograd route with the site's bound specs.

``model_paths=`` restricts the bound sites to an explicit list (and
scopes prequantization to it) and binds policy-only entries for paths
the walk cannot see, as ``repro``'s ``bind`` does.

LM trees (``tree="lm"``, or ``"auto"`` on a tree with ``embed`` /
``layers``) bind every GEMM weight the LM walkers select
(``core.prequant.lm_eligible``) on its runtime path
(``lm_rule_path``: "attn/wq", "ffn/w1", "moe/w1", "lm_head").  A stacked
leaf (``[L, K, N]``, or ``[L, E, K, N]`` MoE experts) is one ``gemm``
site for all its layers, backend support judged on the leaf's dtype as
for a 2-D one (every trailing ``[K, N]`` matrix shares it), and where
two leaves alias one runtime path the first in the tree's sorted walk
wins, as in ``repro``.  Paths the walk cannot see (the MoE experts'
runtime path "moe") resolve per call against the original policy.

``tune_cache=`` attaches a :class:`repro_torch.tune.TuneCache` (or a
path): the plan activates it around every bound execution, so each
kernel launches with its site's tuned tile (``kernels.ops``); the
cache's ``hits`` / ``misses`` count those lookups.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Any, Dict, Iterable, Optional, Tuple, Union

import torch

from repro_torch import _tree
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.bfp import Rounding, Scheme
from repro_torch.core.packed import is_packed, unpack_prequant
from repro_torch.core.policy import BFPPolicy
from repro_torch.core.prequant import (cnn_rule_path, detect_tree_kind,
                                       is_prequant, lm_eligible, lm_rule_path,
                                       quantize_cnn_param_tree,
                                       quantize_param_tree)
from repro_torch.engine import backends as BK
from repro_torch.engine import taps as TAPS
from repro_torch.engine.core import (_grad_vjp, _routed, conv_and_tap,
                                     gemm_and_tap)
from repro_torch.engine.policy_map import PolicyLike, PolicyMap, resolve_policy
from repro_torch.grad.paths import GradSpec, grad_path, resolve_grad_policy

__all__ = ["Site", "Plan", "bind", "params_to", "unpack_packed"]


def unpack_packed(params: Any, device: DeviceLike = "cuda") -> Any:
    """Replace every :class:`~repro_torch.core.packed.PackedBFP` leaf with
    its ``{"m", "s"}`` prequant sidecar on ``device`` — the packed-artifact
    load path (a checkpoint restored with ``packed="keep"``): the
    container unpacks straight into the wire format every backend
    executes, so no float weight is ever materialized for a
    prequant-eligible site.  Fixed- and variable-width containers decode
    through the same call.  A tree without packed leaves passes through
    untouched (the same object)."""
    leaves, _ = _tree.flatten(params, is_leaf=is_packed)
    if not any(is_packed(leaf) for leaf in leaves):
        return params
    dev = resolve_device(device)
    return _tree.map_with_path(
        lambda _, leaf: unpack_prequant(leaf, dev) if is_packed(leaf)
        else leaf, params, is_leaf=is_packed)


@dataclasses.dataclass(frozen=True)
class Site:
    """One bound GEMM/conv execution site."""

    path: str
    kind: str                       #: "gemm" | "conv"
    policy: Optional[BFPPolicy]     #: resolved concrete policy (None=float)
    backend: BK.Backend             #: concrete execution, selected at bind
    fallback: bool = False          #: backend != the policy's requested one
    prequantized: bool = False      #: weight leaf holds the wire format
    #: backward-GEMM plans resolved on the derived grad paths
    #: (``path#dx`` / ``path#dw``) at bind time, policy and backend; None
    #: (a hand-built Site) resolves per call against the site's policy
    dx: Optional[GradSpec] = None
    dw: Optional[GradSpec] = None


class Plan:
    """Immutable per-site execution table returned by :func:`bind`.

    ``plan.params`` is the (pre-quantized) tree the model should be
    applied with; the plan itself rides the ``policy`` argument.
    """

    def __init__(self, sites: Dict[str, Site], params: Any,
                 policy: PolicyLike, strict: bool = False,
                 device: Optional[torch.device] = None,
                 tune_cache: Any = None):
        self._sites = dict(sites)
        self.sites = types.MappingProxyType(self._sites)
        self.params = params
        self.policy = policy
        self.strict = strict
        self.device = device
        #: TuneCache attached at bind time: every bound execution runs
        #: with it active, so kernels launch with the tuned tiles of their
        #: (shape, L, target) site
        self.tune_cache = tune_cache
        #: per-plan forwards keyed by apply function (see jit_forward)
        self._fwd_cache: Dict[Any, Any] = {}
        #: downgrades already warned on unbound paths of this plan
        self._warned: set = set()

    def __repr__(self) -> str:
        n_bfp = sum(1 for s in self._sites.values() if s.policy is not None)
        return (f"Plan({len(self._sites)} sites, {n_bfp} BFP, "
                f"strict={self.strict})")

    def site(self, path: str) -> Site:
        return self._sites[path]

    def resolve(self, path: Optional[str]) -> Optional[BFPPolicy]:
        """Concrete policy for ``path`` (the ``resolve_policy`` protocol)."""
        s = self._sites.get(path)
        if s is not None:
            return s.policy
        return resolve_policy(self.policy, path)

    def _tuned(self):
        """Context activating this plan's tune cache (no-op when none)."""
        if self.tune_cache is None:
            return contextlib.nullcontext()
        from repro_torch.tune.cache import use_cache
        return use_cache(self.tune_cache)

    def out_policy_for(self, path: Optional[str]) -> Optional[BFPPolicy]:
        """The resolved policy for ``path`` IF its execution would
        quantize its input to the activation wire format — the
        ``out_policy=`` the PRODUCING layer should pass so the handoff
        skips the f32 round-trip.  None when ``path`` is float, does not
        quantize inputs, or its input blocks are not the wire format
        (non-TILED, no block, not round-to-nearest, L_I > 8)."""
        pol = self.resolve(path)
        if pol is None or not pol.quantize_inputs:
            return None
        if (pol.scheme is not Scheme.TILED or not pol.block_k
                or pol.rounding is not Rounding.ROUND or pol.l_i > 8):
            return None
        return pol

    def gemm(self, x: Any, w: Any, *, path: Optional[str] = None,
             out_policy=None, noise=None) -> Any:
        if self.tune_cache is not None:
            with self._tuned():
                return self._gemm(x, w, path, out_policy, noise)
        return self._gemm(x, w, path, out_policy, noise)

    def _gemm(self, x, w, path, out_policy, noise):
        site = self._sites.get(path)
        routed = _routed(x, w, noise, out_policy)
        if site is not None and site.kind == "gemm":
            if routed:
                return _grad_vjp().gemm_bound(x, w, site)
            return gemm_and_tap(x, w, site.policy, backend=site.backend,
                                path=path, out_policy=out_policy,
                                noise=noise)
        # unbound path: per-call resolution (strict kept)
        if routed:
            return _grad_vjp().gemm(x, w, self.policy, path, self.strict)
        return gemm_and_tap(x, w, resolve_policy(self.policy, path),
                            strict=self.strict, path=path,
                            out_policy=out_policy, warned=self._warned,
                            noise=noise)

    def conv2d(self, x: Any, w: Any, *, path: Optional[str] = None,
               stride: int = 1, padding: str = "SAME",
               out_policy=None, noise=None) -> Any:
        if self.tune_cache is not None:
            with self._tuned():
                return self._conv2d(x, w, path, stride, padding, out_policy,
                                    noise)
        return self._conv2d(x, w, path, stride, padding, out_policy, noise)

    def _conv2d(self, x, w, path, stride, padding, out_policy, noise):
        site = self._sites.get(path)
        routed = _routed(x, w, noise, out_policy, padding)
        if site is not None and site.kind == "conv":
            if routed:
                return _grad_vjp().conv2d_bound(x, w, site, stride, padding)
            return conv_and_tap(x, w, site.policy, stride, padding,
                                backend=site.backend, path=path,
                                out_policy=out_policy, noise=noise)
        if routed:
            return _grad_vjp().conv2d(x, w, self.policy, stride, padding,
                                      path, self.strict)
        return conv_and_tap(x, w, resolve_policy(self.policy, path), stride,
                            padding, strict=self.strict, path=path,
                            out_policy=out_policy, warned=self._warned,
                            noise=noise)

    def jit_forward(self, apply_fn):
        """``apply_fn(plan.params, x, plan)`` as one callable, cached per
        ``apply_fn`` on this plan, so every engine bound to the same plan
        and model shares one object.  PyTorch runs eagerly, so nothing is
        traced: the callable runs under ``torch.inference_mode()`` with
        tap events suppressed, as ``repro``'s compiled forward emits
        none (call ``apply_fn`` itself to observe the sites), and with
        the plan's tune cache active."""
        fn = self._fwd_cache.get(apply_fn)
        if fn is None:
            def fwd(x, *args, _apply=apply_fn):
                with torch.inference_mode(), TAPS.suppressed(), \
                        self._tuned():
                    return _apply(self.params, x, self, *args)
            fn = fwd
            self._fwd_cache[apply_fn] = fn
        return fn

    def describe(self) -> str:
        """Human-readable site table (examples / serving admission logs),
        in ``repro``'s layout; the grad column names each bound backward
        GEMM's L and backend (``float`` for a float one)."""
        lines = []
        for path in sorted(self._sites):
            s = self._sites[path]
            pol = ("float" if s.policy is None else
                   f"L_W={s.policy.l_w},L_I={s.policy.l_i},"
                   f"{s.policy.scheme.value}")
            extra = (" (fallback)" if s.fallback else "") + \
                    (" [prequant]" if s.prequantized else "")

            def gdesc(spec):
                if spec is None or spec.policy is None:
                    return "float"
                gp = spec.policy
                be = spec.backend.name if spec.backend is not None else "?"
                return f"L{gp.l_w}/{gp.l_i}@{be}"

            grad = f" grad[dx={gdesc(s.dx)},dw={gdesc(s.dw)}]"
            lines.append(f"{path:<24} {s.kind:<5} {pol:<24} "
                         f"-> {s.backend.name}{extra}{grad}")
        return "\n".join(lines)


def _validate_policy_backends(policy: PolicyLike) -> None:
    """Every backend a policy (or PolicyMap rule) names must exist —
    raise the available_backends KeyError at BIND time."""
    pols = []
    if isinstance(policy, PolicyMap):
        pols = [p for _, p in policy.rules] + [policy.default]
    elif isinstance(policy, BFPPolicy):
        pols = [policy]
    for p in pols:
        if p is not None:
            BK.get_backend(p.backend_name)


class _ScopedPolicy:
    """``resolve_policy`` adapter limiting a policy to an explicit site
    set: leaves outside ``wanted`` resolve to None (stay float)."""

    def __init__(self, policy: PolicyLike, wanted):
        self._policy, self._wanted = policy, wanted

    def resolve(self, path):
        if path not in self._wanted:
            return None
        return resolve_policy(self._policy, path)


def params_to(params: Any, device: torch.device) -> Any:
    """The tree with every tensor leaf on ``device``."""
    return _tree.map_with_path(
        lambda _, leaf: leaf.to(device) if isinstance(leaf, torch.Tensor)
        else leaf, params)


def _discover_lm_sites(params: Any):
    """Yield (runtime_path, "gemm", weight_leaf) for every GEMM weight of
    an LM tree in the tree's sorted walk (``repro``'s leaf order) — the
    same selection and path derivation the LM prequant walker uses."""
    for path, leaf in _tree.leaves_with_path(params, is_leaf=is_prequant):
        keys = [str(k) for k in path]
        arr = leaf["m"] if is_prequant(leaf) else leaf
        if not isinstance(arr, torch.Tensor) or arr.ndim < 2 \
                or not lm_eligible(keys):
            continue
        yield lm_rule_path(keys), "gemm", leaf


def _discover_sites(params: Any):
    """Yield (runtime_path, kind, weight_leaf) for every conv/GEMM weight
    of a CNN tree — the same path derivation the prequant walker uses."""
    found = []

    def walk(node, keys):
        if is_prequant(node):
            found.append((keys, node))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, keys + [str(i)])
        else:
            found.append((keys, node))

    walk(params, [])
    for keys, leaf in found:
        arr = leaf["m"] if is_prequant(leaf) else leaf
        if not isinstance(arr, torch.Tensor):
            continue
        rpath = cnn_rule_path(params, keys)
        if rpath is None:
            continue
        if arr.ndim == 4:
            yield rpath, "conv", leaf
        elif arr.ndim == 2:
            yield rpath, "gemm", leaf


def bind(params: Any, policy: PolicyLike,
         model_paths: Optional[Iterable[Union[str, Tuple[str, str]]]] = None,
         *, tree: str = "auto", strict: bool = False,
         prequantize: bool = True, device: DeviceLike = "cuda",
         tune_cache: Any = None) -> Plan:
    """Bind ``policy`` to a model's parameters: one walk, one Plan.

    Args:
      params: model param tree (``models.cnn`` or ``models.lm``
        conventions; an already
        pre-quantized tree is fine — quantization is idempotent — and so
        is one with :class:`~repro_torch.core.packed.PackedBFP` leaves,
        unpacked here by :func:`unpack_packed`).
      policy: None / BFPPolicy / PolicyMap — resolved per site, once.
      model_paths: optional explicit site list — strings or (path, kind)
        pairs.  Restricts the discovered sites to these paths (and the
        prequantization to their leaves) and binds policy-only entries
        (no weight checks, no prequant; kind "gemm" unless given) for
        paths the tree walk cannot see.  Default: every site found.
      tree: "cnn" | "lm" | "auto" — which path convention the tree uses.
      strict: refuse (raise) backend downgrades instead of the once-per-
        site :class:`BackendFallbackWarning` and the emulated fallback —
        also applied to unbound-path dispatch at call time.
      prequantize: convert eligible weight leaves to the wire format.
      device: where the plan's params live (default "cuda"; raises when
        CUDA is absent unless the caller passes "cpu").
      tune_cache: a :class:`repro_torch.tune.TuneCache` (or a path:
        loaded here, a missing file is an empty cache) of tuned tiles;
        the plan activates it around every bound execution.  Entries of
        the CPU (``"interpret"``) and of the card
        (``tune.cache.CARD_TARGET``) each apply only on their own device.

    Raises KeyError for policies naming unknown backends, and (under
    ``strict``) :class:`BackendUnsupportedError` when a requested backend
    cannot honour its policy at a site.
    """
    dev = resolve_device(device)
    _validate_policy_backends(policy)
    if isinstance(tune_cache, str):
        from repro_torch.tune.cache import TuneCache
        tune_cache = TuneCache.load(tune_cache)
    # packed artifacts (checkpoint restore(packed="keep")) unpack straight
    # into {"m", "s"} sidecars on the plan's device — never through float
    params = unpack_packed(params, dev)
    kind = detect_tree_kind(params) if tree == "auto" else tree
    if kind not in ("cnn", "lm"):
        raise ValueError(f"tree must be 'cnn', 'lm', or 'auto'; got {kind!r}")
    wanted: Optional[Dict[str, Optional[str]]] = None
    if model_paths is not None:
        wanted = {}
        for mp in model_paths:
            if isinstance(mp, str):
                wanted[mp] = None
            else:
                wanted[mp[0]] = mp[1]
    qparams = params_to(params, dev)
    if prequantize:
        # a model_paths restriction scopes prequantization too: sites
        # outside it are not bound, so their leaves stay float
        quantizer = (quantize_param_tree if kind == "lm"
                     else quantize_cnn_param_tree)
        qparams = quantizer(qparams, policy if wanted is None
                            else _ScopedPolicy(policy, wanted))
    warned: set = set()   # fresh per bind: each plan reports its own

    def bind_grad(path: str, which: str) -> GradSpec:
        # a backward plan resolves on the derived grad path; a float
        # backward GEMM needs no backend, a BFP one selects (and under
        # strict refuses) its backend here, before any training step.
        # The backward GEMMs contract transposed or gradient operands, so
        # support is checked on the policy alone; a K-tile fitted at call
        # time (grad.fit_grad_policy) selects again then
        gpol = resolve_grad_policy(policy, path, which)
        if gpol is None:
            return GradSpec(None, None)
        gpath = grad_path(path, which)
        if (gpol.backend_name, path) in warned:
            # the forward site already warned of this downgrade: no second
            # and third warning for #dx / #dw (strict raises regardless)
            warned.add((gpol.backend_name, gpath))
        be = BK.select_backend(gpol, None, strict=strict, path=gpath,
                               warned=warned)
        return GradSpec(gpol, be)

    def site(path, skind, leaf, prequantized):
        pol = resolve_policy(policy, path)
        if pol is None:
            be, fb = BK.get_backend("float"), False
        else:
            be = BK.select_backend(pol, leaf, strict=strict, path=path,
                                   warned=warned)
            fb = be.name != pol.backend_name
        return Site(path, skind, pol, be, fb, prequantized=prequantized,
                    dx=bind_grad(path, "dx"), dw=bind_grad(path, "dw"))

    sites: Dict[str, Site] = {}
    discover = _discover_lm_sites if kind == "lm" else _discover_sites
    for path, skind, leaf in discover(qparams):
        if path in sites or (wanted is not None and path not in wanted):
            continue
        sites[path] = site(path, skind, leaf, is_prequant(leaf))
    for path, skind in (wanted or {}).items():
        if path not in sites:   # policy-only entries for unseen paths
            sites[path] = site(path, skind or "gemm", None, False)
    return Plan(sites, qparams, policy, strict, device=dev,
                tune_cache=tune_cache)
