"""Hillclimb autotuner for the BFP kernels' tiles (counterpart of
``repro.tune.autotune``).

Each candidate is timed (:func:`time_us`: the median of a few
synchronized calls after a warmup), the winner lands in a
:class:`~repro_torch.tune.cache.TuneCache`, and a site already in the
cache is skipped.  The walk is ``repro``'s greedy one: evaluate the
start, then every neighbour, move to the best, repeat until no
neighbour wins or ``max_steps`` evaluations are spent.  What a tile can
be depends on where the call runs, and the walk offers nothing more:

* **On the card** (target ``tune.cache.CARD_TARGET``) a call runs on one
  of two cores (``kernels.bfp_matmul.matmul_core``,
  ``kernels.bfp_conv.conv_core``; a pure function of shape and policy).
  The int8 mma core has four (rows, columns) tiles
  (``kernels._mma.MMA_TILES``), which ``_mma.mma_tile`` chooses by rule;
  the walk starts from that choice and moves along the list (neighbours
  +-1), skipping tiles whose stages do not fit shared memory at the
  block.  A GEMM whose policy names no block (``block_k=None``) also
  moves ``bk`` over powers of two from 32 to 512, within
  ``tables.overflow_cap`` and K; a tuned ``bk`` IS the BFP block then
  and changes the bits, as in ``repro``.  A pinned block never moves: it
  is semantics.  The tile kernel's tile is fixed at compile time
  (``_mma.tile_kernel_tile``), so a site routed there is timed once and
  stored with ``steps: 1``.  There is no Pallas row tile (``t_oh``):
  the core tiles patch rows.
* **On the CPU** (target ``"interpret"``) the walk is ``repro``'s own
  power-of-two lattice of (bm, bn, bk) for a GEMM and (t_oh, bn) for a
  conv, from ``tables.fallback_tiles`` / ``conv_row_tile``; the plain
  versions run, whose bits depend only on a free ``bk``.

    cache = TuneCache.load("tune_cache.json")
    tune_gemm(b, k, n, policy, cache=cache)   # no-op if already cached
    cache.save()
    plan = engine.bind(params, policy, tune_cache=cache)

``prequant=True`` times the sidecar route (weights quantized once, as a
bound plan serves them) under the same key.  :func:`tune_plan` tunes
every kernel site of a bound plan at the shapes one forward gives it.
Every entry point runs on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.conv_utils import conv_geometry
from repro_torch.core.prequant import prequant_conv_leaf, prequant_leaf
from repro_torch.tune.cache import TuneCache
from repro_torch.tune.tables import (_pow2_ge, conv_row_tile,
                                     fallback_block_k, fallback_tiles,
                                     overflow_cap)

__all__ = ["tune_gemm", "tune_conv", "tune_plan", "time_us"]

#: the block range the mma core stages (``kernels._mma``)
_BK_LO, _BK_HI = 32, 512


def time_us(fn: Callable[[], Any], iters: int = 3, warmup: int = 1,
            device: DeviceLike = "cuda") -> float:
    """Median microseconds of ``fn()``.  On the card: CUDA events around
    each call, synchronized before and after; on the CPU
    (``device="cpu"``): the host clock."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize(dev)
    ts = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize(dev)
            ts.append(start.elapsed_time(stop) * 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
    ts.sort()
    return ts[len(ts) // 2]


def _axis_neighbors(v: int, lo: int, hi: int) -> Iterable[int]:
    if v * 2 <= hi:
        yield v * 2
    if v // 2 >= lo:
        yield v // 2


def _hillclimb(start: Tuple[int, ...],
               neighbors: Callable[[Tuple[int, ...]],
                                   Iterable[Tuple[int, ...]]],
               evaluate: Callable[[Tuple[int, ...]], float],
               max_steps: int) -> Tuple[Tuple[int, ...], float, int]:
    """Greedy best-neighbour walk; returns (best config, best us, evals)."""
    seen: Dict[Tuple[int, ...], float] = {}

    def ev(cfg):
        if cfg not in seen:
            seen[cfg] = evaluate(cfg)
        return seen[cfg]

    best, best_us = start, ev(start)
    improved = True
    while improved and len(seen) < max_steps:
        improved = False
        for cand in neighbors(best):
            if len(seen) >= max_steps:
                break
            if cand in seen:
                continue
            us = ev(cand)
            if us < best_us:
                best, best_us, improved = cand, us, True
    return best, best_us, len(seen)


def _card_walk(route: Callable[[int], str], m: int, n: int, bk0: int,
               bk_free: bool, bk_hi: int):
    """(start, neighbours) of the card lattice: configs (bm, bn, bk) on
    the mma core, or the tile kernel's one config (neighbours: none)."""
    from repro_torch.kernels import _mma

    def fits(i, bk):
        return _mma._mma_smem(*_mma.MMA_TILES[i], bk) <= _mma._SMEM

    if route(bk0) != "mma":
        return (*_mma.tile_kernel_tile(None), bk0), lambda cfg: ()

    def neighbors(cfg):
        i, bk = _mma.MMA_TILES.index(cfg[:2]), cfg[2]
        for j in (i + 1, i - 1):
            if 0 <= j < len(_mma.MMA_TILES) and fits(j, bk):
                yield (*_mma.MMA_TILES[j], bk)
        if bk_free:
            for v in _axis_neighbors(bk, _BK_LO, bk_hi):
                if fits(i, v) and route(v) == "mma":
                    yield (*cfg[:2], v)

    return (*_mma.MMA_TILES[_mma.mma_tile(m, n, bk0)], bk0), neighbors


def _weights(w, dev: torch.device, quantize):
    """(float w, its prequant dict) on ``dev``: a given prequant dict is
    taken as it is (float w None); else ``quantize`` (falsy: no prequant
    route) makes the dict."""
    if isinstance(w, dict):
        if not quantize:
            raise ValueError("a prequant weight needs prequant=True")
        return None, {k: v.to(dev) for k, v in w.items()}
    w = w.to(dev)
    return w, (quantize(w) if quantize else None)


def _entry(best, us: float, steps: int) -> Dict[str, Any]:
    """A card entry: the (bm, bn, bk) config, its median us, evaluations."""
    return {**dict(zip(("bm", "bn", "bk"), best)), "us": round(us, 1),
            "steps": steps}


def tune_gemm(b: int, k: int, n: int, policy, *, cache: TuneCache,
              interpret: Optional[bool] = None, max_steps: int = 12,
              iters: int = 3, x: Optional[torch.Tensor] = None,
              w: Optional[torch.Tensor] = None, prequant: bool = False,
              device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Tune (bm, bn, bk) for one GEMM site; returns the cache entry.
    Already-cached sites return at once.  ``bk`` only moves when
    ``policy.block_k`` is None.  ``interpret`` is accepted and changes
    nothing: ``device`` picks the target."""
    from repro_torch.kernels import bfp_matmul as KM
    from repro_torch.kernels import ops  # late: ops imports tune

    dev = resolve_device(device)
    cpu = dev.type == "cpu"
    target = TuneCache.target(cpu)
    ent = cache.lookup("gemm", b, k, n, policy.l_i, policy.l_w,
                       policy.block_k, target)
    if ent is not None:
        return ent
    if prequant and not policy.block_k:
        raise ValueError("prequant=True needs a pinned policy.block_k (the "
                         "sidecar's block)")
    if x is None:
        x = torch.randn((b, k), generator=torch.Generator().manual_seed(0))
    if w is None:
        w = torch.randn((k, n),
                        generator=torch.Generator().manual_seed(1)) * 0.1
    x = x.to(dev)
    w, wq = _weights(w, dev, prequant and (lambda v: prequant_leaf(v, policy)))
    l_sum = policy.l_i + policy.l_w
    bk_free = not policy.block_k

    def call(cfg):
        if prequant:
            return ops.bfp_matmul_prequant(x, wq["m"], wq["s"], policy,
                                           tiles=cfg)
        return ops.bfp_matmul(x, w, policy, tiles=cfg)

    def evaluate(cfg):
        return time_us(lambda: call(cfg), iters=iters, device=dev)

    if cpu:
        start = fallback_tiles(b, k, n, policy.block_k, l_sum)
        bm_hi, bn_hi = max(8, _pow2_ge(b)), max(8, _pow2_ge(n))
        bk_hi = min(max(8, _pow2_ge(k)), overflow_cap(l_sum))

        def neighbors(cfg):
            bm, bn, bk = cfg
            for v in _axis_neighbors(bm, 8, bm_hi):
                yield (v, bn, bk)
            for v in _axis_neighbors(bn, 8, bn_hi):
                yield (bm, v, bk)
            if bk_free:
                for v in _axis_neighbors(bk, 8, bk_hi):
                    yield (bm, bn, v)
    else:
        start, neighbors = _card_walk(
            lambda bk: KM.matmul_core(prequant, bk, k, n, policy.l_i,
                                      policy.l_w),
            b, n, fallback_block_k(k, policy.block_k, l_sum), bk_free,
            min(_BK_HI, _pow2_ge(k), overflow_cap(l_sum)))
    best, us, steps = _hillclimb(start, neighbors, evaluate, max_steps)
    entry = _entry(best, us, steps)
    cache.store("gemm", b, k, n, policy.l_i, policy.l_w, policy.block_k,
                target, entry)
    return entry


def tune_conv(b: int, h: int, w_in: int, c: int, kh: int, oc: int,
              policy, *, stride: int = 1, padding: str = "SAME",
              cache: TuneCache, interpret: Optional[bool] = None,
              max_steps: int = 10, iters: int = 3,
              x: Optional[torch.Tensor] = None,
              w: Optional[torch.Tensor] = None, prequant: bool = False,
              device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Tune one conv site, keyed on its im2col GEMM view (B * OH * OW
    rows, kh * kh * C, OC).  On the card: the mma core's tile, the block
    fixed (``policy.block_k``, else whole-K) and stored as ``bk``; on the
    CPU ``repro``'s (t_oh, bn) with ``bk`` the policy's block."""
    from repro_torch.kernels import bfp_conv as KC
    from repro_torch.kernels import ops  # late: ops imports tune

    dev = resolve_device(device)
    cpu = dev.type == "cpu"
    target = TuneCache.target(cpu)
    kk = kh * kh * c
    oh, ow, _, _ = conv_geometry(h, w_in, kh, kh, stride, padding)
    rows = b * oh * ow
    ent = cache.lookup("conv", rows, kk, oc, policy.l_i, policy.l_w,
                       policy.block_k, target)
    if ent is not None:
        return ent
    if prequant and not policy.block_k:
        raise ValueError("prequant=True needs a pinned policy.block_k (the "
                         "sidecar's block)")
    if x is None:
        x = torch.randn((b, h, w_in, c),
                        generator=torch.Generator().manual_seed(0))
    if w is None:
        w = torch.randn((kh, kh, c, oc),
                        generator=torch.Generator().manual_seed(1)) * 0.1
    x = x.to(dev)
    w, wq = _weights(w, dev, prequant
                     and (lambda v: prequant_conv_leaf(v, policy)))
    bk = policy.block_k or kk

    def call(cfg):
        if prequant:
            return ops.bfp_conv2d_prequant(x, wq["m"], wq["s"], policy,
                                           stride, padding, tiles=cfg)
        return ops.bfp_conv2d(x, w, policy, stride, padding, tiles=cfg)

    def evaluate(cfg):
        return time_us(lambda: call(cfg), iters=iters, device=dev)

    if cpu:
        start = (conv_row_tile(oh, ow),
                 fallback_tiles(rows, kk, oc, None)[1])
        t_hi, bn_hi = max(1, _pow2_ge(oh)), max(8, _pow2_ge(oc))

        def neighbors(cfg):
            t_oh, bn = cfg
            for v in _axis_neighbors(t_oh, 1, t_hi):
                yield (v, bn)
            for v in _axis_neighbors(bn, 8, bn_hi):
                yield (t_oh, v)

        best, us, steps = _hillclimb(start, neighbors, evaluate, max_steps)
        entry = {"t_oh": best[0], "bn": best[1], "bk": policy.block_k,
                 "us": round(us, 1), "steps": steps}
    else:
        start, neighbors = _card_walk(
            lambda v: KC.conv_core(False, prequant, v, c, oc, policy.l_i,
                                   None, policy.l_w), rows, oc, bk, False,
            bk)
        best, us, steps = _hillclimb(start, neighbors, evaluate, max_steps)
        entry = _entry(best, us, steps)
    cache.store("conv", rows, kk, oc, policy.l_i, policy.l_w,
                policy.block_k, target, entry)
    return entry


def tune_plan(plan, apply_fn: Callable[..., Any], x: torch.Tensor, *,
              cache: TuneCache, max_steps: int = 6,
              iters: int = 3) -> Dict[str, Dict[str, Any]]:
    """Tune every kernel site of a bound plan at the shapes
    ``apply_fn(plan.params, x, plan)`` gives it (one tapped forward), each
    on the route it is served by (prequantized or not), with its real
    activations and weights; float and emulated sites are skipped.
    Returns {site path: entry}; the winners land in ``cache``."""
    from repro_torch import engine as EG

    evs = []
    with torch.no_grad(), EG.taps(evs.append):
        apply_fn(plan.params, x, plan)
    out: Dict[str, Dict[str, Any]] = {}
    for ev in evs:
        site = plan.sites.get(ev.path)
        if site is None or site.policy is None or ev.path in out or \
                site.backend.name not in ("cuda", "pallas"):
            continue
        kw = dict(cache=cache, max_steps=max_steps, iters=iters, x=ev.x,
                  w=ev.w, prequant=site.prequantized, device=plan.device)
        if ev.kind == "conv":
            wm = ev.w["m"] if isinstance(ev.w, dict) else ev.w
            kh, kw_, c, oc = wm.shape
            if kh != kw_:
                raise ValueError(f"site {ev.path}: tune_conv takes square "
                                 f"kernels, got {kh}x{kw_}")
            b, h, wd, _ = ev.x.shape
            out[ev.path] = tune_conv(b, h, wd, c, kh, oc, site.policy,
                                     stride=ev.stride, padding=ev.padding,
                                     **kw)
        else:
            x2d = ev.x.reshape(-1, ev.x.shape[-1])
            kw["x"] = x2d
            wm = ev.w["m"] if isinstance(ev.w, dict) else ev.w
            out[ev.path] = tune_gemm(x2d.shape[0], *wm.shape, site.policy,
                                     **kw)
    return out
