"""Persistent autotune cache — tuned tile configs keyed by (shape, L,
target) (counterpart of ``repro.tune.cache``).

The file format, the schema number and the key strings are ``repro``'s,
so a cache written by either package loads in the other with equal
entries:

    {"schema": 1,
     "entries": {"<key>": {"bm": 64, "bn": 128, "bk": 512,
                           "us": 812.5, "steps": 9}}}

    <kind>:b<B>k<K>n<N>:L<L_I>.<L_W>:bk<block_k|0>:<target>

``kind`` is "gemm" or "conv" (a conv keys on its im2col GEMM view: B =
batch * OH * OW rows, K = kh * kw * C, N = OC); B/K/N are the unpadded
shape; ``bk0`` means the policy names no block, so the tuned ``bk`` IS
the block.  ``target`` names what the timings and the tile rule depend
on, and an entry is only ever used on its own target:

* ``"interpret"`` — the CPU, where the port runs the kernels' plain
  versions (``repro``'s Pallas interpret mode).  Its entries are
  ``repro``'s: (bm, bn, bk) for a GEMM, (t_oh, bn) plus the block for a
  conv.  The plain versions take no row or column tile, so only a free
  block's ``bk`` changes anything, and it changes the bits exactly as it
  does in ``repro``;
* :data:`CARD_TARGET` (``"cuda:sm_90:132sm"``) — the H100 kernels, built
  for sm_90a, whose tile rule (``kernels._mma.mma_tile``) assumes 132
  SMs.  A GEMM or conv entry carries (bm, bn, bk): (bm, bn) one of the
  mma core's ``MMA_TILES``, or the tile kernel's fixed tile for a site
  that runs there.  The core tiles patch rows, so a conv has no
  ``t_oh``.  A TPU or interpret entry is never used on the card.

Runtime plumbing: ``kernels.ops`` consults the process-wide active cache
(:func:`set_cache` / :func:`use_cache`) at every call; ``engine.bind(...,
tune_cache=)`` installs a cache on a Plan, which activates it around
every bound execution.  ``hits`` / ``misses`` count the lookups.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import warnings
from typing import Any, Dict, Optional, Tuple

__all__ = ["TuneCache", "set_cache", "get_cache", "use_cache",
           "lookup_tiles", "SCHEMA", "CARD_TARGET", "INTERPRET"]

SCHEMA = 1

#: the target of the CPU's plain versions (``repro``'s interpret mode)
INTERPRET = "interpret"
#: the target of the card's kernels: compute capability 9.0 and the SM
#: count the mma core's tile rule assumes (``kernels._mma._SMS``)
CARD_TARGET = "cuda:sm_90:132sm"


class TuneCache:
    """A dict of tuned tile entries with JSON persistence (thread-safe
    stores; lookups are plain dict reads)."""

    def __init__(self, path: Optional[str] = None,
                 entries: Optional[Dict[str, Dict[str, Any]]] = None):
        self.path = path
        self.entries: Dict[str, Dict[str, Any]] = dict(entries or {})
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()

    # -- persistence ----------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "TuneCache":
        """Load from ``path``; a missing file is an empty cache.  A corrupt
        or unreadable file is an empty cache too, warned once per path
        (the cache is a performance artifact: a truncated write must not
        take serving down); entries of another schema are dropped."""
        if not os.path.exists(path):
            return cls(path=path)
        try:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or \
                    not isinstance(doc.get("entries", {}), dict):
                raise ValueError(f"unexpected document shape: "
                                 f"{type(doc).__name__}")
        except (OSError, ValueError) as e:   # json errors are ValueError
            cls._warn_corrupt(path, e)
            return cls(path=path)
        if doc.get("schema") != SCHEMA:
            return cls(path=path)
        return cls(path=path, entries=doc.get("entries", {}))

    _warned_paths: set = set()

    @classmethod
    def _warn_corrupt(cls, path: str, err: Exception) -> None:
        key = os.path.abspath(path)
        if key in cls._warned_paths:
            return
        cls._warned_paths.add(key)
        warnings.warn(f"tune cache {path} is corrupt or unreadable "
                      f"({err}); treating as empty — delete or re-save "
                      f"to silence", UserWarning, stacklevel=3)

    def save(self, path: Optional[str] = None) -> str:
        """Write atomically (a temporary file, then a rename), entries
        sorted by key, as ``repro`` does."""
        path = path or self.path
        if path is None:
            raise ValueError("TuneCache has no path to save to")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"schema": SCHEMA,
                       "entries": dict(sorted(self.entries.items()))},
                      f, indent=1, sort_keys=False)
            f.write("\n")
        os.replace(tmp, path)
        self.path = path
        return path

    # -- keying ---------------------------------------------------------
    @staticmethod
    def key(kind: str, b: int, k: int, n: int, l_i: int, l_w: int,
            block_k: Optional[int], target: str) -> str:
        return (f"{kind}:b{b}k{k}n{n}:L{l_i}.{l_w}:"
                f"bk{block_k or 0}:{target}")

    @staticmethod
    def target(interpret: bool) -> str:
        """:data:`INTERPRET` for the CPU's plain versions, else
        :data:`CARD_TARGET`."""
        return INTERPRET if interpret else CARD_TARGET

    # -- access ---------------------------------------------------------
    def lookup(self, kind: str, b: int, k: int, n: int, l_i: int,
               l_w: int, block_k: Optional[int],
               target: str) -> Optional[Dict[str, Any]]:
        ent = self.entries.get(
            self.key(kind, b, k, n, l_i, l_w, block_k, target))
        if ent is None:
            self.misses += 1
        else:
            self.hits += 1
        return ent

    def store(self, kind: str, b: int, k: int, n: int, l_i: int,
              l_w: int, block_k: Optional[int], target: str,
              entry: Dict[str, Any]) -> None:
        with self._lock:
            self.entries[self.key(kind, b, k, n, l_i, l_w, block_k,
                                  target)] = dict(entry)

    def __len__(self) -> int:
        return len(self.entries)

    def __repr__(self) -> str:
        return (f"TuneCache({len(self.entries)} entries, "
                f"hits={self.hits}, misses={self.misses}, "
                f"path={self.path!r})")


# -- process-wide active cache ------------------------------------------
_ACTIVE: Optional[TuneCache] = None


def set_cache(cache: Optional[TuneCache]) -> Optional[TuneCache]:
    """Install ``cache`` as the process-wide active cache (None clears);
    returns the previous one."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, cache
    return prev


def get_cache() -> Optional[TuneCache]:
    return _ACTIVE


@contextlib.contextmanager
def use_cache(cache: Optional[TuneCache]):
    """Scoped :func:`set_cache` — how Plans activate their bound cache
    around each execution."""
    prev = set_cache(cache)
    try:
        yield cache
    finally:
        set_cache(prev)


def lookup_tiles(kind: str, b: int, k: int, n: int, l_i: int, l_w: int,
                 block_k: Optional[int],
                 interpret: bool) -> Optional[Tuple[int, ...]]:
    """Consult the active cache for a tuned tile config: (bm, bn, bk) for
    a GEMM, and for a conv ``repro``'s (t_oh, bn) on :data:`INTERPRET`,
    (bm, bn, bk) on :data:`CARD_TARGET`; None when no cache is active or
    it has no entry (the caller then takes the fallback rule)."""
    cache = _ACTIVE
    if cache is None:
        return None
    ent = cache.lookup(kind, b, k, n, l_i, l_w, block_k,
                       TuneCache.target(interpret))
    if ent is None:
        return None
    if kind == "conv" and interpret:
        return (ent["t_oh"], ent["bn"])
    return (ent["bm"], ent["bn"], ent["bk"])
