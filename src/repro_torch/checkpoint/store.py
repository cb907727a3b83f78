"""Checkpointing: atomic, resumable, async-capable (counterpart of
``repro.checkpoint.store``).

Layout:  <dir>/step_<N>/
           manifest.json       tree structure + shapes/dtypes + status
           arrays.npz          flat leaves (logical, unsharded)

  * atomic: written to step_<N>.tmp, fsynced, renamed — a crash never
    leaves a half checkpoint that :func:`restore` would pick up;
  * the manifest carries a payload checksum, so torn writes are detected
    and the previous step is used instead;
  * async: :meth:`Checkpointer.save_async` snapshots to host memory
    synchronously and writes in a background thread.

The artifacts are ``repro``'s: leaf ``i`` of ``arrays.npz`` is the same
leaf in both packages (``repro_torch._tree`` walks trees in
``jax.tree_util`` order: dict keys sorted, ``None`` no leaf, Python ints
and bools 0-d arrays), the same tree gives a byte-identical
``arrays.npz``, and the manifest equals ``repro``'s field for field but
``treedef``, a description of the tree that neither restore reads.  So a
checkpoint either package writes restores in the other.

Packed BFP checkpoints: ``save(..., format="bfp_packed", policy=...)``
stores every prequant-eligible GEMM/conv weight leaf as a bit-packed
:class:`~repro_torch.core.packed.PackedBFP` container (the prequant
walk a bound plan uses; biases, BN terms and odd-K leaves stay float32),
about 4x smaller at 8-bit mantissas.  ``format="bfp_packed_v2"`` writes
variable-width (v3) containers.  ``restore`` rebuilds packed leaves per
its ``packed=`` mode: ``"prequant"`` (default: the ``{"m", "s"}``
sidecars a serving engine binds, no float weight ever materialized),
``"dequant"`` (a plain float tree) or ``"keep"`` (the raw containers —
``engine.bind`` unpacks them).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
import zlib
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch import _tree
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.packed import (IntegrityError, PackedBFP, is_packed,
                                     pack_param_tree, unpack_dequant,
                                     unpack_prequant)

__all__ = ["save", "save_async", "restore", "latest_step", "Checkpointer",
           "CheckpointCorruptionWarning"]


class CheckpointCorruptionWarning(UserWarning):
    """A present-but-invalid step (torn write, corrupted bytes, failed
    checksum) was skipped; restore fell back to an older valid step."""


def _host(leaf: Any) -> Any:
    """A leaf as it is stored: containers as they are, tensors and
    Python scalars as numpy arrays."""
    if is_packed(leaf):
        return leaf
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def save(base: str, step: int, tree, keep: int = 3, *,
         format: str = "float32", policy: Any = None,
         tree_kind: str = "auto") -> str:
    """Synchronous atomic save.  Returns the final directory.

    ``format="float32"`` (default) stores every leaf as-is.
    ``format="bfp_packed"`` additionally needs ``policy`` (BFPPolicy or
    ``engine.PolicyMap``): GEMM/conv weight leaves the prequant walk
    selects are stored as serialized :class:`PackedBFP` containers
    (uint8 rows in the same ``arrays.npz``), everything else as float.
    ``format="bfp_packed_v2"`` is the same walk writing variable-width
    (v3) containers.  ``tree_kind`` ("cnn" | "lm" | "auto") picks the path
    convention, as in ``engine.bind``.  A tree that already contains
    PackedBFP leaves is stored packed under any format (no policy
    needed).
    """
    if format not in ("float32", "bfp_packed", "bfp_packed_v2"):
        raise ValueError(f"unknown checkpoint format {format!r}")
    packing = format in ("bfp_packed", "bfp_packed_v2")
    if packing and policy is not None:
        tree = pack_param_tree(tree, policy, tree_kind,
                               variable=(format == "bfp_packed_v2"))
    raw, _ = _tree.flatten(tree, is_leaf=is_packed)
    leaves = [_host(leaf) for leaf in raw]
    packed_idx = [i for i, l in enumerate(leaves) if is_packed(l)]
    if packing and not packed_idx:
        # the caller asked for a packed artifact; writing a full-size
        # float32 checkpoint would hide a typo'd PolicyMap
        raise ValueError(
            f"format={format!r} packed zero leaves — pass policy= (a "
            f"BFPPolicy or PolicyMap whose rules resolve for at least one "
            f"GEMM/conv weight), or check tree_kind" if policy is None else
            f"format={format!r} packed zero leaves: the policy resolved "
            f"no prequant-eligible GEMM/conv weight (typo'd PolicyMap "
            f"rules, or wrong tree_kind?)")
    os.makedirs(base, exist_ok=True)
    final = _step_dir(base, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    payload = {f"leaf_{i}": (np.frombuffer(leaf.to_bytes(), np.uint8)
                             if is_packed(leaf) else leaf)
               for i, leaf in enumerate(leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **payload)
    with open(os.path.join(tmp, "arrays.npz"), "rb") as f:
        crc = zlib.crc32(f.read())
    manifest = {
        "step": step,
        "treedef": _tree.describe(tree, is_leaf=is_packed),
        "n_leaves": len(leaves),
        # packed leaves report their ORIGINAL tensor geometry, so shape
        # validation at restore is format-agnostic
        "shapes": [list(l.shape) for l in leaves],
        # variable-width leaves carry a "v" suffix
        "dtypes": [(f"bfp_packed{l.bits}{'v' if l.variable else ''}"
                    if is_packed(l) else str(l.dtype)) for l in leaves],
        "format": (("bfp_packed_v2" if any(leaves[i].variable
                                           for i in packed_idx)
                    else "bfp_packed") if packed_idx else "float32"),
        "packed_leaves": packed_idx,
        "crc32": crc,
        "status": "complete",
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(base, keep)
    return final


def _gc(base: str, keep: int):
    steps = sorted(_list_steps(base))
    for s in steps[:-keep]:
        shutil.rmtree(_step_dir(base, s), ignore_errors=True)


def _list_steps(base: str) -> List[int]:
    if not os.path.isdir(base):
        return []
    out = []
    for name in os.listdir(base):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return out


def _valid(base: str, step: int) -> bool:
    d = _step_dir(base, step)
    mpath = os.path.join(d, "manifest.json")
    apath = os.path.join(d, "arrays.npz")
    if not (os.path.exists(mpath) and os.path.exists(apath)):
        return False
    try:
        with open(mpath) as f:
            m = json.load(f)
        if m.get("status") != "complete":
            return False
        with open(apath, "rb") as f:
            return zlib.crc32(f.read()) == m["crc32"]
    except Exception:
        return False


def latest_step(base: str) -> Optional[int]:
    """Most recent VALID step (checksum-verified).

    A step directory that exists but fails validation (missing files,
    incomplete status, payload-CRC mismatch) is skipped with a
    :class:`CheckpointCorruptionWarning` and the next older step is
    tried: corruption costs one checkpoint interval, never a crash.
    """
    for s in sorted(_list_steps(base), reverse=True):
        if _valid(base, s):
            return s
        warnings.warn(
            f"checkpoint step {s} at {_step_dir(base, s)} is corrupt or "
            f"incomplete — skipping it and falling back to the next "
            f"valid step", CheckpointCorruptionWarning, stacklevel=2)
    return None


def _shape(ref: Any):
    return tuple(ref.shape) if hasattr(ref, "shape") else np.shape(ref)


def _as_template(arr: np.ndarray, ref: Any, dev: torch.device) -> Any:
    """A stored plain leaf in the kind of its template leaf: a Python
    scalar (ResNet's ``meta``, GoogLeNet's ``fc1_in``) stays one,
    anything else becomes a tensor on ``dev``."""
    if isinstance(ref, (bool, int, float)):
        return type(ref)(arr.item())
    return torch.from_numpy(np.array(arr)).to(dev)


def restore(base: str, tree_like, step: Optional[int] = None,
            sharding_fn: Optional[Callable[[Any], Any]] = None,
            packed: str = "prequant", device: DeviceLike = "cuda"):
    """Restore into the structure of ``tree_like`` (any tree of the same
    leaves: tensors, meta-device tensors, arrays, Python scalars).

    Returns ``(tree, step)``, or ``(None, None)`` when no valid
    checkpoint exists.  Plain leaves come back as tensors on ``device``
    (Python scalars of the template as Python scalars); a packed weight
    leaf comes back per ``packed``:

      * ``"prequant"`` (default): the ``{"m", "s"}`` sidecar dict on
        ``device`` — the serving load path; no float weight is ever
        materialized for these leaves;
      * ``"dequant"``: dense float32 (``m * s``) on ``device``;
      * ``"keep"``: the raw :class:`PackedBFP` containers (host bytes;
        ``engine.bind`` unpacks them onto the plan's device).

    ``sharding_fn(i)`` (elastic re-sharding) places the tensor of leaf
    ``i`` (in flatten order): it returns a ``torch.device`` (or a string
    naming one), and the leaf moves there, or a ``(DeviceMesh,
    placements)`` pair, and the leaf becomes ``distribute_tensor(leaf,
    mesh, placements)`` (every rank read the same bytes, so each takes
    its own shard with no collective).  As in ``repro`` this places the
    plain leaves and the ``"dequant"`` weights; ``"prequant"`` and
    ``"keep"`` leaves, and Python scalars, are left as they are.
    """
    if packed not in ("prequant", "dequant", "keep"):
        raise ValueError(f"packed must be 'prequant', 'dequant', or "
                         f"'keep'; got {packed!r}")
    dev = resolve_device(device)
    if step is None:
        step = latest_step(base)
        if step is None:
            return None, None
    elif not _valid(base, step):
        # an explicitly requested step must not silently restore corrupt
        # bytes
        raise IntegrityError(
            f"checkpoint step {step} at {_step_dir(base, step)} is "
            f"corrupt, incomplete, or missing (payload checksum / "
            f"manifest validation failed)")
    d = _step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    packed_idx = set(manifest.get("packed_leaves", []))
    leaves_ref, treedef = _tree.flatten(tree_like)
    if manifest.get("n_leaves", len(leaves_ref)) != len(leaves_ref):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, model tree has "
            f"{len(leaves_ref)} — architecture mismatch")
    with np.load(os.path.join(d, "arrays.npz")) as data:
        leaves: List[Any] = [data[f"leaf_{i}"]
                             for i in range(len(leaves_ref))]
    for i in packed_idx:
        leaves[i] = PackedBFP.from_bytes(leaves[i].tobytes())
    for i, (new, ref) in enumerate(zip(leaves, leaves_ref)):
        if tuple(new.shape) != tuple(_shape(ref)):
            raise ValueError(
                f"checkpoint leaf {i} shape {tuple(new.shape)} != model "
                f"{tuple(_shape(ref))} — architecture mismatch")
    out: List[Any] = []
    for i, (leaf, ref) in enumerate(zip(leaves, leaves_ref)):
        if is_packed(leaf) and packed != "dequant":
            out.append(leaf if packed == "keep"
                       else unpack_prequant(leaf, dev))
            continue
        t = (unpack_dequant(leaf, dev) if is_packed(leaf)
             else _as_template(leaf, ref, dev))
        if sharding_fn is not None and isinstance(t, torch.Tensor):
            t = _place(t, sharding_fn(i))
        out.append(t)
    return _tree.unflatten(treedef, out), step


def _place(t: torch.Tensor, target: Any) -> torch.Tensor:
    """``t`` on a device, or distributed over a ``(mesh, placements)``
    pair (see :func:`restore`)."""
    if isinstance(target, (str, torch.device)):
        return t.to(target)
    mesh, placements = target
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements, src_data_rank=None)


class Checkpointer:
    """Async checkpointer: snapshot to host memory synchronously, write
    in the background.  ``format``/``policy``/``tree_kind`` are forwarded
    to :func:`save`, so packed checkpoints ride the async path too."""

    def __init__(self, base: str, keep: int = 3, *,
                 format: str = "float32", policy: Any = None,
                 tree_kind: str = "auto"):
        self.base = base
        self.keep = keep
        self.format = format
        self.policy = policy
        self.tree_kind = tree_kind
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save_async(self, step: int, tree):
        self.wait()
        # snapshot now: tensors are copied to host memory (a packing save
        # quantizes the copies), containers are already host bytes

        def snap(_, leaf):
            if isinstance(leaf, torch.Tensor):
                return leaf.detach().to("cpu", copy=True)
            return leaf

        host_tree = _tree.map_with_path(snap, tree, is_leaf=is_packed)

        def _run():
            try:
                save(self.base, step, host_tree, self.keep,
                     format=self.format, policy=self.policy,
                     tree_kind=self.tree_kind)
            except Exception as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()


def save_async(base: str, step: int, tree, keep: int = 3, *,
               format: str = "float32", policy: Any = None,
               tree_kind: str = "auto") -> Checkpointer:
    ck = Checkpointer(base, keep, format=format, policy=policy,
                      tree_kind=tree_kind)
    ck.save_async(step, tree)
    return ck
