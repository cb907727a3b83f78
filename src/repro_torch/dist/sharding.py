"""Logical-axis sharding annotations on a torch ``DeviceMesh``
(counterpart of ``repro.dist.sharding``).

Model code names the MEANING of each tensor dimension; the launcher names
the HARDWARE.  :func:`axis_rules` installs a (rules, mesh) binding for
the current thread; inside it, :func:`shard` lowers logical names to
DTensor placements on the bound mesh.  Outside any binding ``shard`` is
the identity (the very same tensor object), so the production model code
runs unchanged on one device.

Rules values may be a physical axis name (``"model"``), a tuple of axis
names (``("pod", "data")``: one tensor dim sharded over both mesh dims,
major to minor, as in JAX's ``P(("pod", "data"))``), or ``None``
(replicate).  A rule whose axis size does not divide the dimension is
dropped to ``None`` with a :class:`ShardingRuleDropped` warning, once per
(name, axis, size, dim), with ``repro``'s message.

Eager PyTorch has no SPMD partitioner: ``shard`` redistributes a
``DTensor`` of the bound mesh, and hands a plain tensor back unchanged
(after resolving its spec, so drops warn as in ``repro``); the caller
places plain data explicitly, as ``serve.cnn.CnnServeEngine`` does with
its batch.  Such a split forward sees only its own rows, so a block that
spans the batch (EQ2's and EQ4's whole-matrix activation block) takes its
max over the data group: the engine enters :func:`batch_group` around
that forward and ``core.bfp_dot`` reduces through :func:`group_amax`.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

__all__ = ["DEFAULT_RULES", "axis_rules", "shard", "current_rules",
           "resolve_spec", "mesh_axis_sizes", "ShardingRuleDropped",
           "placements", "batch_group", "group_amax", "any_rank"]

Axis = Union[None, str, Tuple[str, ...]]

#: Logical -> physical defaults for the production meshes
#: (launch.mesh: axes ("data", "model") or ("pod", "data", "model")).
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": "data",        # pure data parallelism
    "seq": None,            # full sequences per shard
    "seq_res": None,        # residual-stream seq axis (Megatron SP opt-in)
    "embed": None,          # d_model stays replicated (activations)
    "heads": "model",       # tensor parallel attention
    "kv_heads": "model",
    "ffn": "model",         # tensor parallel MLP hidden
    "vocab": "model",       # sharded logits / lm_head
    "experts": "model",     # expert parallelism (MoE)
}

_STATE = threading.local()


class ShardingRuleDropped(UserWarning):
    """A logical-axis rule was dropped because the mesh axis size does not
    divide the tensor dimension — the dim replicates instead of sharding.
    Benign in reduced smoke configs; in production it means a tensor you
    meant to shard is fully replicated."""


#: (logical name, physical axis, axis size, dim) drops already warned
#: about — once per rule geometry, not per call.
_DROP_WARNED: set = set()


def current_rules() -> Optional[Tuple[Dict[str, Axis], Any]]:
    """The active (rules, mesh) binding, or None outside axis_rules."""
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def axis_rules(rules: Dict[str, Axis], mesh):
    """Bind logical axis names to physical mesh axes for this thread; the
    previous binding comes back on exit."""
    prev = current_rules()
    _STATE.ctx = (dict(rules), mesh)
    try:
        yield
    finally:
        _STATE.ctx = prev


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (what divisibility is checked
    against)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: Dict[str, int], ax: Axis) -> int:
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(ax, 1)


def resolve_spec(rules: Dict[str, Axis], sizes: Dict[str, int],
                 shape: Tuple[int, ...],
                 logical_axes: Tuple[Optional[str], ...]) -> Tuple[Axis, ...]:
    """Lower logical axis names to a physical spec: one entry per dim,
    ``None``, an axis name or a tuple of names (``PartitionSpec``'s
    content).

    Unknown names and ``None`` replicate silently.  A known rule whose
    axis size does not divide the dimension is dropped to replicated with
    a once-per-rule :class:`ShardingRuleDropped` warning.
    """
    phys = []
    for dim, name in zip(shape, logical_axes):
        ax = rules.get(name) if isinstance(name, str) else None
        if ax is not None:
            n = _axis_size(sizes, ax)
            if dim % n != 0:
                phys_ax = ax if isinstance(ax, str) else tuple(ax)
                key = (name, phys_ax, n, dim)
                if key not in _DROP_WARNED:
                    _DROP_WARNED.add(key)
                    warnings.warn(
                        f"sharding rule {name!r} -> {phys_ax!r} dropped: "
                        f"mesh axis size {n} does not divide dim {dim}; "
                        f"the dimension replicates instead",
                        ShardingRuleDropped, stacklevel=3)
                ax = None
        phys.append(tuple(ax) if isinstance(ax, list) else ax)
    return tuple(phys)


def placements(mesh, phys: Sequence[Axis]) -> List[Any]:
    """DTensor placements of a resolved spec: ``Shard(d)`` on each mesh dim
    that tensor dim ``d`` maps to, ``Replicate()`` elsewhere.  A tuple
    axis must name its mesh dims in mesh order (major to minor), the only
    order DTensor's placements express."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate() for _ in names]
    for d, ax in enumerate(phys):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"axis {ax!r} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"tensor dims in {tuple(phys)}")
            out[i] = Shard(d)
    return out


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Annotate ``x`` with one logical axis name (or None) per dimension.

    The identity (``x`` itself) outside an :func:`axis_rules` binding and
    where ``x.ndim`` differs from the number of names.  Inside a binding a
    ``DTensor`` of the bound mesh is redistributed to the resolved
    placements; a plain tensor comes back unchanged once its spec is
    resolved (drops warn), since eager torch has no partitioner to hand
    the constraint to.
    """
    ctx = current_rules()
    if ctx is None:
        return x
    rules, mesh = ctx
    if x.ndim != len(logical_axes):  # defensive: never fail model code
        return x
    phys = resolve_spec(rules, mesh_axis_sizes(mesh), tuple(x.shape),
                        logical_axes)
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    if x.device_mesh != mesh:
        raise ValueError(f"shard: a DTensor on {x.device_mesh}, the bound "
                         f"mesh is {mesh}")
    return x.redistribute(mesh, placements(mesh, phys))


@contextlib.contextmanager
def batch_group(groups: Sequence[Any]):
    """Inside a forward that holds only its rank's rows of the batch: the
    process groups of the mesh dims the batch is split over.  Blocks
    that span the batch take their max over them (:func:`group_amax`)."""
    prev = getattr(_STATE, "groups", ())
    _STATE.groups = tuple(groups)
    try:
        yield
    finally:
        _STATE.groups = prev


def group_amax(amax: torch.Tensor) -> torch.Tensor:
    """``amax`` (a block's max |x| over this rank's rows) maxed over the
    ranks of the current :func:`batch_group`: the block max of the whole
    batch.  The identity outside one and on groups of one rank.  Each
    group's maxima are gathered and maxed with ``torch.amax``, so a NaN
    on any rank propagates as it does in the unsplit block."""
    groups = getattr(_STATE, "groups", ())
    if not groups:
        return amax
    import torch.distributed as dist

    for g in groups:
        n = dist.get_world_size(g)
        if n == 1:
            continue
        parts = [torch.empty_like(amax) for _ in range(n)]
        dist.all_gather(parts, amax.contiguous(), group=g)
        amax = torch.amax(torch.stack(parts), dim=0)
    return amax


def any_rank(flag: bool, groups: Sequence[Any],
             device: torch.device) -> bool:
    """Whether ``flag`` holds on any rank of ``groups`` (a MAX all-reduce
    per group of more than one rank): how the ranks of a split forward
    agree that one of them failed before any of them waits in a gather."""
    import torch.distributed as dist

    t = torch.tensor([int(flag)], device=device)
    for g in groups:
        if dist.get_world_size(g) > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
    return bool(t.item())
