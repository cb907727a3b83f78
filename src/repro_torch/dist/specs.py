"""Sharding specs for parameters and decode caches (counterpart of
``repro.dist.specs``).

Megatron-style tensor parallelism over the ``"model"`` axis plus FSDP
over the data axes:

  * column-parallel linears (wq/wk/wv, w1/w3, gates, lm_head): output dim
    on "model", input dim FSDP-sharded over ("pod", "data");
  * row-parallel linears (wo, w2, out): input dim on "model";
  * embedding: vocab dim on "model";
  * BFP prequant leaves (``{"m", "s"}``): the int8 mantissa follows its
    owner's layout; the small scale sidecar shards only its output dim
    (column-parallel owners) and otherwise replicates.

A spec is a tuple with one entry per dim: ``None``, an axis name or a
tuple of names (``PartitionSpec``'s content, without JAX).  Every
assignment is divisibility-guarded: a dim the axis does not divide
replicates.  Only the leaves' ``ndim`` and ``shape`` are read, so meta
tensors of the published shapes serve and no full-width parameter is
made for a spec.
"""
from __future__ import annotations

from typing import Any, Tuple

from repro_torch import _tree
from repro_torch.dist.sharding import _axis_size, mesh_axis_sizes

__all__ = ["param_specs", "cache_specs"]

#: Immediate-owner names whose GEMM contracts over the "model"-sharded dim
#: (row parallel); everything else 2-D+ is treated column parallel.
_ROW_PARALLEL = ("wo", "w2", "out")


def _axes(mesh):
    names = tuple(mesh.mesh_dim_names)
    data: Any = tuple(a for a in ("pod", "data") if a in names)
    if len(data) == 1:
        data = data[0]
    elif not data:
        data = None
    model = "model" if "model" in names else None
    return data, model


def _fit(mesh, dim: int, ax):
    return (ax if ax is not None
            and dim % _axis_size(mesh_axis_sizes(mesh), ax) == 0 else None)


def _path_keys(path) -> Tuple[str, ...]:
    return tuple(str(k) for k in path)


def param_specs(cfg, params: Any, mesh) -> Any:
    """Spec tree matching ``params`` (tensors, meta tensors or anything
    with ``ndim`` and ``shape``); ``None`` subtrees stay ``None``."""
    data, model = _axes(mesh)

    def one(path, leaf):
        nd = getattr(leaf, "ndim", 0)
        if nd < 2:
            return ()
        keys = _path_keys(path)
        name = keys[-1]
        parent = keys[-2] if len(keys) > 1 else ""
        holder = parent if name in ("w", "b", "m", "s") else name
        shape = leaf.shape
        spec = [None] * nd

        if "embed" in keys:  # [vocab, d_model]
            spec[-2] = _fit(mesh, shape[-2], model)
            return tuple(spec)

        row = holder in _ROW_PARALLEL
        if name == "s":
            # scale sidecar [.., K//bk, N]: shard only the output dim of
            # column-parallel owners
            if not row:
                spec[-1] = _fit(mesh, shape[-1], model)
            return tuple(spec)
        if row:
            spec[-2] = _fit(mesh, shape[-2], model)
            spec[-1] = _fit(mesh, shape[-1], data)      # FSDP
        else:
            spec[-1] = _fit(mesh, shape[-1], model)
            spec[-2] = _fit(mesh, shape[-2], data)      # FSDP
        return tuple(spec)

    return _tree.map_with_path(one, params)


def cache_specs(cfg, cache: Any, mesh) -> Any:
    """Spec tree for decode caches (``models.lm.model.init_cache``
    layout): KV buffers [L, B, T, Hk, Dh] shard batch over the data axes
    and KV heads over "model"; recurrent states [L, B, ...] shard batch
    only; ``enc_out`` [B, S, D] shards its leading batch dim; a ``None``
    leaf (``enc_out`` before prefill) gets ``()``."""
    data, model = _axes(mesh)

    def one(path, leaf):
        nd = getattr(leaf, "ndim", 0)
        if leaf is None or nd == 0:
            return ()
        keys = _path_keys(path)
        shape = leaf.shape
        spec = [None] * nd
        batch_dim = 0 if (keys and keys[-1] == "enc_out") else min(1, nd - 1)
        spec[batch_dim] = _fit(mesh, shape[batch_dim], data)
        if nd == 5:  # [L, B, T, Hk, Dh]
            spec[3] = _fit(mesh, shape[3], model)
        return tuple(spec)

    return _tree.map_with_path(one, cache, is_leaf=lambda x: x is None)
