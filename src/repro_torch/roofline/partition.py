"""How a traced step splits over a mesh where DTensor's own rules would
split it otherwise than an SPMD partitioner does.

The model code is written for one device and carries only its logical
``shard`` annotations.  Run on ``DTensor``s, a few of its steps are ones
that DTensor either refuses or splits by replicating work that a
partitioner keeps split.  :func:`spmd` installs the partitioner's choice
for those steps, for the length of one traced (or sharded) call:

  * a reshape that splits a ``DTensor``'s last dim into heads, where the
    mesh dims splitting it do not divide the head count, first gathers it
    over them (DTensor does not split such a dim); in a GEMM's backward,
    flattening the leading dims (``reshape(-1, n)``) of a ``DTensor`` of
    3 or more dims whose local shard is strided first makes the shard
    contiguous (DTensor reshapes by viewing its shard, which a strided
    one refuses);
  * a linear layer (``models.lm.common.linear``, wherever a module binds
    it) on two ``DTensor``s first reduces a pending sum in x (``Partial``:
    what a row-parallel GEMM leaves in the residual stream) and gathers
    x's contracted dim over a mesh dim that splits the weight's output
    dim, as Megatron's column-parallel linear does; left to itself
    DTensor may gather the weight instead and replicate the GEMM over
    that mesh dim;
  * the attention cores (``models.lm.common``'s ``_sdpa``,
    ``_flash_sdpa`` and ``_swa_chunked``) run once per shard
    (``local_map``), split by rows and heads, where DTensor would flatten
    the split head dim into the batched GEMMs' batch dim, which some torch
    versions refuse.

The hooks are process-wide while :func:`spmd` is entered (module
attributes and a ``TorchFunctionMode``); plain tensors pass through them
unchanged.  The autograd engine runs a backward without the caller's
function modes, so ``grad.vjp._Gemm``'s backward, which reshapes its
grads, enters the contiguous-shard rule itself (it holds no autograd
graph, where the forward's reshapes do).
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, List

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["spmd", "attention_local", "gemm_input"]

#: ``models.lm.common``'s attention cores: q [B, S, H, Dh], k and v
#: [B, T, Hk, Dh] and the rest of their arguments -> [B, S, H, Dh].
_ATTENTION = ("_sdpa", "_flash_sdpa", "_swa_chunked")


def _split_over(x, dim: int) -> List[int]:
    """The mesh dims over which DTensor ``x`` splits tensor dim ``dim``."""
    from torch.distributed.tensor import Shard

    dim %= x.ndim
    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim % x.ndim == dim]


def _split_count(x, dim: int) -> int:
    n = 1
    for i in _split_over(x, dim):
        n *= x.device_mesh.size(i)
    return n


def gemm_input(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x`` as a partitioner feeds it to ``x @ w`` where both are
    ``DTensor``s (see the module docstring; a prequantized ``w`` is read
    by its mantissas); anything else as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    w = w["m"] if isinstance(w, dict) else w
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x
    pl = list(x.placements)
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        if isinstance(px, Partial) or (
                isinstance(px, Shard) and px.dim % x.ndim == x.ndim - 1
                and isinstance(pw, Shard) and pw.dim % w.ndim == w.ndim - 1):
            pl[i] = Replicate()
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def attention_local(fn, q, k, v, *rest: Any):
    """``fn(q, k, v, *rest)`` for an attention core; on ``DTensor``s once
    per shard.  Rows split as q's batch dim is or as the bound ``"batch"``
    rule says (a pending sum there is reduced and scattered), heads as
    q's head dim is, every other mesh dim is gathered; ``rest`` (a config,
    a plain mask) passes as it is.  Where the KV heads do not split like
    the query heads, k and v stay whole over the head split and each shard
    takes the KV heads of its own query heads, by its mesh coordinate;
    a shard whose query heads straddle KV groups unevenly is refused."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist.sharding import current_rules

    if not isinstance(q, DTensor):
        return fn(q, k, v, *rest)
    mesh = q.device_mesh
    ctx = current_rules()
    ax = ctx[0].get("batch") if ctx else None
    batch_axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
    h, hk = q.shape[2], k.shape[2]
    pl: List[Any] = []
    head_dims: List[int] = []
    rows = heads = 1
    for i, p in enumerate(q.placements):
        d = p.dim % q.ndim if type(p) is Shard else None
        n = mesh.size(i)
        if d == 2 and h % (heads * n) == 0:
            heads *= n
            head_dims.append(i)
            pl.append(Shard(2))
        elif (d == 0 or mesh.mesh_dim_names[i] in batch_axes) and \
                q.shape[0] % (rows * n) == 0:
            rows *= n                   # the batch rule's mesh dims too
            pl.append(Shard(0))
        else:
            pl.append(Replicate())
    g, h_l = h // hk, h // heads
    select = hk % heads != 0
    if select and g % h_l and h_l % g:
        raise NotImplementedError(
            f"attention over {heads} head shards: {h_l} query heads a "
            f"shard straddle groups of {g} (H={h}, Hk={hk})")
    pl_kv = [Replicate() if select and i in head_dims else p
             for i, p in enumerate(pl)]
    grad_kv = [Partial() if select and i in head_dims else p
               for i, p in enumerate(pl)]

    def local(q_, k_, v_, *r):
        if select:                      # this shard's KV heads
            coord, c = mesh.get_coordinate(), 0
            for i in head_dims:
                c = c * mesh.size(i) + coord[i]
            lo = c * h_l // g
            k_ = k_[:, :, lo:lo + max(1, h_l // g)]
            v_ = v_[:, :, lo:lo + max(1, h_l // g)]
        return fn(q_, k_, v_, *r)

    pl, pl_kv, grad_kv = tuple(pl), tuple(pl_kv), tuple(grad_kv)
    return local_map(local, out_placements=(pl,),
                     in_placements=(pl, pl_kv, pl_kv) + (None,) * len(rest),
                     in_grad_placements=(pl, grad_kv, grad_kv)
                     + (None,) * len(rest),
                     device_mesh=mesh, redistribute_inputs=True)(
                         q, k, v, *rest)


class _Reshapes(TorchFunctionMode):
    """A rule of the module docstring for the reshapes of ``DTensor``s:
    the head split (``contiguous=False``) or, inside a backward, the
    contiguous shard (``contiguous=True``)."""

    def __init__(self, contiguous: bool):
        super().__init__()
        from torch.distributed.tensor import DTensor, Replicate

        self.dtensor, self.replicate = DTensor, Replicate
        self.funcs = {torch.Tensor.reshape, torch.reshape}
        self.rule = self._contiguous if contiguous else self._heads

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.funcs and isinstance(args[0], self.dtensor):
            rest = args[1:]
            shape = tuple(rest[0]) if len(rest) == 1 and isinstance(
                rest[0], (tuple, list)) else tuple(rest)
            args = (self.rule(args[0], shape),) + tuple(rest)
        return func(*args, **kwargs)

    def _heads(self, x, shape):
        if (len(shape) == x.ndim + 1
                and tuple(shape[:-2]) == tuple(x.shape[:-1])
                and shape[-2] * shape[-1] == x.shape[-1] != shape[-1]
                and shape[-2] % _split_count(x, -1)):
            pl = list(x.placements)
            for i in _split_over(x, -1):
                pl[i] = self.replicate()
            x = x.redistribute(x.device_mesh, pl)
        return x

    def _contiguous(self, x, shape):
        if len(shape) != 2 or shape[0] != -1 or x.ndim < 3 or \
                x._local_tensor.is_contiguous():
            return x
        return self.dtensor.from_local(
            x._local_tensor.contiguous(), x.device_mesh, x.placements,
            shape=x.shape, stride=x.stride())


@contextlib.contextmanager
def _patched(obj, name: str, value) -> Iterator[None]:
    old = vars(obj)[name]
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _per_shard(fn):
    def core(q, k, v, *rest):
        return attention_local(fn, q, k, v, *rest)
    return core


@contextlib.contextmanager
def spmd() -> Iterator[None]:
    """Install the partitioner's rules (module docstring) for the call
    run inside."""
    from repro_torch.grad import vjp
    from repro_torch.models.lm import common, griffin, model, moe, rwkv6

    linear, backward = common.linear, vjp._Gemm.backward

    def split_linear(p, x, *args, **kwargs):
        return linear(p, gemm_input(x, p["w"]), *args, **kwargs)

    def split_backward(ctx, *grads):
        with _Reshapes(contiguous=True):
            return backward(ctx, *grads)

    with contextlib.ExitStack() as stack:
        for mod in (common, griffin, model, moe, rwkv6):
            if vars(mod).get("linear") is linear:
                stack.enter_context(_patched(mod, "linear", split_linear))
        for name in _ATTENTION:
            stack.enter_context(
                _patched(common, name, _per_shard(getattr(common, name))))
        stack.enter_context(
            _patched(vjp._Gemm, "backward", staticmethod(split_backward)))
        stack.enter_context(_Reshapes(contiguous=False))
        yield
