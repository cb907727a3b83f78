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
    ``_flash_sdpa`` and ``_swa_chunked``) and RWKV6's chunked WKV
    (``models.lm.rwkv6._wkv_chunked``) run once per shard
    (``local_map``), split by rows and heads, where DTensor would flatten
    the split head dim into the batched GEMMs' batch dim, which some torch
    versions refuse;
  * a head split or a head flatten whose head count a mesh dim does not
    divide brings its gradient back to its forward split before the
    backward views it (a row-parallel GEMM's backward splits the flat
    dim where the heads cannot follow);
  * the MoE dispatch (``models.lm.moe``) stays global over the tokens,
    as on one device: its index arithmetic (``_route``: sort, positions,
    capacity, slots) runs on every device over the routing tensors
    gathered whole, and only the token gather, the expert GEMMs and the
    combine (``_experts``) are split, over experts, the experts' hidden
    dim and capacity rows.  A per-shard dispatch would give each shard
    its own capacity and drop other tokens.

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
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = ["spmd", "attention_local", "gemm_input", "wkv_local",
           "moe_route", "moe_experts"]

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


def _rows_heads(x):
    """(placements, head mesh dims, row mesh dims) of a per-shard core
    over ``x`` [B, S, H, ...]: rows split as x's batch dim is or as the
    bound ``"batch"`` rule says, heads as x's head dim is, each where it
    divides; every other mesh dim replicated."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.sharding import current_rules

    mesh = x.device_mesh
    ctx = current_rules()
    ax = ctx[0].get("batch") if ctx else None
    batch_axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
    pl: List[Any] = []
    head_dims: List[int] = []
    row_dims: List[int] = []
    rows = heads = 1
    for i, p in enumerate(x.placements):
        d = p.dim % x.ndim if type(p) is Shard else None
        n = mesh.size(i)
        if d == 2 and x.shape[2] % (heads * n) == 0:
            heads *= n
            head_dims.append(i)
            pl.append(Shard(2))
        elif (d == 0 or mesh.mesh_dim_names[i] in batch_axes) and \
                x.shape[0] % (rows * n) == 0:
            rows *= n                   # the batch rule's mesh dims too
            row_dims.append(i)
            pl.append(Shard(0))
        else:
            pl.append(Replicate())
    return pl, head_dims, row_dims


def wkv_local(fn, r, k, v, w, u):
    """``fn(r, k, v, w, u)`` for RWKV6's chunked WKV
    (``models.lm.rwkv6._wkv_chunked``: r, k, v, w [B, S, H, D], u
    [H, D]); on ``DTensor``s once per shard, split by rows and heads as
    :func:`attention_local` splits them (each (row, head) runs its own
    recurrence; DTensor's einsum strategies would flatten a split dim,
    which some torch versions refuse)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(r, DTensor):
        return fn(r, k, v, w, u)
    pl, head_dims, row_dims = _rows_heads(r)
    pl_u = tuple(Shard(0) if i in head_dims else Replicate()
                 for i in range(len(pl)))
    grad_u = tuple(Partial() if i in row_dims else p
                   for i, p in enumerate(pl_u))
    pl = tuple(pl)
    return local_map(fn, out_placements=(pl,),
                     in_placements=(pl,) * 4 + (pl_u,),
                     in_grad_placements=(pl,) * 4 + (grad_u,),
                     device_mesh=r.device_mesh, redistribute_inputs=True)(
                         r, k, v, w, u)


def attention_local(fn, q, k, v, *rest: Any):
    """``fn(q, k, v, *rest)`` for an attention core; on ``DTensor``s once
    per shard.  Rows split as q's batch dim is or as the bound ``"batch"``
    rule says (a pending sum there is reduced and scattered), heads as
    q's head dim is, every other mesh dim is gathered; ``rest`` (a config,
    a plain mask) passes as it is.  Where the KV heads do not split like
    the query heads, k and v stay whole over the head split and each shard
    takes the KV heads of its own query heads, by its mesh coordinate;
    a shard whose query heads straddle KV groups unevenly is refused."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(q, DTensor):
        return fn(q, k, v, *rest)
    mesh = q.device_mesh
    h, hk = q.shape[2], k.shape[2]
    pl, head_dims, _ = _rows_heads(q)
    heads = 1
    for i in head_dims:
        heads *= mesh.size(i)
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


def moe_route(fn, expert_ids, gate_vals, e: int, cap: int):
    """``fn(expert_ids, gate_vals, e, cap)`` for ``models.lm.moe._route``;
    on ``DTensor``s on every device over the routing tensors gathered
    whole ([T, K]: small beside the activations), so every device holds
    the same global dispatch (one capacity over all T tokens, as on one
    device) and its outputs replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(expert_ids, DTensor):
        return fn(expert_ids, gate_vals, e, cap)
    mesh = expert_ids.device_mesh
    rep = (Replicate(),) * mesh.ndim
    return local_map(lambda a, b: fn(a, b, e, cap),
                     out_placements=(rep,) * 5, in_placements=(rep, rep),
                     device_mesh=mesh, redistribute_inputs=True)(
                         expert_ids, gate_vals)


def _mesh_dims(mesh, ax) -> List[int]:
    axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
    return [list(mesh.mesh_dim_names).index(a) for a in axes]


def _linear_index(mesh, dims: List[int]):
    """(count, this device's index) over mesh dims ``dims``, major to
    minor."""
    coord = mesh.get_coordinate()
    n, i = 1, 0
    for d in dims:
        i = i * mesh.size(d) + coord[d]
        n *= mesh.size(d)
    return n, i


def moe_experts(fn, p, x, route, e: int, cap: int, policy):
    """``fn(p, x, route, e, cap, policy)`` for ``models.lm.moe._experts``;
    on ``DTensor``s once per shard.  The [E, C, D] expert buffer splits
    its experts over the mesh dims of the bound ``"experts"`` rule, the
    experts' hidden dim over those of ``"ffn"`` (where each divides its
    dim, as ``shard`` resolves them) and its capacity rows over every
    other mesh dim (unevenly, as ``torch.chunk`` splits; the expert
    GEMMs are replicated over no mesh dim).  Each device gathers its own
    slots' tokens from x gathered whole, runs its experts on them, and
    scatter-adds its contributions into a [T, D] partial sum, reduced to
    x's split (a token's k contributions are summed across devices, not
    in the one device's sorted order: the values agree to rounding)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.dist.sharding import (current_rules, mesh_axis_sizes,
                                           resolve_spec)
    from repro_torch.models.lm import moe as M

    if not isinstance(x, DTensor):
        return fn(p, x, route, e, cap, policy)
    mesh = x.device_mesh
    n = mesh.ndim
    ctx = current_rules()
    e_ax, f_ax = resolve_spec(ctx[0] if ctx else {}, mesh_axis_sizes(mesh),
                              (e, p["w1"].shape[-1]), ("experts", "ffn"))
    e_dims = _mesh_dims(mesh, e_ax)
    f_dims = [i for i in _mesh_dims(mesh, f_ax) if i not in e_dims]
    c_dims = [i for i in range(n) if i not in e_dims + f_dims]
    n_e, i_e = _linear_index(mesh, e_dims)
    n_c, i_c = _linear_index(mesh, c_dims)
    e0, e1 = i_e * e // n_e, (i_e + 1) * e // n_e
    chunk = -(-cap // n_c)
    c0, c1 = min(i_c * chunk, cap), min((i_c + 1) * chunk, cap)
    rep, partial = [Replicate()] * n, [Partial()] * n

    def local_w(name, f_dim):           # float expert weights [E, ., .]
        pl = [Shard(0) if i in e_dims else Shard(f_dim) if i in f_dims
              else Replicate() for i in range(n)]
        grad = [Partial() if i in c_dims else q for i, q in enumerate(pl)]
        return p[name].redistribute(mesh, pl).to_local(grad_placements=grad)

    w1_l, w3_l, w2_l = local_w("w1", 2), local_w("w3", 2), local_w("w2", 1)
    x_l = x.redistribute(mesh, rep).to_local(grad_placements=partial)
    b, s, d = x_l.shape
    x_l = x_l.reshape(b * s, d)
    sorted_tok, sorted_gate, keep, slot, _ = (
        r.redistribute(mesh, rep).to_local(
            grad_placements=partial if r.is_floating_point() else None)
        for r in route)
    t, k = b * s, sorted_tok.shape[0] // (b * s)

    # this device's slots: the (token, k) item of each, -1 where empty
    slot_item = torch.full((e * cap + 1,), -1, dtype=slot.dtype,
                           device=slot.device)
    slot_item[slot] = torch.arange(t * k, device=slot.device)
    items = slot_item[:-1].reshape(e, cap)[e0:e1, c0:c1]      # [E_l, C_l]
    valid = items >= 0
    item = torch.clamp(items, min=0)
    tok = sorted_tok[item]
    zero = torch.zeros((), dtype=x_l.dtype, device=x_l.device)
    xe = torch.where(valid[..., None], F.embedding(tok, x_l), zero)
    h = F.silu(M._expert_gemm(xe, w1_l, policy)) * \
        M._expert_gemm(xe, w3_l, policy)
    ye = M._expert_gemm(h, w2_l, policy)                      # [E_l, C_l, D]
    gate = torch.where(valid, sorted_gate[item],
                       torch.zeros((), dtype=sorted_gate.dtype,
                                   device=x_l.device))
    contrib = (ye * gate[..., None]).to(x_l.dtype)
    out = torch.zeros_like(x_l).index_add(
        0, tok.reshape(-1), contrib.reshape(-1, d)).reshape(b, s, d)
    out = DTensor.from_local(out, mesh, partial, run_check=False)
    return out.redistribute(mesh, x.placements)


class _Reshapes(TorchFunctionMode):
    """A rule of the module docstring for the reshapes of ``DTensor``s:
    the head split (``contiguous=False``) or, inside a backward, the
    contiguous shard (``contiguous=True``)."""

    def __init__(self, contiguous: bool):
        super().__init__()
        from torch.distributed.tensor import DTensor, Replicate

        self.dtensor, self.replicate = DTensor, Replicate
        self.funcs = {torch.Tensor.reshape, torch.reshape}
        self.contiguous = contiguous
        self.rule = self._contiguous if contiguous else self._heads

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.funcs and isinstance(args[0], self.dtensor):
            rest = args[1:]
            shape = tuple(rest[0]) if len(rest) == 1 and isinstance(
                rest[0], (tuple, list)) else tuple(rest)
            x = self.rule(args[0], shape)
            try:
                y = func(x, *rest, **kwargs)
            except Exception:
                merged = self._merged_split(x, shape)
                if not merged:
                    raise
                pl = list(x.placements)
                for i in merged:
                    pl[i] = self.replicate()
                x = x.redistribute(x.device_mesh, pl)
                y = func(x, *rest, **kwargs)
            return y if self.contiguous else self._grad_rule(x, shape, y)
        return func(*args, **kwargs)

    @staticmethod
    def _merged_split(x, shape) -> List[int]:
        """The mesh dims splitting an inner one of the leading dims that
        ``x.reshape(shape)`` merges into one (a DTensor without strided
        shards refuses that merge; it is gathered first)."""
        k = x.ndim - len(shape) + 1
        if not (2 <= k <= x.ndim - 1
                and tuple(shape[1:]) == tuple(x.shape[k:])):
            return []
        return [i for d in range(1, k) for i in _split_over(x, d)]

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

    def _grad_rule(self, x, shape, y):
        """``y = x.reshape(shape)`` that splits x's last dim into heads or
        flattens x's heads and head width, where a mesh dim does not
        divide the head count: the gradient comes back to ``y``'s own
        split on the reshaped dims before the backward views it.  A GEMM's
        backward may split those dims over a mesh dim that the heads
        cannot follow: DTensor refuses to unflatten such a split, or
        makes it a strided shard whose gather reads index values, which
        a traced (fake) tensor does not have."""
        if not y.requires_grad:
            return y
        if len(shape) == x.ndim + 1 and tuple(y.shape[:-2]) == \
                tuple(x.shape[:-1]):
            heads, dims = y.shape[-2], (y.ndim - 2, y.ndim - 1)
        elif len(shape) == x.ndim - 1 >= 1 and tuple(y.shape) == (
                *x.shape[:-2], x.shape[-2] * x.shape[-1]):
            heads, dims = x.shape[-2], (y.ndim - 1,)
        else:
            return y
        if not any(heads % n for n in y.device_mesh.shape):
            return y
        want = [self.replicate() if p.is_partial() else p
                for p in y.placements]

        def as_forward(g):
            pl = [w if p != w and getattr(p, "dim", None) in dims else p
                  for p, w in zip(g.placements, want)]
            if pl == list(g.placements):
                return g
            return g.redistribute(g.device_mesh, pl)

        y.register_hook(as_forward)
        return y

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
        wkv = rwkv6._wkv_chunked
        stack.enter_context(_patched(
            rwkv6, "_wkv_chunked", lambda *a: wkv_local(wkv, *a)))
        route, experts = moe._route, moe._experts
        stack.enter_context(_patched(
            moe, "_route", lambda *a: moe_route(route, *a)))
        stack.enter_context(_patched(
            moe, "_experts", lambda *a: moe_experts(experts, *a)))
        stack.enter_context(
            _patched(vjp._Gemm, "backward", staticmethod(split_backward)))
        stack.enter_context(_Reshapes(contiguous=False))
        yield
