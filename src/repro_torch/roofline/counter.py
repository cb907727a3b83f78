"""Per-device cost of one traced step: the port's stand-in for a compiled
program's ``cost_analysis()``, ``as_text()`` and ``memory_analysis()``.

:func:`trace` runs a callable once on fake tensors (``FakeTensorMode``:
shapes and dtypes only, no device memory, no device work), its inputs
placed as ``DTensor``s of a mesh, and counts what ONE device does:

  * ``flops``: the flop formulas of ``torch.utils.flop_counter`` (the
    ones ``FlopCounterMode`` applies) over the LOCAL ops, the per-shard
    ``aten`` calls that DTensor issues.  DTensor's sharding propagation
    also runs ops, at global shapes, on fake tensors of its own mode; a
    counter over DTensors (``FlopCounterMode`` around the call) counts
    those and overcounts by up to the mesh size.  Here an op counts only
    when its tensors are fake tensors of the trace's own mode;
  * ``bytes accessed``: the bytes of every local op's tensor inputs and
    outputs.  An eager trace has no fusion, so this is an UNFUSED upper
    bound: a compiler that fuses elementwise chains reads and writes less.
    Metadata queries and views (every output on an input's storage) move
    nothing and count nothing;
  * the collectives: each functional collective's name and result bytes
    (``roofline.analysis.collective_bytes`` sums them per kind);
  * the matmul-family calls (``mm``, ``addmm``, ``bmm``, ``baddbmm``;
    ``einsum`` reaches them as ``bmm``) with their operand shapes, for
    ``roofline.hlo_flops``;
  * memory: ``argument_bytes`` and ``output_bytes``, the local shards'
    bytes of the inputs and outputs, and ``temp_bytes``, the peak of the
    live fake storages the call made (an EAGER peak: every intermediate
    lives until Python drops it, with no buffer reuse planned ahead).

Between DTensor calls the fake mode is taken off the mode stack, so that
DTensor's own bookkeeping tensors stay real; the ops those calls issue
on fake shards still reach the counter.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Dot", "Trace", "CostCounter", "trace", "fake_like",
           "local_bytes", "DTYPE_NAMES"]

#: torch dtype -> the short names of the dot signatures (``bf16[..]``).
DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.float8_e4m3fn: "f8e4m3",
    torch.float8_e5m2: "f8e5m2",
}


def _ops(*names: str) -> set:
    """The ``aten`` / ``prim`` overloads of ``names`` that this torch has."""
    out = set()
    for n in names:
        ns, op, ov = n.split(".")
        pk = getattr(getattr(torch.ops, ns), op, None)
        if pk is not None and hasattr(pk, ov):
            out.add(getattr(pk, ov))
    return out


#: Ops that read metadata only; ``FlopCounterMode`` passes them on too.
_METADATA = _ops(
    "aten.sym_is_contiguous.default", "aten.is_contiguous.default",
    "aten.is_contiguous.memory_format",
    "aten.is_strides_like_format.default",
    "aten.is_non_overlapping_and_dense.default", "aten.size.default",
    "aten.sym_size.default", "aten.stride.default",
    "aten.sym_stride.default", "aten.storage_offset.default",
    "aten.sym_storage_offset.default", "aten.numel.default",
    "aten.sym_numel.default", "aten.dim.default", "prim.layout.default")
_DOTS = ("mm", "addmm", "bmm", "baddbmm")


@dataclasses.dataclass(frozen=True)
class Dot:
    """One local matmul-family call."""
    op: str
    lhs: Tuple[str, Tuple[int, ...]]     # (dtype name, shape)
    rhs: Tuple[str, Tuple[int, ...]]
    out: Tuple[int, ...]
    flops: int


@dataclasses.dataclass
class Trace:
    """What one device did in a traced call (see the module docstring)."""
    flops: int = 0
    bytes_accessed: int = 0
    dots: List[Dot] = dataclasses.field(default_factory=list)
    collectives: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0

    def cost(self) -> Dict[str, float]:
        """``cost_analysis()``'s keys that the roofline reads."""
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes_accessed)}

    def memory(self) -> Dict[str, int]:
        """``memory_analysis()``'s three sizes, per device."""
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` on one device (a DTensor's local
    shard)."""
    return sum(_nbytes(t.to_local() if _is_dtensor(t) else t)
               for t in _tensors(tree))


def _moves_nothing(func, ins, outs) -> bool:
    """A metadata query (no tensor out) or a view: every output shares an
    input's storage (``view``, ``_unsafe_view``, ``detach``, a collective's
    ``wait_tensor``).  An in-place op writes its input and counts."""
    if any(r.alias_info is not None and r.alias_info.is_write
           for r in func._schema.returns):
        return False
    if not outs:
        return True
    held = {id(t.untyped_storage()) for t in ins}
    return all(id(t.untyped_storage()) in held for t in outs)


class CostCounter:
    """Accumulates one :class:`Trace` from the ops of ``fake_mode``'s
    tensors (see the module docstring); its dispatch mode is entered
    above the fake mode."""

    def __init__(self, fake_mode):
        from torch.utils.flop_counter import flop_registry

        self.fake_mode = fake_mode
        self.result = Trace()
        self._registry = flop_registry
        self._live: Dict[int, int] = {}
        self._live_bytes = 0
        self._outer = _Mode(self, outer=True)
        self._inner = _Mode(self, outer=False)

    def adopt(self, tree) -> None:
        """Mark the storages of ``tree`` (the inputs) as existing before
        the call: they are not the call's temporaries."""
        for t in _tensors(tree):
            t = t.to_local() if _is_dtensor(t) else t
            self._live.setdefault(id(t.untyped_storage()), 0)

    def _ours(self, ts: Sequence[torch.Tensor]) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor

        fakes = [t for t in ts if isinstance(t, FakeTensor)]
        return bool(fakes) and all(t.fake_mode is self.fake_mode
                                   for t in fakes)

    def _free(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self._live_bytes -= nbytes

    def _track(self, outs: Sequence[torch.Tensor]) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self._live_bytes += n
            weakref.finalize(st, self._free, key, n)
        self.result.temp_bytes = max(self.result.temp_bytes,
                                     self._live_bytes)

    def record(self, func, args, kwargs, out) -> None:
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not self._ours(ins + outs):
            return
        r = self.result
        name = str(func)
        packet = func._overloadpacket
        if packet in self._registry:
            fl = int(self._registry[packet](*args, **kwargs, out_val=out))
            r.flops += fl
            short = packet.__name__
            if short in _DOTS:
                a, b = (args[1], args[2]) if short in ("addmm", "baddbmm") \
                    else (args[0], args[1])
                r.dots.append(Dot(short, (DTYPE_NAMES.get(a.dtype, str(a.dtype)),
                                          tuple(a.shape)),
                                  (DTYPE_NAMES.get(b.dtype, str(b.dtype)),
                                   tuple(b.shape)),
                                  tuple(outs[0].shape), fl))
        if "c10d" in name and "wait_tensor" not in name:
            r.collectives.append((name, sum(_nbytes(t) for t in outs)))
        if not _moves_nothing(func, ins, outs):
            r.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
            self._track(outs)


class _Mode(TorchDispatchMode):
    """The counter's dispatch mode.  The outer one sits above the fake
    mode; on a DTensor call it takes every mode off the stack and enters
    the inner one, which lets DTensor dispatch (returns NotImplemented)
    and counts the local ops that follow."""

    def __init__(self, counter: CostCounter, outer: bool):
        super().__init__()
        self.counter = counter
        self.outer = outer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils._python_dispatch import _disable_current_modes

        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        if any(_is_dtensor(t) for t in _tensors((args, kwargs))):
            if not self.outer:
                return NotImplemented
            with _disable_current_modes(), self.counter._inner:
                return func(*args, **kwargs)
        if (isinstance(func, torch._ops.OpOverload)
                and func._overloadpacket not in self.counter._registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.counter.record(func, args, kwargs, out)
        return out


def fake_like(t: torch.Tensor, fake_mode, device) -> torch.Tensor:
    """A fake tensor of ``t``'s shape and dtype on ``device``; a 0-d
    integer tensor becomes the constant 0 (a decode position, a step
    count), which the traced code may read with ``int()``."""
    with fake_mode:
        if t.ndim == 0 and not t.dtype.is_floating_point:
            return torch.tensor(0, dtype=t.dtype, device=device)
        return torch.empty(t.shape, dtype=t.dtype, device=device)


def trace(fn: Callable, args: Sequence[Any], fake_mode,
          mesh=None, rules: Optional[Dict] = None) -> Trace:
    """Run ``fn(*args)`` once under ``fake_mode`` and count it.

    ``args`` hold fake tensors of ``fake_mode`` (DTensors of ``mesh``
    where placed); plain tensors mix with DTensors as replicated ones.
    ``rules`` (with ``mesh``) bind ``dist.sharding.axis_rules`` around
    the call, so the model's ``shard`` annotations redistribute.
    """
    from repro_torch.dist.sharding import axis_rules

    counter = CostCounter(fake_mode)
    counter.adopt(args)
    r = counter.result
    r.argument_bytes = local_bytes(args)
    stack = contextlib.ExitStack()
    with stack:
        if mesh is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            stack.enter_context(implicit_replication())
            if rules is not None:
                stack.enter_context(axis_rules(rules, mesh))
        with fake_mode, counter._outer:
            out = fn(*args)
    r.output_bytes = local_bytes(out)
    return r
