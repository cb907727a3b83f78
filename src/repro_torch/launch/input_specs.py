"""Per-(arch x shape) input stand-ins and step functions for the dry run
(counterpart of ``repro.launch.input_specs``).

``build_cell`` returns everything needed to trace one cell WITHOUT any
device allocation: meta-tensor trees for all inputs (where ``repro`` has
``ShapeDtypeStruct``s), the matching spec trees (``dist.specs`` tuples,
``PartitionSpec``'s content), the step callable, and the axis rules.
Parameters come from ``models.lm.model.init_params`` traced under
``FakeTensorMode`` (``bfp_weights`` through
``core.prequant.quantize_param_tree``, whose quantizer is plain torch),
then turned into meta tensors.  Modality frontends are stubs, as in
``repro``: [audio] gets precomputed frame embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import _tree
from repro_torch.configs.base import LMConfig, ShapeConfig
from repro_torch.dist import specs as SP
from repro_torch.dist.sharding import DEFAULT_RULES, mesh_axis_sizes
from repro_torch.models.lm import model as Mdl
from repro_torch.optim import optimizers as opt
from repro_torch.train.step import TrainState, make_train_step

__all__ = ["build_cell", "cell_rules", "input_specs", "Cell",
           "with_layer_units", "layer_units", "pad_heads_for_tp",
           "materialize"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _to_meta(tree):
    return _tree.tree_map(
        lambda t: _meta(t.shape, t.dtype) if isinstance(t, torch.Tensor)
        else t, tree)


def cell_rules(cfg: LMConfig, shape: ShapeConfig, mesh) -> Dict:
    """Logical->physical rules for this cell (DESIGN.md §5)."""
    rules = dict(DEFAULT_RULES)
    sizes = mesh_axis_sizes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = 1
    for a in batch_axes:
        dp *= sizes[a]
    if shape.global_batch % dp != 0:        # e.g. long_500k batch=1
        rules["batch"] = None
    else:
        rules["batch"] = batch_axes if len(batch_axes) > 1 else \
            (batch_axes[0] if batch_axes else None)
    if shape.kind in ("train", "prefill"):
        rules["seq_res"] = "model"          # Megatron-style sequence parallel
    model_size = sizes.get("model", 1)
    if cfg.is_moe:
        if cfg.n_experts % model_size == 0:
            rules["ffn"] = None             # EP (olmoe): no TP inside experts
        else:
            rules["experts"] = None         # mixtral: TP inside experts
    if cfg.n_kv_heads % model_size != 0:
        rules["kv_heads"] = None            # MQA/GQA kv < devices: replicate
    if cfg.n_heads % model_size != 0:
        rules["heads"] = None
    if cfg.d_ff % model_size != 0:
        rules["ffn"] = None
    return rules


def input_specs(cfg: LMConfig, shape: ShapeConfig,
                mesh=None) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if shape.kind == "train":
        out["tokens"] = _meta((b, s), torch.int32)
        out["targets"] = _meta((b, s), torch.int32)
    elif shape.kind == "prefill":
        out["tokens"] = _meta((b, s), torch.int32)
    else:  # decode: one new token against a cache of seq_len
        out["tokens"] = _meta((b, 1), torch.int32)
        out["pos"] = _meta((), torch.int32)
    if cfg.is_encdec and shape.kind != "decode":
        out["enc_feats"] = _meta((b, cfg.enc_seq_stub, cfg.d_model),
                                 torch.bfloat16)
    return out


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    fn: Callable                    # positional (state-like..., inputs...)
    args: Tuple[Any, ...]           # meta-tensor trees (positional)
    in_specs: Tuple[Any, ...]       # matching spec trees
    out_specs: Any
    donate: Tuple[int, ...]
    rules: Dict


def with_layer_units(cfg: LMConfig, units: int) -> LMConfig:
    """Scale the repeated layer stack to ``units`` layer-units, keeping all
    non-repeated structure (embed, head, hybrid remainder) intact.

    Used by the roofline tier (launch.dryrun --mode roofline): trace at
    units=1 and units=2, then extrapolate exactly:
    F(L) = F(1) + (L-1) * (F(2) - F(1)) since every unit is identical.
    A layer-unit is one pattern period (hybrid), one (enc+dec) layer pair
    (enc-dec), or one layer (all other families).
    """
    if cfg.block_pattern:
        rem = cfg.n_layers % len(cfg.block_pattern)
        return dataclasses.replace(
            cfg, n_layers=units * len(cfg.block_pattern) + rem)
    if cfg.is_encdec:
        return dataclasses.replace(cfg, n_layers=units,
                                   encoder_layers=units)
    return dataclasses.replace(cfg, n_layers=units)


def layer_units(cfg: LMConfig) -> int:
    """Number of layer-units the full config has (see with_layer_units)."""
    if cfg.block_pattern:
        return cfg.n_layers // len(cfg.block_pattern)
    return cfg.n_layers


def pad_heads_for_tp(cfg: LMConfig, model_size: int) -> LMConfig:
    """Pad attention heads up to a multiple of the TP degree (standard
    Megatron practice): e.g. minicpm 36 heads -> 48 on a 16-way model
    axis.  Zero-padded heads are mathematically inert; here (cost
    analysis) they appear as +33% attention width in exchange for 16x
    sharding instead of full replication."""
    def up(n):
        return -(-n // model_size) * model_size
    h = up(cfg.n_heads)
    hk = up(cfg.n_kv_heads) if cfg.n_kv_heads == cfg.n_heads \
        else cfg.n_kv_heads
    return dataclasses.replace(cfg, n_heads=h, n_kv_heads=hk)


def _is_spec(x) -> bool:
    """A spec leaf: a plain tuple of None, axis names and tuples of
    names (a NamedTuple or a tuple of specs is a subtree)."""
    return (isinstance(x, tuple) and not hasattr(type(x), "_fields")
            and all(a is None or isinstance(a, str)
                    or (isinstance(a, tuple)
                        and all(isinstance(b, str) for b in a))
                    for a in x))


def _strip_fsdp(spec_tree):
    """Inference param layout: TP ('model') only, replicated over the data
    axes — kills per-step FSDP weight all-gathers at serving time."""
    def fix(sp):
        return tuple(None if ax in ("data", "pod") else
                     (tuple(a for a in ax if a not in ("data", "pod"))
                      or None if isinstance(ax, tuple) else ax)
                     for ax in sp)
    return _tree.map_with_path(lambda _, sp: fix(sp), spec_tree,
                               is_leaf=_is_spec)


def _fake_params(cfg: LMConfig, bfp_weights):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        p = Mdl.init_params(cfg, torch.Generator(), device="cpu")
        if bfp_weights is not None:
            from repro_torch.core.prequant import quantize_param_tree
            p = quantize_param_tree(p, bfp_weights)
        return _to_meta(p)


def build_cell(cfg: LMConfig, shape: ShapeConfig, mesh,
               analysis_unroll: bool = True,
               bfp_weights=None,            # BFPPolicy -> int8 wire format
               inference_no_fsdp: bool = False,
               pad_heads: bool = False) -> Cell:
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16",
                              analysis_unroll=analysis_unroll)
    if pad_heads:
        cfg = pad_heads_for_tp(cfg, mesh_axis_sizes(mesh).get("model", 1))
    rules = cell_rules(cfg, shape, mesh)
    batch_axes = rules["batch"]
    ins = input_specs(cfg, shape, mesh)

    params_sds = _fake_params(cfg, bfp_weights)
    pspecs = SP.param_specs(cfg, params_sds, mesh)
    if inference_no_fsdp:
        pspecs = _strip_fsdp(pspecs)

    if shape.kind == "train":
        state_sds = TrainState(params=params_sds,
                               opt_state=opt.adamw_init(params_sds),
                               step=_meta((), torch.int32))
        sspecs = TrainState(params=pspecs,
                            opt_state=opt.OptState(step=(), mu=pspecs,
                                                   nu=pspecs),
                            step=())
        step_fn = make_train_step(cfg, opt.constant_schedule(1e-4))

        def fn(state, tokens, targets):
            new_state, metrics = step_fn(state, (tokens, targets))
            return new_state, metrics["loss"]

        bspec = (batch_axes, None)
        return Cell(cfg.name, shape, fn,
                    (state_sds, ins["tokens"], ins["targets"]),
                    (sspecs, bspec, bspec),
                    (sspecs, ()), donate=(0,), rules=rules)

    if shape.kind == "prefill":
        if cfg.is_encdec:
            def fn(params, tokens, enc_feats):
                logits, _ = Mdl.forward(params, cfg, tokens,
                                        enc_feats=enc_feats)
                return logits[:, -1]
            espec = (batch_axes, None, None)
            return Cell(cfg.name, shape, fn,
                        (params_sds, ins["tokens"], ins["enc_feats"]),
                        (pspecs, (batch_axes, None), espec),
                        (batch_axes, None), donate=(), rules=rules)

        def fn(params, tokens):
            logits, _ = Mdl.forward(params, cfg, tokens)
            return logits[:, -1]
        return Cell(cfg.name, shape, fn, (params_sds, ins["tokens"]),
                    (pspecs, (batch_axes, None)),
                    (batch_axes, None), donate=(), rules=rules)

    # decode: serve_step with a cache of seq_len tokens
    cache_sds = Mdl.init_cache(cfg, shape.global_batch, shape.seq_len,
                               device="meta")
    if cfg.is_encdec:
        cache_sds = dict(cache_sds, enc_out=_meta(
            (shape.global_batch, cfg.enc_seq_stub, cfg.d_model),
            torch.bfloat16))
    cspecs = SP.cache_specs(cfg, cache_sds, mesh)
    if rules["batch"] is None:  # long_500k: strip batch sharding from cache
        cspecs = _tree.map_with_path(
            lambda _, sp: tuple(None if ax in ("pod", "data",
                                               ("pod", "data"), ("data",))
                                else ax for ax in sp),
            cspecs, is_leaf=_is_spec)

    def fn(params, cache, tokens, pos):
        logits, new_cache = Mdl.decode_step(params, cfg, cache, tokens, pos)
        return logits, new_cache

    return Cell(cfg.name, shape, fn,
                (params_sds, cache_sds, ins["tokens"], ins["pos"]),
                (pspecs, cspecs, (batch_axes, None), ()),
                ((batch_axes, None, None), cspecs),
                donate=(1,), rules=rules)


def materialize(cell: Cell, vocab_size: int, gen: torch.Generator,
                device) -> Tuple[Any, ...]:
    """Real arguments of ``cell`` on ``device`` (a cell to run, not to
    trace), drawn from ``gen`` (a generator on ``device``): float leaves
    N(0, 0.02^2) (an optimizer state's moments zero, as ``adamw_init``
    makes them), int8 mantissas uniform in [-127, 127], token ids below
    ``vocab_size``, a decode position at the last cache slot and a step
    count of 0."""
    last = cell.shape.seq_len - 1 if cell.shape.kind == "decode" else 0

    def one(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype.is_floating_point and "opt_state" in path:
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=gen, device=device)
                    * 0.02).to(t.dtype)
        if t.dtype == torch.int8:
            return torch.randint(-127, 128, t.shape, generator=gen,
                                 device=device, dtype=t.dtype)
        if t.ndim == 0:
            return torch.tensor(last, dtype=t.dtype, device=device)
        return torch.randint(0, vocab_size, t.shape, generator=gen,
                             device=device, dtype=t.dtype)

    return tuple(_tree.map_with_path(one, a) for a in cell.args)
