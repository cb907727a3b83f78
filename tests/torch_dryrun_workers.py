"""Rank bodies for ``tests/test_torch_roofline.py`` and
``tests/test_torch_dryrun_cells.py``: dry-run cells run for real on
spawned ``gloo`` ranks (``torch_dist_workers.run_ranks``), their
arguments placed by the cells' specs as the dry run places its fakes.
Nothing here imports JAX."""
import numpy as np
import torch

#: (mesh shape, cell kind): (2, 2) splits KV heads like the query heads;
#: (1, 4) splits 4 query heads over 2 KV heads, so each rank slices its
#: KV head (``roofline.partition.attention_local``).
CASES = [((2, 2), "prefill"), ((1, 4), "decode"), ((1, 4), "train")]


def _leaves(tree):
    from torch.distributed.tensor import DTensor

    from repro_torch import _tree
    return [(t.full_tensor() if isinstance(t, DTensor) else t)
            .detach().float().numpy()
            for t in _tree.flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _args(cell, cfg, materialize):
    """The cell's seeded arguments with the model's own init (at
    ``materialize``'s N(0, 0.02^2) attention barely moves the logits) and,
    for decode, a cache of N(0, 1) keys and values."""
    from repro_torch import _tree
    from repro_torch.models.lm import model as M

    args = list(materialize(cell, cfg.vocab_size,
                            torch.Generator().manual_seed(0), "cpu"))
    params = M.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    if cell.shape.kind == "train":
        args[0] = args[0]._replace(params=params)
    else:
        args[0] = params
    if cell.shape.kind == "decode":
        gen = torch.Generator().manual_seed(2)
        args[1] = _tree.tree_map(
            lambda t: torch.randn(t.shape, generator=gen).to(t.dtype),
            args[1])
    return args


def sharded_cell_ranks(rank, world):
    """{(mesh, kind): (plain leaves, placed leaves)} of reduced
    TinyLlama's cells, the same seeded arguments on every rank."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeConfig, reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.dist.sharding import axis_rules
    from repro_torch.launch.dryrun import place
    from repro_torch.launch.input_specs import build_cell, materialize
    from repro_torch.roofline.partition import spmd

    cfg = reduced(ARCHS["tinyllama-1.1b"])
    out = {}
    meshes = {}
    for shape, kind in CASES:
        if shape not in meshes:
            meshes[shape] = init_device_mesh("cpu", shape,
                                             mesh_dim_names=("data", "model"))
        mesh = meshes[shape]
        cell = build_cell(cfg, ShapeConfig(kind, 32, 4, kind), mesh)
        args = _args(cell, cfg, materialize)
        want = _leaves(cell.fn(*args))
        placed = place(args, cell.in_specs, mesh)
        with implicit_replication(), axis_rules(cell.rules, mesh), spmd():
            got = _leaves(cell.fn(*placed))
        out[shape, kind] = (want, got)
    return out


def max_rel(want, got):
    """Largest |got - want| over each leaf's max |want|."""
    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
               for w, g in zip(want, got))


# -- the cells that needed partitioner rules beyond attention ---------------

#: name -> (mesh shape, cell kinds) of a ``reduced()`` config
#: (:func:`cell_config`) that recreates one failing condition of the
#: full-width cells on 4 ranks: MoE expert-parallel (4 experts on the
#: model axis) and tensor-parallel inside experts (2 experts), each at a
#: capacity factor where tokens drop; the hybrid's RG-LRU scan (one
#: (rec, rec, attn) period); 6 attention heads and 6 WKV heads over a
#: model axis of 4.
CELLS = {
    "olmoe_ep": ((1, 4), ("prefill", "train")),
    "mixtral_tp": ((1, 4), ("prefill", "train")),
    "hybrid": ((1, 4), ("prefill", "train")),
    "minicpm_6h": ((1, 4), ("train",)),
    "rwkv6_6h": ((1, 4), ("train",)),
}

#: (cell name, mesh shape, kind) of every case
CELL_CASES = [(name, shape, kind) for name, (shape, kinds) in CELLS.items()
              for kind in kinds]

#: capacity factor of the MoE cases: T*K/E slots an expert on average
#: against a capacity of 49 (OLMoE-like, 64) and 97 (Mixtral-like, 128),
#: so tokens drop
MOE_CF = 0.75


def cell_config(name):
    """The ``reduced()`` config of CELLS[name] (one layer, or one hybrid
    period)."""
    import dataclasses

    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS

    if name == "olmoe_ep":
        return dataclasses.replace(reduced(ARCHS["olmoe-1b-7b"], n_layers=1),
                                   capacity_factor=MOE_CF)
    if name == "mixtral_tp":
        return dataclasses.replace(
            reduced(ARCHS["mixtral-8x7b"], n_layers=1), n_experts=2,
            capacity_factor=MOE_CF)
    if name == "hybrid":
        return reduced(ARCHS["recurrentgemma-9b"], n_layers=3)
    if name == "minicpm_6h":
        return dataclasses.replace(
            reduced(ARCHS["minicpm-2b"], n_layers=1, d_model=48), n_heads=6,
            n_kv_heads=6, head_dim=8)
    return dataclasses.replace(
        reduced(ARCHS["rwkv6-3b"], n_layers=1, d_model=96), n_heads=6,
        n_kv_heads=6, head_dim=16)


def f32_fn(cell, cfg):
    """``cell.fn``'s step with the model computing in f32 (the cell
    computes in bf16).  In bf16 the split and the whole reductions round
    apart by enough to flip the sign of AdamW's first update wherever a
    gradient element is near zero (the hybrid's zero-initialised conv
    bias comes out 2 lr apart); in f32 they agree to 1e-4 of each leaf's
    largest, and a lost or doubled partial sum is still off by the order
    of the values."""
    import dataclasses

    from repro_torch.models.lm import model as M
    from repro_torch.optim import optimizers as opt
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              analysis_unroll=True)
    if cell.shape.kind == "train":
        step = make_train_step(cfg, opt.constant_schedule(1e-4))

        def fn(state, tokens, targets):
            new_state, metrics = step(state, (tokens, targets))
            return new_state, metrics["loss"]
        return fn

    def fn(params, tokens):
        return M.forward(params, cfg, tokens)[0][:, -1]
    return fn


def _routes():
    """Record every ``models.lm.moe._route`` call's (expert_ids,
    gate_vals, keep, E, C) while installed; returns (records, restore)."""
    from repro_torch.models.lm import moe

    rec, route = [], moe._route

    def recording(expert_ids, gate_vals, e, cap):
        r = route(expert_ids, gate_vals, e, cap)
        rec.append((expert_ids.clone(), gate_vals.detach().clone(),
                    r[2].clone(), e, cap))
        return r

    moe._route = recording
    return rec, lambda: setattr(moe, "_route", route)


def cell_ranks(rank, world):
    """{(name, mesh, kind): (plain leaves, placed leaves, plain routes,
    placed routes)} of :data:`CELL_CASES` run by :func:`f32_fn`, the same
    seeded arguments on every rank; routes are the MoE layers'
    (expert_ids, gate_vals, keep, E, C) as each run saw them (placed:
    this rank's local copy of the replicated routing)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import axis_rules
    from repro_torch.launch.dryrun import place
    from repro_torch.launch.input_specs import build_cell, materialize
    from repro_torch.roofline.partition import spmd

    torch.set_num_threads(1)    # 4 ranks beside the parent's traces
    out, meshes = {}, {}
    for name, shape, kind in CELL_CASES:
        if shape not in meshes:
            meshes[shape] = init_device_mesh("cpu", shape,
                                             mesh_dim_names=("data", "model"))
        mesh = meshes[shape]
        cfg = cell_config(name)
        cell = build_cell(cfg, ShapeConfig(kind, 32, 4, kind), mesh)
        fn = f32_fn(cell, cfg)
        args = _args(cell, cfg, materialize)
        rec, restore = _routes()
        try:
            want = _leaves(fn(*args))
            plain_routes = list(rec)
            rec.clear()
            placed = place(args, cell.in_specs, mesh)
            with implicit_replication(), axis_rules(cell.rules, mesh), \
                    spmd():
                got = _leaves(fn(*placed))
        finally:
            restore()
        out[name, shape, kind] = (want, got, plain_routes, list(rec))
    return out
