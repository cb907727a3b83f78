"""Rank body for ``tests/test_torch_roofline.py``: a dry-run cell run for
real on spawned ``gloo`` ranks (``torch_dist_workers.run_ranks``), its
arguments placed by the cell's specs as the dry run places its fakes.
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
