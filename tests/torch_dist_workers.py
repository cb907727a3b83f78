"""Rank bodies for ``tests/test_torch_dist_ranks.py``: each runs in a
spawned process of a ``gloo`` group over a ``file://`` store and
returns a dict the parent loads and compares.  Nothing here imports JAX.

:func:`run_ranks` spawns the ranks and joins each within a time limit,
so a rank blocked in a collective fails the test instead of hanging the
suite; every group also carries a 60 s collective timeout.
"""
import datetime
import multiprocessing as mp
import os
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

JOIN_S = 120


def _entry(fn, rank, world, tmp, args):
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/store", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world, tmp, *args, join_s=JOIN_S):
    """[fn(rank, world, *args) for each rank], from ``world`` spawned
    processes; raises if a rank fails or outlives ``join_s`` seconds."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(join_s)
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = {r: open(os.path.join(tmp, f"rank{r}.err")).read()
            for r in range(world)
            if os.path.exists(os.path.join(tmp, f"rank{r}.err"))}
    if late or errs or any(p.exitcode for p in procs):
        raise AssertionError(f"ranks still running after {join_s} s: "
                             f"{late}; exit codes "
                             f"{[p.exitcode for p in procs]}; {errs}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# -- the engine on meshes of 2 ranks ---------------------------------------

def policy(name):
    from repro_torch.core.policy import PALLAS_TILED, PAPER_DEFAULT
    return {"eq4": PAPER_DEFAULT,
            "tiled": PALLAS_TILED}[name].with_(straight_through=False)


def model_data(model):
    """Seeded params and 3 images of a reduced model; the third image is
    scaled by 8, so the block max of its rows is not the other rows'."""
    from repro_torch.models.cnn import MODELS

    spec = MODELS[model]
    params = spec.init(torch.Generator().manual_seed(0), reduced=True,
                       device="cpu")
    gen = torch.Generator().manual_seed(1)
    imgs = [torch.randn(spec.input_shape(), generator=gen)
            for _ in range(3)]
    imgs[2] = imgs[2] * 8
    return params, imgs


def serve(model, pol, mesh=None, **kw):
    """(logits [3, classes], errors, ShardingRuleDropped count) of the 3
    images served on ``mesh`` (None: unsharded)."""
    from repro_torch.dist import sharding as DS
    from repro_torch.models.cnn import MODELS
    from repro_torch.serve.cnn import CnnServeEngine

    params, imgs = model_data(model)
    apply = kw.pop("apply", MODELS[model].apply)
    eng = CnnServeEngine(params, apply, policy(pol), mesh=mesh,
                         device="cpu", **{"slots": 4, **kw})
    DS._DROP_WARNED.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        reqs = [eng.submit(image=i) for i in imgs]
        eng.run()
    drops = sum(issubclass(r.category, DS.ShardingRuleDropped) for r in rec)
    errs = [None if r.error is None else repr(r.error) for r in reqs]
    logits = (np.stack([r.logits for r in reqs])
              if all(e is None for e in errs) else None)
    return logits, errs, drops


def engine_ranks(rank, world):
    from repro_torch.dist import sharding as DS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.cnn import MODELS

    m21 = make_mesh((2, 1), ("data", "model"), device_type="cpu")
    m12 = make_mesh((1, 2), ("data", "model"), device_type="cpu")
    out = {}
    for model in ("lenet", "cifarnet"):
        for pol in ("eq4", "tiled"):
            out[model, pol, "2x1"] = serve(model, pol, m21)
            out[model, pol, "2x1_b3"] = serve(model, pol, m21, slots=3,
                                              buckets=(3,))
            out[model, pol, "1x2"] = serve(model, pol, m12)
    amax = DS.group_amax
    DS.group_amax = lambda a: a             # the control: no group max
    try:
        out["lenet", "eq4", "2x1_local_max"] = serve("lenet", "eq4", m21)
    finally:
        DS.group_amax = amax

    def raises_on_rank1(params, x, pol):
        if dist.get_rank() == 1:
            raise RuntimeError("forward failed on rank 1")
        return MODELS["lenet"].apply(params, x, pol)

    out["lenet", "tiled", "2x1_raises"] = serve("lenet", "tiled", m21,
                                                apply=raises_on_rank1)
    return out


# -- a (2, 2) mesh: shard on DTensors, restore(sharding_fn=) -----------------

def mesh22_ranks(rank, world, ckpt):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import _tree
    from repro_torch.checkpoint import store
    from repro_torch.dist import sharding as DS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.cnn import MODELS

    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    rep = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    out = {"coord": tuple(mesh.get_coordinate())}
    for label, rules, names in (
            ("batch_ffn", DS.DEFAULT_RULES, ("batch", "ffn")),
            ("tuple", {"batch": ("data", "model")}, ("batch", None))):
        with DS.axis_rules(rules, mesh):
            y = DS.shard(rep, *names)
        out[label] = (y.to_local().clone(), y.full_tensor(),
                      tuple(map(str, y.placements)))
    like = MODELS["lenet"].init(torch.Generator().manual_seed(0),
                                reduced=True, device="cpu")
    for mode in ("float", "dequant"):
        base = os.path.join(ckpt, mode)
        plain, _ = store.restore(base, like, packed="dequant", device="cpu")
        leaves = _tree.flatten(plain)[0]

        def fn(i):
            return (mesh, [Shard(0) if leaves[i].ndim else Replicate(),
                           Replicate()])

        placed, _ = store.restore(base, like, packed="dequant",
                                  device="cpu", sharding_fn=fn)
        out[mode] = [(tuple(p.to_local().shape), torch.equal(
            p.full_tensor(), q)) for p, q in zip(_tree.flatten(placed)[0],
                                                   leaves)]
    return out
