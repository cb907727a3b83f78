"""Sharded serving on one process and the LM models' ``shard``
annotations, on the CPU.

* ``CnnServeEngine(mesh=1x1 mesh, rules=DEFAULT_RULES)`` gives logits
  bit-equal to ``repro``'s UNSHARDED engine (``repro``'s mesh run fails
  here, R3) on LeNet exported from ``repro``: at EQ4 on the emulated
  datapath and at TILED on the kernel backend (blocks LeNet's K's
  divide: c1 25, the rest 16; ``repro``'s side on its emulated TILED
  datapath, since its Pallas conv does not run here, R1).
* The annotations stand at ``repro``'s call sites with its logical axes:
  the set of axis tuples ``shard`` sees in one forward (and one decode
  step) of each family equals the set ``repro``'s model code passes to
  its ``shard`` while ``jax.eval_shape`` traces the same reduced model.
* With no binding and with a 1x1 binding (plain tensors), a dense and a
  MoE model's forward, decode step and training step give the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.bfp import Scheme as JScheme
from repro.core.policy import PAPER_DEFAULT as J_PAPER
from repro.core.policy import BFPPolicy as JPolicy
from repro.engine import PolicyMap as JPolicyMap
from repro.models.cnn import MODELS as J_MODELS
from repro.models.lm import common as JC
from repro.models.lm import model as JM
from repro.models.lm import moe as JMOE
from repro.models.lm import rwkv6 as JR
from repro.serve.cnn import CnnServeEngine as JEngine
from repro_torch.convert import params_from_numpy
from repro_torch.core.bfp import Scheme
from repro_torch.core.policy import PALLAS_TILED, PAPER_DEFAULT, BFPPolicy
from repro_torch.dist import sharding as DS
from repro_torch.engine import PolicyMap
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.cnn import MODELS
from repro_torch.models.lm import model as M
from repro_torch.serve.cnn import CnnServeEngine
from repro_torch.train import step as TS
from test_torch_util import t, to_numpy_tree
from torch_lm_common import cfgs


def _tiled_maps():
    """(the port's map on the kernel backend, repro's emulated map)."""
    def one(bk):
        return (BFPPolicy(scheme=Scheme.TILED, block_k=bk, backend="pallas",
                          straight_through=False),
                JPolicy(scheme=JScheme.TILED, block_k=bk,
                        straight_through=False))
    c1, rest = one(25), one(16)
    return (PolicyMap.of(("^c1$", c1[0]), default=rest[0]),
            JPolicyMap.of(("^c1$", c1[1]), default=rest[1]))


POLS = {"eq4": (PAPER_DEFAULT.with_(straight_through=False),
                J_PAPER.with_(straight_through=False)),
        "tiled": _tiled_maps()}
LM_POL = PALLAS_TILED.with_(block_k=32, straight_through=False)


@pytest.fixture
def mesh11():
    assert not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def lenet():
    spec = J_MODELS["lenet"]
    params = to_numpy_tree(jax.jit(spec.init)(jax.random.PRNGKey(0)))
    imgs = [np.asarray(jax.random.normal(jax.random.PRNGKey(7 + i),
                                         spec.input_shape()))
            for i in range(5)]
    return params, imgs


@pytest.mark.parametrize("pol", sorted(POLS))
def test_mesh_1x1_engine_equals_repro_unsharded(lenet, mesh11, pol):
    params, imgs = lenet
    port_pol, ref_pol = POLS[pol]
    eng = CnnServeEngine(params_from_numpy(params, device="cpu"),
                         MODELS["lenet"].apply, port_pol, slots=4,
                         mesh=mesh11, rules=DS.DEFAULT_RULES, device="cpu",
                         strict_backend=True)
    reqs = [eng.submit(image=t(i)) for i in imgs]
    eng.run()
    jeng = JEngine(params, J_MODELS["lenet"].apply, ref_pol, slots=4)
    jreqs = [jeng.submit(image=jnp.asarray(i)) for i in imgs]
    jeng.run()
    assert eng.stats == jeng.stats and eng.ncalls == jeng.ncalls == 2
    got = np.stack([r.logits for r in reqs])
    want = np.stack([np.asarray(r.logits) for r in jreqs])
    assert got.shape == (5, 10) and np.array_equal(got, want), \
        np.abs(got - want).max()


# -- the annotations --------------------------------------------------------

def _port_sites(monkeypatch, mesh, run):
    seen = set()
    resolve = DS.resolve_spec

    def record(rules, sizes, shape, names):
        seen.add(tuple(names))
        return resolve(rules, sizes, shape, names)

    monkeypatch.setattr(DS, "resolve_spec", record)
    with DS.axis_rules(DS.DEFAULT_RULES, mesh):
        run()
    monkeypatch.undo()
    return seen


def _ref_sites(monkeypatch, run, *args):
    seen = set()

    def record(x, *names):
        seen.add(tuple(names))
        return x

    for mod in (JC, JM, JMOE, JR):
        monkeypatch.setattr(mod, "shard", record)
    jax.eval_shape(run, *args)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "rwkv6-3b", "seamless-m4t-medium"])
def test_annotations_at_repro_call_sites(monkeypatch, mesh11, arch):
    jcfg, cfg = cfgs(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    jparams = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    tok = torch.zeros((2, 8), dtype=torch.int32)
    got = _port_sites(monkeypatch, mesh11,
                      lambda: M.forward(params, cfg, tok))
    want = _ref_sites(monkeypatch, lambda p: JM.forward(
        p, jcfg, jnp.zeros((2, 8), jnp.int32)), jparams)
    assert got == want and len(got) >= 3, (got, want)
    if cfg.is_encdec:
        return
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    got = _port_sites(monkeypatch, mesh11, lambda: M.decode_step(
        params, cfg, cache, tok[:, :1], 0))
    want = _ref_sites(monkeypatch, lambda p: JM.decode_step(
        p, jcfg, JM.init_cache(jcfg, 2, 16), jnp.zeros((2, 1), jnp.int32),
        jnp.int32(0)), jparams)
    assert got == want, (got, want)


def _leaves(tree):
    from repro_torch import _tree
    return [x for x in _tree.flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _bits(x):
    return x.detach().reshape(-1).view(torch.uint8)


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_bound_and_unbound_runs_are_the_same_bits(mesh11, arch):
    _, cfg = cfgs(arch)
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(3),
                        dtype=torch.int32)

    def runs():
        state = TS.init_state(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        logits, aux = M.forward(state.params, cfg, tok, policy=LM_POL)
        cache = M.init_cache(cfg, 2, 16, device="cpu")
        step = M.decode_step(state.params, cfg, cache, tok[:, :1], 0,
                             policy=LM_POL)
        train = TS.make_train_step(cfg, policy=LM_POL)(
            state, (tok, torch.roll(tok, -1, dims=1)))
        return (logits, aux), step, train

    free = runs()
    with DS.axis_rules(DS.DEFAULT_RULES, mesh11):
        bound = runs()
    for a, b in zip(free, bound):
        assert _same(a, b)
