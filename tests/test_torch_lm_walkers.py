"""The port's LM walkers against ``repro``, bit for bit: the prequant
walk (``quantize_param_tree`` / ``engine.prequantize``: stacked
``[L, K, N]`` leaves, ``[L, E, K, N]`` MoE experts, float routers,
embeddings and biases), ``bind(tree="lm")``'s site table, and the bytes
of ``pack_param_tree(kind="lm")``; and an LM ``bfp_packed`` checkpoint
restored equal to ``prequantize`` and served like its dequantized
twin.

One PolicyMap exercises the walk's branches: a block that does not
divide K (``ffn/w2``: K = 128, block 48: stays float), a float rule
(``attn/wo``), an L_W of 12 (int16 mantissas: the kernel backend falls
back to emulated, with a warning), the MoE experts at their own width
and block, and the default elsewhere.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import engine as REG
from repro.core import packed as RPK
from repro.core import policy as RPOL
from repro.core import prequant as RPQ
from repro.engine import backends as RBK
from repro_torch import engine as PEG
from repro_torch import _tree
from repro_torch.checkpoint import store
from repro_torch.core import packed as PPK
from repro_torch.core import policy as PPOL
from repro_torch.core import prequant as PPQ
from repro_torch.engine import backends as PBK
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_util import assert_bits_equal, to_numpy_tree
from torch_lm_common import (ARCH7, cfgs, np_leaves, port_params,
                             ref_params_np)


def _pmap(pol_mod, emap):
    base = pol_mod.PALLAS_TILED.with_(block_k=32, straight_through=False)
    return emap.of(("^ffn/w2$", base.with_(block_k=48)),
                   ("^attn/wo$", None),
                   ("^ffn/w1$", base.with_(l_w=12)),
                   ("^moe", base.with_(l_w=6, block_k=16)),
                   ("^lm_head$", base.with_(l_i=6)),
                   default=base)


REF_MAP = _pmap(RPOL, REG.PolicyMap)
PORT_MAP = _pmap(PPOL, PEG.PolicyMap)


def _ref_quantized(arch):
    q = jax.jit(lambda p: RPQ.quantize_param_tree(p, REF_MAP))(
        ref_params_np(arch))
    return to_numpy_tree(q)


def _paths(tree, is_leaf):
    return [_tree.keystr(p) for p, _ in _tree.leaves_with_path(
        tree, is_leaf=is_leaf)]


def _ref_paths(tree, is_leaf=None):
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)]


@pytest.mark.parametrize("arch", ARCH7)
def test_quantize_param_tree_bit_equal(arch):
    ref = _ref_quantized(arch)
    port = PPQ.quantize_param_tree(port_params(arch), PORT_MAP)
    assert _paths(port, None) == _ref_paths(ref)
    for got, want in zip(np_leaves(port), jax.tree_util.tree_leaves(ref)):
        assert_bits_equal(got, want)
    layers = port["layers"]
    assert PPQ.is_prequant(layers["attn"]["wq"]["w"])
    assert not PPQ.is_prequant(layers["attn"]["wo"]["w"])    # float rule
    if "ffn" in layers:
        assert not PPQ.is_prequant(layers["ffn"]["w2"]["w"])  # 48 ∤ 128
        assert layers["ffn"]["w1"]["w"]["m"].dtype == torch.int16
    else:                       # [L, E, K, N] experts, float router
        moe = layers["moe"]
        assert moe["w1"]["m"].shape == moe["w1"]["m"].shape[:2] + (64, 128)
        assert moe["w1"]["s"].shape[-2] == 64 // 16
        assert not PPQ.is_prequant(moe["router"]["w"])
    assert not PPQ.is_prequant(port["embed"]["e"])
    assert PPQ.quantize_param_tree(port, None) is port
    again = PEG.prequantize(port_params(arch), PORT_MAP)
    assert all(np.array_equal(a, b) for a, b in
               zip(np_leaves(again), np_leaves(port)))


def _site_row(s):
    def pol(p):
        if p is None:
            return None
        return (p.l_w, p.l_i, p.scheme.value, p.block_k, p.rounding.value,
                p.backend_name)

    def grad(g):
        return None if g is None else (pol(g.policy), getattr(
            g.backend, "name", None))
    return (s.path, s.kind, pol(s.policy), s.backend.name, s.fallback,
            s.prequantized, grad(s.dx), grad(s.dw))


@pytest.mark.parametrize("arch", ARCH7)
def test_bind_lm_site_table(arch):
    """The site table of ``bind(tree="lm")``: paths, kinds, resolved
    policies, backends, fallbacks, prequant flags and the bound backward
    specs.  Both sides bind the same quantized tree (the reference with
    ``prequantize=False``: its eager walk compiles op by op); the port
    also binds the float tree with its own walk, to the same table and
    the same sidecars."""
    with warnings.catch_warnings(record=True) as rw:
        warnings.simplefilter("always")
        rplan = REG.bind(_ref_quantized(arch), REF_MAP, tree="lm",
                         prequantize=False)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        pplan = PEG.bind(port_params(arch), PORT_MAP, device="cpu")
    want = [_site_row(rplan.sites[k]) for k in sorted(rplan.sites)]
    got = [_site_row(pplan.sites[k]) for k in sorted(pplan.sites)]
    assert got == want
    # the l_w = 12 site (int16 mantissas) fell back, warned in both
    fb = sorted(k for k, s in pplan.sites.items() if s.fallback)
    assert fb == sorted(k for k, s in rplan.sites.items() if s.fallback)
    assert bool(fb) == any(issubclass(w.category,
                                      RBK.BackendFallbackWarning)
                           for w in rw)
    assert bool(fb) == any(issubclass(w.category,
                                      PBK.BackendFallbackWarning)
                           for w in pw)
    for got_l, want_l in zip(np_leaves(pplan.params),
                             jax.tree_util.tree_leaves(rplan.params)):
        assert_bits_equal(got_l, np.asarray(want_l))
    assert pplan.describe() == rplan.describe()


def test_bind_lm_strict_refuses_and_first_path_wins():
    arch = "tinyllama-1.1b"
    eq4 = PPOL.PAPER_DEFAULT.with_(backend="pallas")
    with pytest.raises(PBK.BackendUnsupportedError):
        PEG.bind(port_params(arch), eq4, tree="lm", strict=True,
                 device="cpu")
    with pytest.raises(RBK.BackendUnsupportedError):
        REG.bind(ref_params_np(arch), RPOL.PAPER_DEFAULT.with_(
            backend="pallas"), tree="lm", strict=True, prequantize=False)
    with pytest.raises(ValueError, match="tree must be"):
        PEG.bind(port_params(arch), eq4, tree="rnn", device="cpu")
    # two leaves aliasing one runtime path: the first in the sorted walk
    # wins ("dec" sorts before "layers"; its K = 40 stays float)
    pol = PPOL.PALLAS_TILED.with_(block_k=32)
    p = port_params(arch)
    p["dec"] = {"attn": {"wq": {"w": torch.ones(40, 8)}}}
    plan = PEG.bind(p, pol, tree="lm", device="cpu")
    r = _ref_quantized(arch)
    r["dec"] = {"attn": {"wq": {"w": np.ones((40, 8), np.float32)}}}
    rplan = REG.bind(r, RPOL.PALLAS_TILED.with_(block_k=32), tree="lm",
                     prequantize=False)
    assert not plan.sites["attn/wq"].prequantized
    assert not rplan.sites["attn/wq"].prequantized
    assert PPQ.is_prequant(plan.params["layers"]["attn"]["wq"]["w"])


def _packed_rows(leaves, is_packed):
    """("packed", container bytes) or ("plain", array) per leaf."""
    return [("packed", leaf.to_bytes()) if is_packed(leaf) else
            ("plain", np.asarray(leaf.cpu() if isinstance(leaf, torch.Tensor)
                                 else leaf)) for leaf in leaves]


@pytest.mark.parametrize("variable", [False, True])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-4b",
                                  "olmoe-1b-7b"])
def test_pack_param_tree_lm_bytes(arch, variable):
    """The packed containers' bytes: the reference packs its quantized
    tree as-is, the port packs the float tree (quantizing it itself)."""
    ref = RPK.pack_param_tree(_ref_quantized(arch), REF_MAP, kind="lm",
                              variable=variable)
    port = PPK.pack_param_tree(port_params(arch), PORT_MAP,
                               variable=variable)
    want = _packed_rows(jax.tree_util.tree_leaves(
        ref, is_leaf=RPK.is_packed), RPK.is_packed)
    got = _packed_rows(_tree.flatten(port, is_leaf=PPK.is_packed)[0],
                       PPK.is_packed)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert sum(k == "packed" for k, _ in got) >= 5
    for (kind, g), (_, w) in zip(got, want):
        if kind == "packed":
            assert g == w
        else:
            assert_bits_equal(g, w)
    # already-prequantized sidecars pack as they are
    again = PPK.pack_param_tree(PEG.prequantize(port_params(arch),
                                                PORT_MAP), PORT_MAP,
                                kind="lm", variable=variable)
    assert [v for k, v in _packed_rows(_tree.flatten(
        again, is_leaf=PPK.is_packed)[0], PPK.is_packed)
        if k == "packed"] == [v for k, v in got if k == "packed"]


def test_lm_packed_checkpoint_matches_prequantize(tmp_path):
    arch = "olmoe-1b-7b"
    params = port_params(arch)
    pol = PPOL.PALLAS_TILED.with_(block_k=32)
    want = PEG.prequantize(params, pol)
    store.save(str(tmp_path), 0, params, format="bfp_packed", policy=pol,
               tree_kind="lm")
    got, step = store.restore(str(tmp_path), params, device="cpu")
    assert step == 0
    assert _paths(got, PPQ.is_prequant) == _paths(want, PPQ.is_prequant)
    for g, w in zip(np_leaves(got), np_leaves(want)):
        assert_bits_equal(g, w)


def test_lm_serve_engine_accepts_packed_artifact(tmp_path):
    """A ``packed="keep"`` artifact (containers unpacked at admission)
    decodes exactly like the ``packed="dequant"`` tree: the float
    backend dequantizes the sidecars to the same values."""
    arch = "tinyllama-1.1b"
    cfg = cfgs(arch)[1]
    params = port_params(arch)
    pol = PPOL.PALLAS_TILED.with_(block_k=32)
    store.save(str(tmp_path), 0, params, format="bfp_packed", policy=pol,
               tree_kind="lm")
    kept, _ = store.restore(str(tmp_path), params, packed="keep",
                            device="cpu")
    deq, _ = store.restore(str(tmp_path), params, packed="dequant",
                           device="cpu")
    assert any(PPK.is_packed(v) for v in
               _tree.flatten(kept, is_leaf=PPK.is_packed)[0])

    def run(p, policy=None):
        eng = ServeEngine(p, cfg, slots=2, max_len=64, policy=policy,
                          device="cpu")
        reqs = [Request(rid=i, prompt=[1 + i, 2, 3], max_new=4)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.error is None for r in reqs)
        return [r.out for r in reqs]

    assert run(kept) == run(deq)
    # on the BFP datapath the kept artifact serves like the float tree
    # bound under the same policy (weights formatted inline, same blocks)
    assert run(kept, pol) == run(params, pol)
