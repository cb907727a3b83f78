"""The port's LM tree walks over the recurrent families' and the
encoder-decoder's trees against ``repro``, bit for bit: rule paths and
eligibility on every leaf path (``rem/<i>/...``, ``periods/...``,
``enc/...``, ``dec/...``), the prequant walk, ``bind(tree="lm")``'s site
table and sidecars, the float retry's dequantized tree, packed
containers and a ``bfp_packed`` checkpoint.  The PolicyMap is
``test_torch_lm_walkers.py``'s (a block that does not divide K, a float
rule, an L_W of 12, the default elsewhere).
"""
import warnings

import jax
import numpy as np
import pytest

from repro import engine as REG
from repro.core import packed as RPK
from repro.core import prequant as RPQ
from repro.serve import degrade as RDG
from repro_torch import _tree
from repro_torch import engine as PEG
from repro_torch.checkpoint import store
from repro_torch.core import packed as PPK
from repro_torch.core import policy as PPOL
from repro_torch.core import prequant as PPQ
from repro_torch.serve import degrade as PDG
from test_torch_lm_walkers import (PORT_MAP, REF_MAP, _packed_rows, _paths,
                                   _ref_paths, _site_row)
from test_torch_util import assert_bits_equal, to_numpy_tree
from torch_lm_common import ARCH3, np_leaves, port_params, ref_params_np


def _ref_quantized(arch, layers=2):
    q = jax.jit(lambda p: RPQ.quantize_param_tree(p, REF_MAP))(
        ref_params_np(arch, n_layers=layers))
    return to_numpy_tree(q)


@pytest.mark.parametrize("arch", ARCH3)
def test_rule_paths_prequant_walk_and_site_table(arch):
    """``lm_rule_path`` / ``lm_eligible`` on every leaf path (``rem/<i>``,
    ``periods``, ``enc``, ``dec``), the prequant walk bit for bit, and
    ``bind(tree="lm")``'s site table and sidecars."""
    pp = port_params(arch)
    for path, _ in _tree.leaves_with_path(pp):
        keys = [str(k) for k in path]
        assert PPQ.lm_rule_path(keys) == RPQ.lm_rule_path(keys)
        assert PPQ.lm_eligible(keys) == RPQ.lm_eligible(keys)
    ref = _ref_quantized(arch)
    port = PPQ.quantize_param_tree(port_params(arch), PORT_MAP)
    assert _paths(port, None) == _ref_paths(ref)
    for got, want in zip(np_leaves(port), jax.tree_util.tree_leaves(ref)):
        assert_bits_equal(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rplan = REG.bind(ref, REF_MAP, tree="lm", prequantize=False)
        pplan = PEG.bind(port_params(arch), PORT_MAP, device="cpu")
    assert [_site_row(pplan.sites[k]) for k in sorted(pplan.sites)] == \
        [_site_row(rplan.sites[k]) for k in sorted(rplan.sites)]
    assert {"rwkv6-3b": "tm/wr", "recurrentgemma-9b": "rec/in_x",
            "seamless-m4t-medium": "enc/attn/wq"}[arch] in pplan.sites
    for got, want in zip(np_leaves(pplan.params),
                         jax.tree_util.tree_leaves(rplan.params)):
        assert_bits_equal(got, np.asarray(want))
    # the float retry's tree: every sidecar dequantized, as the reference's
    for got, want in zip(np_leaves(PDG.float_params(pplan.params, "cpu")),
                         jax.tree_util.tree_leaves(
                             jax.jit(RDG.float_params)(rplan.params))):
        assert_bits_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch,layers", [("rwkv6-3b", 2),
                                         ("recurrentgemma-9b", 5),
                                         ("seamless-m4t-medium", 2)])
def test_packed_containers_and_checkpoint(arch, layers, tmp_path):
    """``pack_param_tree(kind="lm")``'s containers byte-identical to
    ``repro``'s (fixed and variable L), and a ``bfp_packed`` checkpoint
    restored equal to ``prequantize`` (the hybrid's ``rem`` list
    included).  An empty stack (the 2-layer hybrid's periods) packs at
    a fixed L, and variable-L packing refuses it in both packages (R9)."""
    ref = _ref_quantized(arch, layers)
    params = port_params(arch, n_layers=layers)
    for variable in (False, True):
        want = _packed_rows(jax.tree_util.tree_leaves(
            RPK.pack_param_tree(ref, REF_MAP, kind="lm", variable=variable),
            is_leaf=RPK.is_packed), RPK.is_packed)
        got = _packed_rows(_tree.flatten(PPK.pack_param_tree(
            params, PORT_MAP, variable=variable),
            is_leaf=PPK.is_packed)[0], PPK.is_packed)
        assert [k for k, _ in got] == [k for k, _ in want]
        assert sum(k == "packed" for k, _ in got) >= 5
        for (kind, g), (_, w) in zip(got, want):
            if kind == "packed":
                assert g == w
            else:
                assert_bits_equal(g, w)
    pol = PPOL.PALLAS_TILED.with_(block_k=32)
    store.save(str(tmp_path), 0, params, format="bfp_packed", policy=pol,
               tree_kind="lm")
    got, _ = store.restore(str(tmp_path), params, device="cpu")
    want = PEG.prequantize(params, pol)
    assert _paths(got, PPQ.is_prequant) == _paths(want, PPQ.is_prequant)
    for g, w in zip(np_leaves(got), np_leaves(want)):
        assert_bits_equal(g, w)
    if arch == "recurrentgemma-9b":
        empty = port_params(arch)
        assert empty["periods"]["rec1"]["rec"]["wr"]["w"].shape[0] == 0
        fixed = PPK.pack_param_tree(empty, PORT_MAP)
        assert PPK.is_packed(fixed["periods"]["rec1"]["rec"]["wr"]["w"])
        with pytest.raises(ValueError, match="does not tile"):
            RPK.pack_param_tree(_ref_quantized(arch), REF_MAP, kind="lm",
                                variable=True)
        with pytest.raises(ValueError, match="does not tile"):
            PPK.pack_param_tree(empty, PORT_MAP, variable=True)
