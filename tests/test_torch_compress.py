"""The port's BFP gradient wire (``repro_torch.dist.compress``) against
``repro.dist.compress``.

All bit for bit: the in-graph round trip (``quantize_leaf``), the packed
containers (``pack_leaf``'s serialized bytes, fixed and variable width),
their decoding in either package, the byte accounting (``leaf_wire_bytes``,
``wire_report``) and the error-feedback exchange (``packed_allreduce`` over
two logical workers: its mean, residuals and byte count), which also
equals the port's in-graph compressor.
"""
import jax
import numpy as np
import pytest
import torch

from repro.dist import compress as JDC
from repro_torch import _tree
from repro_torch.core.packed import IntegrityError
from repro_torch.dist import compress as DC
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

#: leaves with a remainder block, an exact multiple, a tiny one, zeros
LEAVES = [normal((3, 3, 16, 20), seed=1, scale=0.05), normal((1024,),
                                                             seed=2),
          normal((7, 3), seed=3, scale=1e3), np.zeros((40,), np.float32)]
LEAVES[0][0, 0, :4] = 0.0
CASES = [(8, 512), (4, 64), (6, 7)]
TREE = {"c": {"w": LEAVES[0], "b": LEAVES[3]}, "fc": {"w": LEAVES[2]},
        "step": np.array(5, np.int32)}
#: two workers' stacked gradients and residuals
GW = {"c": {"w": np.stack([normal((3, 3, 16, 20), seed=10 + i, scale=0.1)
                           for i in range(2)])},
      "fc": {"w": np.stack([normal((7, 3), seed=20 + i) for i in range(2)])}}
RW = {"c": {"w": np.stack([normal((3, 3, 16, 20), seed=30 + i,
                                  scale=1e-3) for i in range(2)])},
      "fc": {"w": np.stack([normal((7, 3), seed=40 + i, scale=1e-2)
                            for i in range(2)])}}


def tt(tree):
    return _tree.tree_map(lambda a: t(np.asarray(a)), tree)


@pytest.fixture(scope="module")
def ref():
    """repro's in-graph round trips in one compiled program; its packed
    containers and exchange (host-side, eager, as in repro)."""
    q = jax.jit(lambda leaves: [[JDC.quantize_leaf(g, b, k)
                                 for b, k in CASES] for g in leaves])(LEAVES)
    packs = [[JDC.pack_leaf(g, b, k, variable=v).to_bytes()
              for b, k in CASES for v in (False, True)] for g in LEAVES]
    mean, res, n = JDC.packed_allreduce(GW, RW, 8, 64)
    return {"q": to_numpy_tree(q), "packs": packs,
            "allreduce": (to_numpy_tree(mean), to_numpy_tree(res), n),
            "report": JDC.wire_report(TREE, 8, 64),
            "report_v": JDC.wire_report(TREE, 6, 7, variable=True)}


def test_validate_wire_block():
    for bad in (0, -1, 2.5, True, "8"):
        with pytest.raises(ValueError, match="wire block"):
            DC.validate_wire_block(bad)
    with pytest.raises(ValueError, match="tile_k"):
        DC.validate_wire_block(512, 0)
    with pytest.raises(ValueError, match="straddle"):
        DC.validate_wire_block(512, 96)
    DC.validate_wire_block(512, 128)
    with pytest.raises(ValueError, match="straddle"):
        DC.quantize_leaf(t(LEAVES[1]), 8, 512, tile_k=96)


@pytest.mark.parametrize("i", range(len(LEAVES)))
def test_quantize_leaf_matches_repro(ref, i):
    for (bits, block), want in zip(CASES, ref["q"][i]):
        got = DC.quantize_leaf(t(LEAVES[i]), bits, block)
        assert_bits_equal(got, want)
    ints = torch.arange(5, dtype=torch.int32)
    assert DC.quantize_leaf(ints, 8) is ints


@pytest.mark.parametrize("i", range(len(LEAVES)))
def test_pack_leaf_bytes_match_repro(ref, i):
    """Byte-identical containers; each decodes in the other package to
    that package's in-graph round trip."""
    k = 0
    for bits, block in CASES:
        for variable in (False, True):
            p = DC.pack_leaf(t(LEAVES[i]), bits, block, variable=variable)
            assert p.to_bytes() == ref["packs"][i][k]
            assert p.nbytes == len(ref["packs"][i][k])
            want = DC.quantize_leaf(t(LEAVES[i]), bits, block)
            assert_bits_equal(DC.unpack_leaf(p, "cpu"), want.numpy())
            assert_bits_equal(DC.unpack_leaf(ref["packs"][i][k], "cpu"),
                              ref["q"][i][CASES.index((bits, block))])
            k += 1
    # a numpy leaf packs to the same bytes
    assert DC.pack_leaf(LEAVES[i], 8, 512).to_bytes() == ref["packs"][i][0]


def test_unpack_leaf_verifies_crc():
    wire = bytearray(DC.pack_leaf(t(LEAVES[1]), 8, 64).to_bytes())
    wire[-3] ^= 0x10
    with pytest.raises(IntegrityError):
        DC.unpack_leaf(bytes(wire), "cpu")
    with pytest.raises(ValueError, match="float leaf"):
        DC.pack_leaf(torch.arange(4), 8)


@pytest.mark.parametrize("n", [1, 511, 512, 513, 4096, 10007])
@pytest.mark.parametrize("bits,block", CASES)
def test_leaf_wire_bytes_matches_repro(n, bits, block):
    assert DC.leaf_wire_bytes(n, bits, block) == \
        JDC.leaf_wire_bytes(n, bits, block)


def test_wire_report_matches_repro(ref):
    for key, args, kw in (("report", (8, 64), {}),
                          ("report_v", (6, 7), {"variable": True})):
        got = DC.wire_report(tt(TREE), *args, **kw)
        assert got == ref[key]
        assert got["n_uncompressed"] == 1 and got["n_leaves"] == 4
    # numpy leaves measure the same
    assert DC.wire_report(TREE, 8, 64) == ref["report"]


def test_packed_allreduce_matches_repro_and_the_in_graph_model(ref):
    mean, res, n = DC.packed_allreduce(tt(GW), tt(RW), 8, 64)
    want_mean, want_res, want_n = ref["allreduce"]
    assert n == want_n > 0
    for got, want in ((mean, want_mean), (res, want_res)):
        for g, w in zip(_tree.flatten(got)[0], _tree.flatten(want)[0]):
            assert_bits_equal(g, w)
    # the in-graph model per worker, averaged: the same bits
    _, transform = DC.make_compressor(8, 64)
    outs = [transform(_tree.tree_map(lambda a: t(a[i]), GW),
                      _tree.tree_map(lambda a: t(a[i]), RW))
            for i in range(2)]
    for path in (("c", "w"), ("fc", "w")):
        q = torch.stack([o[0][path[0]][path[1]] for o in outs])
        r = torch.stack([o[1][path[0]][path[1]] for o in outs])
        assert torch.equal(torch.mean(q, 0), mean[path[0]][path[1]])
        assert torch.equal(r, res[path[0]][path[1]])


def test_error_feedback_sum_converges():
    """With error feedback the running sum of compressed gradients tracks
    the true sum: the gap is the last residual, not a growing drift."""
    init, transform = DC.make_compressor(4, 64)
    gen = torch.Generator().manual_seed(0)
    g_tree = {"w": torch.randn(300, generator=gen)}
    r = init(g_tree)
    total_q = torch.zeros(300)
    total_g = torch.zeros(300)
    for _ in range(50):
        g = {"w": torch.randn(300, generator=gen) * 0.1}
        q, r = transform(g, r)
        total_q += q["w"]
        total_g += g["w"]
    assert torch.allclose(total_q + r["w"], total_g, atol=1e-4)
    assert float((total_q - total_g).abs().max()) < 0.05
