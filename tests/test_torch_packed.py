"""``repro_torch.core.packed`` against ``repro.core.packed``.

The same mantissas and exponents (from the same numpy inputs) give the
same container bytes in both packages: ``pack_block`` over every scheme
at L 2-16, ``pack_matrix``, ``pack_prequant`` on matrix, stacked and
conv-HWIO sidecars, fixed and variable width, and ``pack_param_tree`` on
reduced VGG16, ResNet-18, GoogLeNet and LeNet under PALLAS_TILED and
whole-K TPU_TILED.  Containers cross both ways through ``from_bytes``,
hand-made v1 bytes read in the port, and the integrity checks (garbage,
truncation, width-plane corruption) raise as in ``repro``.  The
non-LM, non-wire cases of ``tests/test_packed.py`` and
``tests/test_packed_v2.py`` are mirrored on the port, their properties
included.
"""
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # minimal container: deterministic fallback sampler
    from _hypothesis_stub import given, settings, strategies as st

from repro.core import bfp as jbfp
from repro.core import packed as jpk
from repro.core import prequant as jpq
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro_torch import _tree
from repro_torch import engine as EG
from repro_torch.convert import params_from_numpy
from repro_torch.core import bfp, packed
from repro_torch.core import prequant as PQ
from repro_torch.core.bfp import BFPBlock, Scheme
from repro_torch.core.policy import PALLAS_TILED, TPU_TILED
from repro_torch.models.cnn import MODELS
from test_torch_models_cnn import jax_params
from test_torch_util import assert_bits_equal, normal, t

POL = TPU_TILED.with_(block_k=None, straight_through=False)
J_POL = J_TPU_TILED.with_(block_k=None, straight_through=False)
TREE_POLICIES = {"pallas_tiled": (PALLAS_TILED, J_TPU_TILED.with_(
    backend="pallas")), "whole_k": (POL, J_POL)}
TREE_MODELS = ("lenet", "vgg16", "resnet18", "googlenet")


def _jscheme(s: Scheme):
    return jbfp.Scheme(s.value)


def _same_block(a: BFPBlock, b: BFPBlock) -> None:
    assert a.bits == b.bits
    assert a.mantissa.dtype == b.mantissa.dtype
    assert torch.equal(a.mantissa, b.mantissa)
    assert torch.equal(a.exponent, b.exponent)


def _width_plane_off(p) -> int:
    meta_len = len(json.dumps(p.meta).encode())
    return (packed._FIXED_HEADER + 4 * (len(p.shape) + len(p.exp_shape))
            + meta_len + p.exponents.size)


def _unpack(p):
    return packed.unpack_block(p, device="cpu")


# ---------------------------------------------------------------------------
# Containers: the same bytes as repro's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variable", [False, True])
@pytest.mark.parametrize("scheme", list(Scheme))
def test_pack_block_bytes_equal_repro_every_scheme_l2_to_16(scheme,
                                                            variable):
    x = normal((24, 40), seed=5)
    x[0, :8] = 0.0                                 # an all-zero block
    x[3] *= 1e-3
    bk = 8 if scheme is Scheme.TILED else None
    for bits in range(2, 17):
        for operand in ("w", "i"):
            blk = bfp.bfp_quantize_matrix(t(x), bits, operand, scheme, bk)
            jblk = jbfp.bfp_quantize_matrix(jnp.asarray(x), bits, operand,
                                            _jscheme(scheme), bk)
            mine = packed.pack_block(blk, variable=variable, tag=bits)
            ref = jpk.pack_block(jblk, variable=variable, tag=bits)
            assert mine.to_bytes() == ref.to_bytes(), (bits, operand)
            assert mine.nbytes == ref.nbytes == len(ref.to_bytes())
            mm = packed.pack_matrix(t(x), bits, operand, scheme, bk,
                                    variable=variable)
            rm = jpk.pack_matrix(jnp.asarray(x), bits, operand,
                                 _jscheme(scheme), bk, variable=variable)
            assert mm.to_bytes() == rm.to_bytes(), (bits, operand)
            assert mm.meta == rm.meta


def _prequant_cases():
    """(label, float weight, policy block) of the sidecar layouts."""
    return [("matrix", normal((96, 10), seed=1, scale=0.1), 32),
            ("stacked", normal((2, 64, 6), seed=2, scale=0.1), 16),
            ("conv_hwio", normal((3, 3, 8, 12), seed=3, scale=0.1), 24)]


@pytest.mark.parametrize("variable", [False, True])
@pytest.mark.parametrize("case", [c[0] for c in _prequant_cases()])
def test_pack_prequant_bytes_equal_repro(case, variable):
    _, w, blk = next(c for c in _prequant_cases() if c[0] == case)
    pol, jpol = POL.with_(block_k=blk), J_POL.with_(block_k=blk)
    if w.ndim == 4:
        d, jd = PQ.prequant_conv_leaf(t(w), pol), \
            jpq.prequant_conv_leaf(jnp.asarray(w), jpol)
    else:
        d, jd = PQ.prequant_leaf(t(w), pol), \
            jpq.prequant_leaf(jnp.asarray(w), jpol)
    mine = packed.pack_prequant(d, 8, variable=variable, path="x",
                                conv=w.ndim == 4, block_k=blk,
                                scheme="tiled")
    ref = jpk.pack_prequant(jd, 8, variable=variable, path="x",
                            conv=w.ndim == 4, block_k=blk, scheme="tiled")
    assert mine.to_bytes() == ref.to_bytes()
    # both packages decode either container to the same sidecars
    back = packed.unpack_prequant(packed.PackedBFP.from_bytes(
        ref.to_bytes()), device="cpu")
    jback = jpk.unpack_prequant(jpk.PackedBFP.from_bytes(mine.to_bytes()))
    for k in ("m", "s"):
        assert torch.equal(back[k], d[k])
        assert_bits_equal(back[k], np.asarray(jback[k]))
    assert_bits_equal(packed.unpack_dequant(mine, device="cpu"),
                      np.asarray(jpk.unpack_dequant(ref)))


def test_from_bytes_both_ways_and_v1_read():
    x = normal((6, 24), seed=7)
    blk = bfp.quantize(t(x), 8, (1,))
    jblk = jbfp.quantize(jnp.asarray(x), 8, (1,))
    for variable in (False, True):
        mine = packed.pack_block(blk, variable=variable)
        ref = jpk.pack_block(jblk, variable=variable)
        q = packed.PackedBFP.from_bytes(ref.to_bytes())
        assert q.to_bytes() == ref.to_bytes() and q.stored_crc == ref.crc32()
        _same_block(_unpack(q), blk)
        jq = jpk.PackedBFP.from_bytes(mine.to_bytes())
        np.testing.assert_array_equal(np.asarray(jpk.unpack_block(jq)
                                                 .mantissa),
                                      blk.mantissa.numpy())
    # v1 (no CRC): the archived layout, hand-made from repro's container
    ref = jpk.pack_block(jblk)
    meta_b = json.dumps(ref.meta).encode()
    v1 = b"".join([b"BFPK", struct.pack("<BBBBI", 1, ref.bits,
                                        len(ref.shape), len(ref.exp_shape),
                                        len(meta_b)),
                   struct.pack(f"<{len(ref.shape) + len(ref.exp_shape)}I",
                               *ref.shape, *ref.exp_shape),
                   meta_b, ref.exponents.astype(np.int8).tobytes(),
                   ref.payload])
    old = packed.PackedBFP.from_bytes(v1)
    assert old.stored_crc is None and not old.variable
    assert old.verify() is old
    _same_block(_unpack(old), blk)
    assert old.to_bytes() == ref.to_bytes()       # re-written as v2


# ---------------------------------------------------------------------------
# Param trees: every container byte-identical to repro's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=TREE_MODELS)
def tree_model(request):
    """(name, numpy params, repro's packed trees per (policy, variable)).
    Under PALLAS_TILED (few reduced-model K are multiples of 128) the
    fixed tree comes from repro's own float walk; the others from its
    jitted prequantization, packed as-is (the bound-plan flow) — its
    eager prequantization compiles op by op."""
    name = request.param
    params = jax_params(name)
    want = {}
    for label, (_, jpol) in TREE_POLICIES.items():
        qtree = jax.jit(lambda p: jpq.quantize_cnn_param_tree(p, jpol))(
            params)
        for variable in (False, True):
            src = params if label == "pallas_tiled" and not variable \
                else qtree
            want[label, variable] = jpk.pack_param_tree(
                src, jpol, "cnn", variable=variable)
    return name, params, want


def _containers(tree, paths_fn):
    out = {}
    for path, leaf in paths_fn(tree):
        if isinstance(leaf, (packed.PackedBFP, jpk.PackedBFP)):
            out[path] = leaf
    return out


def _port_paths(tree):
    leaves = []
    _tree._walk(tree, (), packed.is_packed, leaves)
    return [(_tree.keystr(p), leaf) for p, leaf in leaves]


def _jax_paths(tree):
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=jpk.is_packed)]


@pytest.mark.parametrize("variable", [False, True])
@pytest.mark.parametrize("label", list(TREE_POLICIES))
def test_pack_param_tree_bytes_equal_repro(tree_model, label, variable):
    name, params, want = tree_model
    pol = TREE_POLICIES[label][0]
    tp = params_from_numpy(params, "cpu")
    got = packed.pack_param_tree(tp, pol, "cnn", variable=variable)
    mine = _containers(got, _port_paths)
    ref = _containers(want[label, variable], _jax_paths)
    assert mine.keys() == ref.keys(), (name, sorted(mine), sorted(ref))
    if label == "whole_k":
        assert len(mine) >= 4                       # every conv and fc
    for path in ref:
        assert mine[path].to_bytes() == ref[path].to_bytes(), path
        assert mine[path].variable == variable
    # every other leaf is untouched, Python ints included
    leaves, _ = _tree.flatten(got, is_leaf=packed.is_packed)
    src, _ = _tree.flatten(tp)
    assert len(leaves) == len(src)
    for a, b in zip(leaves, src):
        if not packed.is_packed(a):
            assert a is b
    # and the packed tree binds to the plan the float tree binds to
    if label == "whole_k":
        a, b = (EG.bind(x, pol, tree="cnn", device="cpu").params
                for x in (got, tp))
        for x, y in zip(_tree.flatten(a)[0], _tree.flatten(b)[0]):
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y)


def test_pack_param_tree_packs_bound_sidecars_as_is():
    tp = MODELS["lenet"].init(torch.Generator().manual_seed(0),
                              device="cpu")
    plan = EG.bind(tp, POL, tree="cnn", device="cpu")
    a = packed.pack_param_tree(tp, POL, "cnn")
    b = packed.pack_param_tree(plan.params, POL, "cnn")
    pa, pb = _containers(a, _port_paths), _containers(b, _port_paths)
    assert pa.keys() == pb.keys() and len(pa) == 4
    assert all(pa[k].to_bytes() == pb[k].to_bytes() for k in pa)


def test_pack_param_tree_needs_policy_and_a_cnn_kind():
    params = MODELS["lenet"].init(torch.Generator().manual_seed(0),
                                  device="cpu")
    with pytest.raises(ValueError, match="BFPPolicy or PolicyMap"):
        packed.pack_param_tree(params, None)
    with pytest.raises(ValueError, match="kind"):
        packed.pack_param_tree(params, POL, kind="nope")
    # an LM tree (detected by its "embed"): GEMM weights pack, the
    # embedding stays float
    lm = {"embed": {"e": torch.zeros(4, 2)},
          "lm_head": {"w": torch.randn(64, 8, generator=torch.Generator())}}
    pk = packed.pack_param_tree(lm, POL)
    assert packed.is_packed(pk["lm_head"]["w"])
    assert pk["embed"]["e"] is lm["embed"]["e"]
    assert packed.pack_param_tree(lm, POL, kind="lm")["lm_head"]["w"] \
        .to_bytes() == pk["lm_head"]["w"].to_bytes()


def test_pack_param_tree_leaves_non_gemm_leaves_alone():
    params = MODELS["resnet18"].init(torch.Generator().manual_seed(0),
                                     device="cpu")
    pk = packed.pack_param_tree(params, POL, "cnn")
    paths = {p for p, leaf in _port_paths(pk) if packed.is_packed(leaf)}
    assert paths and all(p.endswith("['w']") for p in paths)
    assert pk["meta"] == params["meta"]
    assert pk["stem"]["bn"]["gamma"] is params["stem"]["bn"]["gamma"]


# ---------------------------------------------------------------------------
# Container hygiene (tests/test_packed.py, tests/test_packed_v2.py)
# ---------------------------------------------------------------------------

def test_container_rejects_garbage_and_truncation():
    p = packed.pack_block(bfp.quantize(t(normal((4, 16))), 8, (1,)))
    buf = p.to_bytes()
    with pytest.raises(ValueError, match="magic"):
        packed.PackedBFP.from_bytes(b"NOPE" + buf[4:])
    with pytest.raises(ValueError, match="version"):
        packed.PackedBFP.from_bytes(buf[:4] + bytes([99]) + buf[5:])
    with pytest.raises(ValueError, match="truncated"):
        packed.PackedBFP.from_bytes(buf[:-3])
    for cut in (3, 10, 14, 20, len(buf) // 2, len(buf) - 1):
        with pytest.raises(ValueError,
                           match=r"(offset|magic|fixed header)"):
            packed.PackedBFP.from_bytes(buf[:cut])
    hacked = bytearray(buf)
    struct.pack_into("<I", hacked, 8, 2 ** 20)
    with pytest.raises(ValueError, match="offset"):
        packed.PackedBFP.from_bytes(bytes(hacked))
    assert p.nbytes == len(buf)
    assert packed.packed_nbytes(p.shape, p.exp_shape, p.bits,
                                meta_len=len(json.dumps(p.meta))) == len(buf)
    # a corrupted data byte trips the CRC
    bad = bytearray(buf)
    bad[-1] ^= 0x10
    with pytest.raises(packed.IntegrityError, match="checksum mismatch"):
        packed.PackedBFP.from_bytes(bytes(bad))
    assert packed.PackedBFP.from_bytes(bytes(bad), verify=False).shape == \
        p.shape


def test_bitstream_chunking_crosses_boundaries_bit_exact():
    n = packed._CHUNK * 2 + 12345
    rng = np.random.default_rng(0)
    for bits in (5, 8, 11):
        lim = 2 ** (bits - 1) - 1
        m = rng.integers(-lim, lim + 1, size=n).astype(np.int32)
        payload = packed._pack_bits(m, bits)
        assert payload == jpk._pack_bits(m, bits)
        np.testing.assert_array_equal(packed._unpack_bits(payload, n, bits),
                                      m)


def test_range_checks_refuse_lossy_packs():
    blk = BFPBlock(mantissa=torch.full((2, 4), 100, dtype=torch.int8),
                   exponent=torch.zeros((2, 1), dtype=torch.int32), bits=4)
    with pytest.raises(ValueError, match="mantissa outside"):
        packed.pack_block(blk)
    blk = BFPBlock(mantissa=torch.zeros((1, 8), dtype=torch.int8),
                   exponent=torch.full((1, 1), -150, dtype=torch.int32),
                   bits=8)
    with pytest.raises(ValueError, match="int8 range"):
        packed.pack_block(blk)
    d = {"m": torch.ones((4, 2), dtype=torch.int8),
         "s": torch.full((2, 2), 0.3)}
    with pytest.raises(ValueError, match="powers of two"):
        packed.pack_prequant(d, 8)


def _adversarial_container():
    m = torch.zeros((2, 16), dtype=torch.int8)
    m[0, 3] = 127                              # widths [8, 1]
    blk = BFPBlock(mantissa=m, exponent=torch.zeros((2, 1),
                                                    dtype=torch.int32),
                   bits=8)
    return packed.pack_block(blk, variable=True)


def test_variable_width_adversarial_blocks():
    p = packed.pack_block(bfp.quantize(torch.zeros(4, 32), 8, (1,)),
                          variable=True)
    assert int(p.widths.max()) == 1 and len(p.payload) == 16
    p = _adversarial_container()
    assert p.widths.reshape(-1).tolist() == [8, 1]
    assert len(p.payload) == -(-(16 * 8 + 16) // 8)
    sign = torch.tensor([[-1, 1, 0, -1], [1, 1, -1, 0]], dtype=torch.int8)
    q = packed.pack_block(BFPBlock(sign, torch.zeros((2, 1),
                                                     dtype=torch.int32), 8),
                          variable=True)
    assert int(q.widths.max()) == 2
    # exponents at the int8 extremes, through a block and a sidecar
    m = torch.tensor([[3, -7], [100, 1]], dtype=torch.int8)
    e = torch.tensor([[-128], [127]], dtype=torch.int32)
    r = packed.PackedBFP.from_bytes(packed.pack_block(
        BFPBlock(m, e, 8), variable=True).to_bytes())
    assert r.exponents.reshape(-1).tolist() == [-128, 127]
    s = torch.from_numpy(np.ldexp(1.0, np.array([[-134], [121]])).astype(
        np.float32))
    pp = packed.pack_prequant({"m": m, "s": s}, 8, variable=True)
    back = packed.unpack_prequant(packed.PackedBFP.from_bytes(
        pp.to_bytes()), device="cpu")
    assert back["m"].dtype == torch.int8
    assert torch.equal(back["m"], m) and torch.equal(back["s"], s)


def test_width_plane_corruption_raises_integrity_error():
    p = _adversarial_container()
    off = _width_plane_off(p)
    for bad in (0, 200):                       # out of range
        buf = bytearray(p.to_bytes())
        buf[off + 1] = bad
        with pytest.raises(packed.IntegrityError,
                           match=rf"width plane corrupt: block 1 .*"
                                 rf"byte offset {off + 1}"):
            packed.PackedBFP.from_bytes(bytes(buf))
    with pytest.raises(packed.IntegrityError,
                       match=rf"width plane needs 2 bytes at offset {off}"):
        packed.PackedBFP.from_bytes(p.to_bytes()[:off + 1])
    with pytest.raises(packed.IntegrityError,
                       match="variable-width bitstream"):
        packed.PackedBFP.from_bytes(p.to_bytes()[:-1])
    buf = bytearray(p.to_bytes())              # in range, widened
    buf[off + 1] = 8
    with pytest.raises(packed.IntegrityError,
                       match="variable-width bitstream"):
        packed.PackedBFP.from_bytes(bytes(buf))
    buf = bytearray(p.to_bytes())              # in range, narrowed: CRC
    buf[off] = 1
    with pytest.raises(packed.IntegrityError, match="checksum mismatch"):
        packed.PackedBFP.from_bytes(bytes(buf))
    with pytest.raises(ValueError, match="width plane shape"):
        packed.PackedBFP(bits=8, shape=p.shape, exp_shape=p.exp_shape,
                         exponents=p.exponents, payload=p.payload,
                         widths=np.ones((3, 1), np.uint8))
    with pytest.raises(ValueError, match=r"outside the legal \[1, 8\]"):
        packed.PackedBFP(bits=8, shape=p.shape, exp_shape=p.exp_shape,
                         exponents=p.exponents, payload=p.payload,
                         widths=np.full((2, 1), 9, np.uint8))


def test_fixed_width_writes_v2_and_variable_v3():
    blk = bfp.quantize(t(normal((6, 24), seed=3)), 8, (1,))
    assert packed.pack_block(blk).to_bytes()[4] == 2
    assert packed.pack_block(blk, variable=True).to_bytes()[4] == 3


# ---------------------------------------------------------------------------
# Properties (the generated sweeps of tests/test_packed_v2.py, on the port,
# and the byte identity with repro as a property)
# ---------------------------------------------------------------------------

_SHAPES = ((3, 7), (5, 13), (1, 17), (16, 16), (7, 1), (2, 63), (31, 2))
_SCHEMES = (Scheme.EQ2, Scheme.EQ3, Scheme.EQ4, Scheme.EQ5)


@settings(max_examples=40, deadline=None)
@given(bits=st.integers(4, 12), si=st.integers(0, len(_SHAPES) - 1),
       ci=st.integers(0, len(_SCHEMES) - 1), seed=st.integers(0, 10_000),
       operand=st.sampled_from(["w", "i"]))
def test_variable_roundtrip_lossless_and_equal_to_repro(bits, si, ci, seed,
                                                        operand):
    w = normal(_SHAPES[si], seed=seed)
    blk = bfp.bfp_quantize_matrix(t(w), bits, operand, _SCHEMES[ci])
    p = packed.pack_block(blk, variable=True)
    buf = p.to_bytes()
    assert p.nbytes == len(buf)
    _same_block(_unpack(packed.PackedBFP.from_bytes(buf)), blk)
    ref = jpk.pack_block(jbfp.bfp_quantize_matrix(
        jnp.asarray(w), bits, operand, _jscheme(_SCHEMES[ci])),
        variable=True)
    assert buf == ref.to_bytes()


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 10_000), bits=st.integers(4, 12),
       tenths=st.integers(0, 10))
def test_variable_bytes_bounded_and_sparsity_shrinks(seed, bits, tenths):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((24, 32)).astype(np.float32)
    w[rng.random((24, 32)) < tenths / 10] = 0.0
    blk = bfp.quantize(t(w), bits, (1,))
    pf = packed.pack_block(blk)
    pv = packed.pack_block(blk, variable=True)
    assert len(pv.payload) <= len(pf.payload)
    assert pv.nbytes <= pf.nbytes + pv.exponents.size
    if tenths == 10:
        assert int(pv.widths.max()) == 1
    _same_block(_unpack(pf), _unpack(pv))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 10_000), cut=st.integers(0, 1 << 30))
def test_any_truncation_raises(seed, cut):
    p = packed.pack_matrix(t(normal((6, 24), seed=seed)), 8, "w",
                           Scheme.EQ2, variable=True)
    buf = p.to_bytes()
    k = 1 + cut % (len(buf) - 1)               # any strict prefix
    with pytest.raises(ValueError):            # IntegrityError included
        packed.PackedBFP.from_bytes(buf[:k])


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 10_000), pos=st.integers(0, 1 << 30),
       flip=st.integers(1, 255))
def test_any_plane_or_payload_corruption_raises_integrity_error(seed, pos,
                                                                flip):
    p = packed.pack_matrix(t(normal((6, 24), seed=seed)), 8, "w",
                           Scheme.EQ2, variable=True)
    buf = bytearray(p.to_bytes())
    start = _width_plane_off(p) - p.exponents.size  # exponent plane on
    idx = start + pos % (len(buf) - start)
    buf[idx] ^= flip
    with pytest.raises(packed.IntegrityError):
        packed.PackedBFP.from_bytes(bytes(buf))
