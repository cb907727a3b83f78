"""``repro_torch.faults`` against ``repro.faults``.

Same seed, same flips: every injector (``derive_rng``,
``flip_payload_bits``, ``flip_exponent_bits``,
``corrupt_container_bytes``, ``perturb_activations``) gives ``repro``'s
bytes, tensors and counts; ``activation_faults`` perturbs each tap event
of a LeNet forward as ``repro`` does (same events, same flips, the same
faulty logits); ``inject_tree`` on reduced ResNet-18's packed tree flips
the same bits in every container (its leaf-path strings are
``repro``'s); ``run_point`` fed ``repro``'s packed tree and images through
``_ctx`` gives its ``n_flips`` and ``top1_agree`` and its ``snr_db``
within 1e-3 dB.  The port's own campaign keeps the hierarchy
``tests/test_faults.py`` pins (exponent >> mantissa MSB >> LSB), and
the injector contracts of that file hold on the port.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JEG
from repro.core import bfp as jbfp
from repro.core import packed as jpk
from repro.core import prequant as jpq
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro.faults import campaign as jcamp
from repro.faults import inject as jinj
from repro.models.cnn import MODELS as JMODELS
from repro_torch import _tree
from repro_torch import engine as EG
from repro_torch.convert import params_from_numpy
from repro_torch.core import bfp, packed
from repro_torch.core.packed import IntegrityError
from repro_torch.core.policy import TPU_TILED
from repro_torch.faults import (activation_faults, corrupt_container_bytes,
                                derive_rng, endurance_campaign,
                                flip_exponent_bits, flip_payload_bits,
                                inject_tree, mean_nsr, perturb_activations,
                                run_point)
from repro_torch.faults import campaign as camp
from repro_torch.models.cnn import MODELS
from test_torch_models_cnn import jax_params
from test_torch_util import assert_bits_equal, normal, t

POL = TPU_TILED.with_(block_k=None, straight_through=False)
J_POL = J_TPU_TILED.with_(block_k=None, straight_through=False)


def _containers(bits=8, shape=(4, 64), variable=False):
    """The same container from each package (equal bytes)."""
    x = normal(shape, seed=bits)
    mine = packed.pack_block(bfp.quantize(t(x), bits, (1,)),
                             variable=variable)
    ref = jpk.pack_block(jbfp.quantize(jnp.asarray(x), bits, (1,)),
                         variable=variable)
    assert mine.to_bytes() == ref.to_bytes()
    return mine, ref


def _port_tree(jtree):
    """repro's packed tree in the port: containers through their bytes,
    arrays as CPU tensors, Python scalars as they are."""
    def conv(node):
        if jpk.is_packed(node):
            return packed.PackedBFP.from_bytes(node.to_bytes())
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return node
    return params_from_numpy(conv(jax.tree_util.tree_map(
        lambda x: x if jpk.is_packed(x) else np.asarray(x), jtree,
        is_leaf=jpk.is_packed)), "cpu")


# ---------------------------------------------------------------------------
# Injectors: repro's bits for the same seed
# ---------------------------------------------------------------------------

def test_derive_rng_streams_equal_repro():
    for seed, keys in ((0, ()), (7, (3,)), (2 ** 33 + 5, ("conv1", 4)),
                       (1, ("['blocks'][0]['c1']['conv']['w']",))):
        a = derive_rng(seed, *keys).integers(0, 2 ** 31, 16)
        b = jinj.derive_rng(seed, *keys).integers(0, 2 ** 31, 16)
        np.testing.assert_array_equal(a, b)
    g = np.random.default_rng(3)
    assert derive_rng(g) is g


@pytest.mark.parametrize("variable", [False, True])
@pytest.mark.parametrize("mode", ["bernoulli", "exact"])
def test_container_flips_equal_repro(mode, variable):
    for bits in (4, 6, 8):
        mine, ref = _containers(bits, variable=variable)
        for bit in (None, 0, bits - 1):
            for ber in (1e-3, 0.05, 1.0):
                a, ka = flip_payload_bits(mine, ber, 11, bit=bit, mode=mode)
                b, kb = jinj.flip_payload_bits(ref, ber, 11, bit=bit,
                                               mode=mode)
                assert ka == kb and a.to_bytes() == b.to_bytes()
        for bit in (None, 0, 7):
            a, ka = flip_exponent_bits(mine, 0.1, 5, bit=bit, mode=mode)
            b, kb = jinj.flip_exponent_bits(ref, 0.1, 5, bit=bit, mode=mode)
            assert ka == kb and a.to_bytes() == b.to_bytes()
        for n in (1, 3, 40):
            assert corrupt_container_bytes(mine, 2, n) == \
                jinj.corrupt_container_bytes(ref, 2, n)
            assert corrupt_container_bytes(mine.to_bytes(), 2, n) == \
                jinj.corrupt_container_bytes(ref.to_bytes(), 2, n)


@pytest.mark.parametrize("bit", [None, 0, 7])
def test_perturb_activations_equal_repro(bit):
    y = normal((2, 9, 7, 5), seed=4)
    y[0, 0] = 0.0
    for bits, block, ber, mode in ((8, 256, 0.01, "bernoulli"),
                                   (6, 64, 0.2, "exact"),
                                   (4, 32, 1.0, "exact")):
        a, ka = perturb_activations(t(y), ber, 3, bits=bits, block=block,
                                    bit=bit, mode=mode)
        b, kb = jinj.perturb_activations(jnp.asarray(y), ber, 3, bits=bits,
                                         block=block, bit=bit, mode=mode)
        assert ka == kb > 0
        assert a.shape == y.shape and a.dtype == torch.float32
        assert_bits_equal(a, np.asarray(b))


@pytest.fixture(scope="module")
def lenet():
    """repro's LeNet (numpy), its packed tree, images and plan."""
    params = jax_params("lenet")
    imgs = normal((3, 28, 28, 1), seed=2)
    qtree = jax.jit(lambda p: jpq.quantize_cnn_param_tree(p, J_POL))(params)
    jtree = jpk.pack_param_tree(qtree, J_POL, "cnn")
    return params, imgs, jtree


def _events(apply, params, x, policy, taps, fault):
    """(path, y) of every event after ``fault``'s transform, the faulty
    logits and the fault stats."""
    seen = []
    with fault as stats, taps(lambda ev: seen.append((ev.path,
                                                      np.asarray(ev.y)))):
        out = apply(params, x, policy)
    return seen, np.asarray(out), stats


def test_activation_faults_flip_each_tap_event_as_repro(lenet):
    params, imgs, _ = lenet
    jplan = JEG.bind(params, J_POL, tree="cnn", prequantize=False)
    tp = params_from_numpy(params, "cpu")
    plan = EG.bind(tp, POL, tree="cnn", device="cpu")
    for seed, kw in ((0, {}), (5, {"bits": 6, "bit": 6, "mode": "exact",
                                   "paths": {"c2", "fc1"}})):
        want, wlog, ws = _events(JMODELS["lenet"].apply, jplan.params, imgs,
                                 jplan, JEG.taps,
                                 jinj.activation_faults(0.02, seed, **kw))
        with torch.no_grad():
            got, glog, gs = _events(MODELS["lenet"].apply, plan.params,
                                    t(imgs), plan, EG.taps,
                                    activation_faults(0.02, seed, **kw))
        assert (gs.events, gs.flips) == (ws.events, ws.flips)
        assert gs.flips > 0 and gs.events == (4 if not kw else 2)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert_bits_equal(a, b)
        assert_bits_equal(glog, wlog)


@pytest.fixture(scope="module")
def resnet_trees():
    """Reduced ResNet-18 packed in repro (list indices and nested
    "conv" in its leaf paths), and the same tree in the port."""
    params = jax_params("resnet18")
    qtree = jax.jit(lambda p: jpq.quantize_cnn_param_tree(p, J_POL))(params)
    jtree = jpk.pack_param_tree(qtree, J_POL, "cnn")
    mine = packed.pack_param_tree(params_from_numpy(params, "cpu"), POL,
                                  "cnn")
    return jtree, mine


@pytest.mark.parametrize("target", ["exponent", "mantissa", "mantissa_msb",
                                    "mantissa_lsb"])
def test_inject_tree_flips_equal_repro(resnet_trees, target):
    jtree, mine = resnet_trees
    for ber, seed in ((1e-3, 0), (2e-2, 9)):
        got, k = inject_tree(mine, target, ber, seed)
        want, kw = jcamp.inject_tree(jtree, target, ber, seed)
        assert k == kw > 0
        a = {_tree.keystr(p): leaf for p, leaf in _paths(got)}
        b = {jax.tree_util.keystr(p): leaf
             for p, leaf in jax.tree_util.tree_leaves_with_path(
                 want, is_leaf=jpk.is_packed) if jpk.is_packed(leaf)}
        assert a.keys() == b.keys() and len(a) == 13
        assert "['blocks'][0]['c1']['conv']['w']" in a
        for p in a:
            assert a[p].to_bytes() == b[p].to_bytes(), p
    # the leaf's generator is keyed by its path string
    p = "['fc']['w']"
    leaf = {_tree.keystr(q): x for q, x in _paths(mine)}[p]
    one, _ = flip_payload_bits(leaf, 1e-3,
                               derive_rng(4, zlib.crc32(p.encode())),
                               mode="exact")
    got, _ = inject_tree(mine, "mantissa", 1e-3, 4)
    assert got["fc"]["w"].payload == one.payload
    with pytest.raises(ValueError, match="target"):
        inject_tree(mine, "activation", 1e-3, 5)


def _paths(tree):
    out = []
    _tree._walk(tree, (), packed.is_packed, out)
    return [(p, x) for p, x in out if packed.is_packed(x)]


@pytest.mark.parametrize("target", ["exponent", "mantissa", "mantissa_msb",
                                    "mantissa_lsb", "activation"])
def test_run_point_through_a_shared_ctx_equals_repro(lenet, target):
    params, imgs, jtree = lenet
    jctx = {"imgs": jnp.asarray(imgs), "packed": jtree,
            "clean": jcamp._logits(JMODELS["lenet"], jtree, J_POL,
                                   jnp.asarray(imgs))}
    ctx = {"imgs": t(imgs), "packed": _port_tree(jtree),
           "clean": camp._logits(MODELS["lenet"], _port_tree(jtree), POL,
                                 t(imgs), torch.device("cpu"))}
    assert_bits_equal(ctx["clean"], jctx["clean"])
    for ber in (1e-3, 1e-2):
        want = jcamp.run_point("lenet", 8, target, ber, 0, _ctx=jctx)
        got = run_point("lenet", 8, target, ber, 0, device="cpu", _ctx=ctx)
        assert got["n_flips"] == want["n_flips"] > 0
        assert got["top1_agree"] == want["top1_agree"]
        assert got["finite"] == want["finite"]
        if np.isfinite(want["snr_db"]):
            assert abs(got["snr_db"] - want["snr_db"]) < 1e-3
        else:
            assert got["snr_db"] == want["snr_db"]
        assert set(got) == set(want)


# ---------------------------------------------------------------------------
# The port's own campaign and the injector contracts (tests/test_faults.py)
# ---------------------------------------------------------------------------

def test_campaign_is_reproducible_and_ordered():
    kw = dict(models=("lenet",), l_values=(8,), bers=(1e-2,),
              targets=("exponent", "mantissa_msb", "mantissa_lsb"),
              seed=0, n_images=2, device="cpu")
    rows1 = endurance_campaign(**kw)
    assert rows1 == endurance_campaign(**kw)
    e = mean_nsr(rows1, target="exponent")
    msb = mean_nsr(rows1, target="mantissa_msb")
    lsb = mean_nsr(rows1, target="mantissa_lsb")
    assert e > msb > lsb
    assert all(r["n_flips"] > 0 for r in rows1)
    one = run_point("lenet", 8, "mantissa_lsb", 1e-2, 0, n_images=2,
                    device="cpu")
    assert one == rows1[2]
    with pytest.raises(ValueError, match="unknown fault target"):
        endurance_campaign(targets=("nope",), device="cpu")
    with pytest.raises(ValueError, match="no campaign rows"):
        mean_nsr(rows1, target="activation")


def test_payload_flips_are_seeded_targeted_and_counted():
    p, _ = _containers()
    a1, k1 = flip_payload_bits(p, 0.01, seed=7)
    a2, k2 = flip_payload_bits(p, 0.01, seed=7)
    b, _ = flip_payload_bits(p, 0.01, seed=8)
    assert a1.payload == a2.payload and k1 == k2
    assert b.payload != a1.payload and p.payload != a1.payload
    _, ke = flip_payload_bits(p, 0.01, seed=7, mode="exact")
    assert ke == round(0.01 * p.n_elements * p.bits)
    q, _ = _containers(bits=6)
    m0 = packed.unpack_block(q, "cpu").mantissa.long()
    lsb, k = flip_payload_bits(q, 1.0, seed=0, bit=0, mode="exact")
    assert k == q.n_elements
    assert bool(((packed.unpack_block(lsb, "cpu").mantissa.long() - m0)
                 .abs() == 1).all())
    msb, _ = flip_payload_bits(q, 1.0, seed=0, bit=q.bits - 1, mode="exact")
    assert bool(((packed.unpack_block(msb, "cpu").mantissa.long() - m0)
                 .abs() == 2 ** (q.bits - 1)).all())
    f, k = flip_exponent_bits(p, 1.0, seed=0, bit=0, mode="exact")
    assert k == p.exponents.size and f.payload == p.payload
    assert np.all(np.abs(f.exponents.astype(np.int64)
                         - p.exponents.astype(np.int64)) == 1)
    with pytest.raises(ValueError, match="bit-error rate"):
        flip_payload_bits(p, 1.5, seed=0)
    with pytest.raises(ValueError, match="bit must be"):
        flip_payload_bits(p, 0.1, seed=0, bit=p.bits)
    with pytest.raises(ValueError, match="mode"):
        flip_exponent_bits(p, 0.1, seed=0, mode="gauss")
    with pytest.raises(ValueError, match="int8 storage"):
        perturb_activations(torch.ones(4), 0.1, 0, bits=9)


def test_flipped_container_fails_verify_but_parses_unverified():
    mine, _ = _containers()
    p = packed.PackedBFP.from_bytes(mine.to_bytes())
    f, k = flip_payload_bits(p, 0.02, seed=1)
    assert k > 0
    with pytest.raises(IntegrityError):
        f.verify()
    raw = corrupt_container_bytes(p, seed=2, n_flips=3)
    with pytest.raises(IntegrityError):
        packed.PackedBFP.from_bytes(raw)
    assert packed.PackedBFP.from_bytes(raw, verify=False).shape == p.shape


def test_activation_faults_leave_the_datapath_clean_outside():
    spec = MODELS["lenet"]
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    x = t(normal((2, 28, 28, 1), seed=1))
    plan = EG.bind(params, POL, tree="cnn", device="cpu")
    with torch.no_grad():
        clean = spec.apply(plan.params, x, plan)
        with activation_faults(0.01, seed=0) as st:
            noisy = spec.apply(plan.params, x, plan)
        # Plan.jit_forward emits no tap event: no fault lands there
        with activation_faults(0.5, seed=0) as st2:
            jitted = plan.jit_forward(spec.apply)(x)
        after = spec.apply(plan.params, x, plan)
    assert st.events == 4 and st.flips > 0 and st2.events == 0
    assert not torch.equal(noisy, clean)
    assert torch.equal(jitted, clean) and torch.equal(after, clean)
