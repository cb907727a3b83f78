"""``ops.bfp_quantize`` without padding, against ``repro``'s padded call.

``repro``'s ``ops.bfp_quantize`` pads rows to ``aligned_tile(M, 256)``
and K to a ``block_k`` multiple before ``bfp_quantize_pallas`` and
slices back.  The port hands x to the kernel wrapper as it is: rows are
independent, the CUDA kernel masks the ragged last K-tile itself and the
plain version zero-pads K on its own.  Here the unpadded call is held
bit-equal to ``repro``'s (Pallas in interpret mode) at M = 1000 (which
``repro`` pads to 1024), ragged K (2047, 147), blocks 32, 128 and 512 and
L 4, 8 and 12, with zero, NaN, inf and -inf blocks; subnormal-amax
blocks against numpy (XLA:CPU flushes subnormals); and the wrapper is
shown to receive x itself, unpadded.
"""
import jax
import numpy as np
import pytest

from repro.kernels import ops as jops
from repro_torch.kernels import bfp_quantize as KQ
from repro_torch.kernels import launch_counts, ops
from test_torch_util import assert_bits_equal, q_inputs, t, to_numpy_tree

# (M, K, bk, bits): M = 1000 and ragged K with every block at every L
LEAN_CASES = [(1000, 2047, 128, 8), (1000, 147, 32, 4), (33, 2047, 512, 12),
              (1000, 147, 512, 8), (40, 2047, 32, 12), (17, 147, 128, 4),
              (1000, 512, 32, 8), (6, 2047, 128, 12), (300, 147, 512, 4)]
IDS = [f"M{c[0]}K{c[1]}bk{c[2]}L{c[3]}" for c in LEAN_CASES]


@pytest.fixture(scope="module")
def refs():
    """``repro``'s padded wrapper (Pallas, interpret mode) on every case,
    in one compiled program."""
    xs = [q_inputs(c) for c in LEAN_CASES]

    def ref_fn(xs):
        return [jops.bfp_quantize(x, bits, bk, interpret=True)
                for (_, _, bk, bits), x in zip(LEAN_CASES, xs)]

    return to_numpy_tree(jax.jit(ref_fn)(xs))


@pytest.mark.parametrize("i", range(len(LEAN_CASES)), ids=IDS)
def test_unpadded_call_matches_the_padded_pallas_call(refs, i):
    m, k, bk, bits = LEAN_CASES[i]
    want_m, want_e = refs[i]
    got_m, got_e = ops.bfp_quantize(t(q_inputs(LEAN_CASES[i])), bits, bk)
    assert tuple(got_m.shape) == (m, k)
    assert tuple(got_e.shape) == (m, -(-k // bk))
    assert_bits_equal(got_m, want_m)
    assert_bits_equal(got_e, want_e)


@pytest.mark.parametrize("i", range(len(LEAN_CASES)), ids=IDS)
def test_zero_nan_and_inf_blocks_keep_bfp_quantize_rules(i):
    """Rows 0-3 of every case: the zero block (e -126, mantissas 0), the
    NaN block (e -126, NaN -> 0, NOT zeroed: the rest saturate), the inf
    block in the last K-tile (e 128) and the -inf block."""
    m, k, bk, bits = LEAN_CASES[i]
    got_m, got_e = ops.bfp_quantize(t(q_inputs(LEAN_CASES[i])), bits, bk)
    lim = 2 ** (bits - 1) - 1              # then saturated to int8
    hi, lo = min(lim, 127), max(-lim, -128)
    assert got_e[0, 0] == -126 and not got_m[0, :min(bk, k)].any()
    assert got_e[1, 0] == -126 and got_m[1, 3] == 0
    others = got_m[1, :min(bk, k)].tolist()
    assert set(others[:3] + others[4:]) <= {hi, lo}
    assert got_e[2, -1] == 128 and got_m[2, -1] == hi
    assert bool((got_m[3, :min(bk, k)] == lo).all())


@pytest.mark.parametrize("k,bk", [(2047, 128), (147, 32), (40, 512)])
def test_subnormal_amax_blocks_against_numpy(k, bk):
    """A subnormal amax gives e = -127 and a subnormal step; the ragged
    last K-tile too.  (numpy is the oracle: XLA:CPU flushes them.)"""
    x = np.zeros((1000, k), np.float32)
    rng = np.random.default_rng(k)
    x[::3] = rng.uniform(-1e-39, 1e-39, (len(x[::3]), k)).astype(np.float32)
    got_m, got_e = ops.bfp_quantize(t(x), 8, bk)
    n_t = -(-k // bk)
    xp = np.pad(x, ((0, 0), (0, n_t * bk - k))).reshape(1000, n_t, bk)
    amax = np.abs(xp).max(axis=2)
    e = np.where(amax > 0, (amax.view(np.int32) >> 23) - 127, -126)
    assert e[::3].max() == -127
    step = np.ldexp(np.float32(1.0), e - 6).astype(np.float32)[..., None]
    want = np.clip(np.round(xp / step), -127, 127).astype(np.int8)
    assert_bits_equal(got_e, e.astype(np.int32))
    assert_bits_equal(got_m, want.reshape(1000, n_t * bk)[:, :k])


def test_ops_hands_x_to_the_kernel_wrapper_unpadded(monkeypatch):
    """One wrapper call per ``ops`` call, on x itself: no padded copy of
    rows (1000, which repro pads to 1024) or K (2047), no slice after."""
    seen = []
    real = KQ.bfp_quantize

    def spy(x, **kw):
        seen.append((x, kw))
        return real(x, **kw)

    monkeypatch.setattr(KQ, "bfp_quantize", spy)
    x = t(q_inputs((1000, 2047, 128, 8)))
    before = launch_counts()["bfp_quantize"]
    m, e = ops.bfp_quantize(x, 8, 128)
    assert len(seen) == 1 and seen[0][0] is x
    assert seen[0][1] == {"bits": 8, "bk": 128}
    assert m.shape == (1000, 2047) and m.is_contiguous()
    assert e.shape == (1000, 16) and e.is_contiguous()
    assert launch_counts()["bfp_quantize"] == before     # CPU: no kernel
