"""The port's LM (``models.lm``: dense, vlm, moe) against ``repro`` with
float weights and no BFP policy, on the same params (exported from a
jitted ``repro`` init).

The reference's float math runs on XLA:CPU, the port's on PyTorch's CPU
kernels; their reductions (RMSNorm's mean, softmax, the attention and
linear GEMMs) sum in different orders and ``sin``/``cos``/``exp`` may
differ in the last place, so the outputs agree to a float-reduction
tolerance, not bit for bit: ``FLOAT_TOL`` = 1e-5 of the largest
|logit|, ``AUX_TOL`` = 1e-6 for the MoE load-balance loss.  Decode runs
twice: with f32 caches (``FLOAT_TOL``), and with the serving bf16
caches, where an f32-ulp difference in a k or v that sits on a bf16
rounding boundary becomes a one-bf16-ulp difference in the cache
(``CACHE_TOL`` = 2^-8 of the largest |k|, |v|) and ``BF16_TOL`` = 2^-8
of the largest |logit| in the steps that read it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import common as RC
from repro.models.lm import model as RM
from repro.models.lm import moe as RMOE
from repro_torch import _tree
from repro_torch.models.lm import common as PC
from repro_torch.models.lm import model as PM
from repro_torch.models.lm import moe as PMOE
from test_torch_util import normal, t
from torch_lm_common import (ARCH7, ARCH10, cfgs, max_rel, port_params,
                             ref_params_np, tokens)

FLOAT_TOL = 1e-5
AUX_TOL = 1e-6
CACHE_TOL = BF16_TOL = 2.0 ** -8


def _ref_decode(cfg, params, toks, max_len, f32=False):
    """The reference's decode steps over ``toks`` [B, S] from a fresh
    cache (bf16, or f32), one jitted scan: (logits per step [S, B, V],
    final cache)."""
    def run(p, tk):
        cache = RM.init_cache(cfg, tk.shape[0], max_len,
                              jnp.float32 if f32 else jnp.bfloat16)

        def body(c, i):
            lg, c = RM.decode_step(p, cfg, c, jax.lax.dynamic_slice_in_dim(
                tk, i, 1, 1), i.astype(jnp.int32))
            return c, lg[:, 0]
        cache, lgs = jax.lax.scan(body, cache, jnp.arange(tk.shape[1]))
        return lgs, cache
    lgs, cache = jax.jit(run)(params, toks)
    return np.asarray(lgs), {k: np.asarray(v.astype(jnp.float32))
                             for k, v in cache.items()}


def _port_decode(cfg, params, toks, max_len, f32=False):
    dtype = torch.float32 if f32 else torch.bfloat16
    cache = PM.init_cache(cfg, toks.shape[0], max_len, dtype, device="cpu")
    before = {k: v.clone() for k, v in cache.items()}
    lgs = []
    tk = torch.from_numpy(toks)
    for i in range(toks.shape[1]):
        old = cache
        lg, cache = PM.decode_step(params, cfg, cache, tk[:, i:i + 1], i)
        assert cache["k"] is not old["k"]            # out of place
        lgs.append(lg[:, 0])
    assert all(torch.equal(before[k], v) for k, v in
               PM.init_cache(cfg, toks.shape[0], max_len,
                             device="cpu").items())
    assert cache["k"].dtype == dtype
    return torch.stack(lgs), {k: v.float() for k, v in cache.items()}


@pytest.mark.parametrize("arch", ARCH7)
def test_forward_and_decode_float(arch):
    rcfg, pcfg = cfgs(arch)
    rp, pp = ref_params_np(arch), port_params(arch)
    assert PM.param_count(pp) == sum(np.asarray(v).size for v in
                                     jax.tree_util.tree_leaves(rp))
    toks = tokens(2, 12, rcfg.vocab_size, seed=1)
    rlog, raux = jax.jit(lambda p, tk: RM.forward(p, rcfg, tk))(rp, toks)
    plog, paux = PM.forward(pp, pcfg, torch.from_numpy(toks))
    assert plog.shape == (2, 12, rcfg.vocab_size)
    assert max_rel(plog, rlog) <= FLOAT_TOL
    assert abs(float(paux) - float(raux)) <= AUX_TOL
    if rcfg.is_moe:
        assert float(paux) > 0.0

    rl, rc = _ref_decode(rcfg, rp, toks[:, :8], 16, f32=True)
    pl, pc = _port_decode(pcfg, pp, toks[:, :8], 16, f32=True)
    assert max_rel(pl, rl) <= FLOAT_TOL
    for k in ("k", "v"):
        assert max_rel(pc[k], rc[k]) <= FLOAT_TOL
    rl, rc = _ref_decode(rcfg, rp, toks[:, :8], 16)
    pl, pc = _port_decode(pcfg, pp, toks[:, :8], 16)
    assert max_rel(pl, rl) <= BF16_TOL
    for k in ("k", "v"):
        assert max_rel(pc[k], rc[k]) <= CACHE_TOL


def test_sliding_window_ring_buffer_and_chunked_swa():
    """mixtral's sliding window: the decode ring buffer wrapping (window
    4, 8 steps) and ``_swa_chunked`` (s = 256 > 2w at the reduced
    window 64, s % w == 0)."""
    arch = "mixtral-8x7b"
    rcfg, pcfg = cfgs(arch)
    rp, pp = ref_params_np(arch), port_params(arch)
    assert pcfg.sliding_window == 64
    toks = tokens(1, 256, rcfg.vocab_size, seed=2)
    rlog, _ = jax.jit(lambda p, tk: RM.forward(p, rcfg, tk))(rp, toks)
    plog, _ = PM.forward(pp, pcfg, torch.from_numpy(toks))
    assert max_rel(plog, rlog) <= FLOAT_TOL
    r4 = dataclasses.replace(rcfg, sliding_window=4)
    p4 = dataclasses.replace(pcfg, sliding_window=4)
    toks = tokens(2, 8, rcfg.vocab_size, seed=3)
    rl, rc = _ref_decode(r4, rp, toks, 32, f32=True)
    pl, pc = _port_decode(p4, pp, toks, 32, f32=True)
    assert pc["k"].shape[2] == 4
    assert max_rel(pl, rl) <= FLOAT_TOL
    assert max_rel(pc["v"], rc["v"]) <= FLOAT_TOL


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-vl-2b"])
def test_flash_path(arch, monkeypatch):
    """The online-softmax path, reached by lowering ``FLASH_THRESHOLD``
    on both sides (s = 16 >= 8: one padded chunk), and ``_flash_sdpa``
    itself over several chunks (chunk 8, s = 20), causal and not."""
    monkeypatch.setattr(RC, "FLASH_THRESHOLD", 8)
    monkeypatch.setattr(PC, "FLASH_THRESHOLD", 8)
    rcfg, pcfg = cfgs(arch)
    toks = tokens(2, 16, rcfg.vocab_size, seed=4)
    rlog, _ = jax.jit(lambda p, tk: RM.forward(p, rcfg, tk))(
        ref_params_np(arch), toks)
    plog, _ = PM.forward(port_params(arch), pcfg, torch.from_numpy(toks))
    assert max_rel(plog, rlog) <= FLOAT_TOL
    q = normal((2, 20, 4, 16), 5)
    k, v = normal((2, 20, 2, 16), 6), normal((2, 20, 2, 16), 7)
    for causal in (True, False):
        want = jax.jit(lambda a, b, c: RC._flash_sdpa(
            a, b, c, rcfg, causal, chunk=8))(q, k, v)
        got = PC._flash_sdpa(t(q), t(k), t(v), pcfg, causal, chunk=8)
        assert max_rel(got, want) <= FLOAT_TOL


def test_mrope_position_streams():
    """qwen2-vl's M-RoPE with three different position streams (the
    vision-patch layout) against the reference, and text positions equal
    to standard RoPE."""
    arch = "qwen2-vl-2b"
    rcfg, pcfg = cfgs(arch)
    assert pcfg.mrope_sections == rcfg.mrope_sections == (4, 2, 2)
    toks = tokens(2, 10, rcfg.vocab_size, seed=8)
    pos3 = np.stack([np.tile(np.arange(10), (2, 1)) // d
                     for d in (1, 2, 3)]).astype(np.int32)
    rlog, _ = jax.jit(lambda p, tk, ps: RM.forward(p, rcfg, tk, ps))(
        ref_params_np(arch), toks, pos3)
    plog, _ = PM.forward(port_params(arch), pcfg, torch.from_numpy(toks),
                         torch.from_numpy(pos3))
    assert max_rel(plog, rlog) <= FLOAT_TOL
    x = t(normal((2, 10, 4, 16), 9))
    p2 = torch.arange(10)[None].expand(2, 10)
    assert torch.allclose(PC.mrope(x, p2[None].expand(3, 2, 10), 1e4,
                                   (4, 2, 2)), PC.rope(x, p2, 1e4))


def test_moe_layer_float_and_capacity_drops():
    """``moe_apply`` alone at a capacity factor that drops tokens: the
    same drops (stable sort, capacity in Python float), the ordered
    combine, the aux loss."""
    rcfg, pcfg = cfgs("olmoe-1b-7b", d_model=32, d_ff=16)
    rcfg = dataclasses.replace(rcfg, capacity_factor=0.25)
    pcfg = dataclasses.replace(pcfg, capacity_factor=0.25)
    p = jax.jit(lambda k: RMOE.moe_init(k, rcfg))(jax.random.PRNGKey(3))
    p = jax.tree_util.tree_map(np.asarray, p)
    pt = {"router": {"w": t(p["router"]["w"])},
          **{n: t(p[n]) for n in ("w1", "w2", "w3")}}
    x = normal((2, 8, 32), 10)
    want, waux = jax.jit(lambda pp, xx: RMOE.moe_apply(pp, rcfg, xx))(p, x)
    got, gaux = PMOE.moe_apply(pt, pcfg, t(x))
    assert max_rel(got, want) <= FLOAT_TOL
    assert abs(float(gaux) - float(waux)) <= AUX_TOL
    # some tokens were dropped: their rows see fewer than top_k experts
    full = dataclasses.replace(pcfg, capacity_factor=float(pcfg.n_experts))
    assert not torch.allclose(PMOE.moe_apply(pt, full, t(x))[0], got)


def test_top_k_ties_take_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, ids = PMOE._top_k(probs, 2)
    rv, ri = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert ids.tolist() == np.asarray(ri).tolist() == [[0, 1], [1, 3]]
    assert np.array_equal(vals.numpy(), np.asarray(rv))


def test_init_params_shapes_and_unported_families():
    """The port's own seeded init has the reference's tree and shapes for
    all ten architectures: the attention families and, ported since, the
    recurrent families (rwkv6, the hybrid's empty period stack and
    ``rem`` list at 2 layers) and the encoder-decoder; so does the
    decode cache (paths, shapes, dtypes)."""
    gen = torch.Generator().manual_seed(0)
    for arch in ARCH10:
        rcfg, pcfg = cfgs(arch)
        shapes = jax.eval_shape(lambda k: RM.init_params(rcfg, k),
                                jax.random.PRNGKey(0))
        want = [(jax.tree_util.keystr(pth), tuple(s.shape)) for pth, s in
                jax.tree_util.tree_leaves_with_path(shapes)]
        got = [(_tree.keystr(pth), tuple(v.shape)) for pth, v in
               _tree.leaves_with_path(PM.init_params(pcfg, gen,
                                                     device="cpu"))]
        assert got == want, arch
        cache = jax.eval_shape(lambda: RM.init_cache(rcfg, 2, 8))
        want = [(jax.tree_util.keystr(pth), tuple(s.shape), str(s.dtype))
                for pth, s in jax.tree_util.tree_leaves_with_path(cache)]
        got = [(_tree.keystr(pth), tuple(v.shape),
                str(v.dtype).split(".")[-1]) for pth, v in
               _tree.leaves_with_path(PM.init_cache(pcfg, 2, 8,
                                                    device="cpu"))]
        assert got == want, arch
