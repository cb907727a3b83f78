"""The port's Griffin / recurrentgemma (``models.lm.griffin`` and the
hybrid branch of ``models.lm.model``) against ``repro`` on the same
params (exported from jitted ``repro`` inits) and numpy inputs.

The RG-LRU's associative scan is the reference's recursion with its
fused multiply-adds, bit for bit.  Everything else in float agrees to
``FLOAT_TOL`` = 1e-5 of the largest |output|: ``sigmoid``, ``tanh``,
``exp`` and ``log1p`` differ in the last place between XLA:CPU and
PyTorch (and XLA contracts the conv's sum of products into fused
multiply-adds in an order of its own), measured at 2e-7 of the largest
|output| per block.  Decode runs with f32 caches for the tolerance, and
with the serving bf16 cache for the dtypes (trap: the bf16 conv history
comes back f32 from the first step, in both packages).

The three layouts of the hybrid: 2 layers (no (rec, rec, attn) period,
leaves ``[0, ...]``, and a remainder of two rec blocks), 3 (one period,
no remainder: a remainder cache of ``[0, B, ...]``) and 5 (both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import griffin as RG
from repro.models.lm import model as RM
from repro_torch import _tree
from repro_torch.models.lm import griffin as PG
from repro_torch.models.lm import model as PM
from test_torch_util import assert_bits_equal, normal, t
from torch_lm_common import (check_bfp_logits, check_sites_against_repro,
                             cfgs, max_rel, port_bfp_run, port_params,
                             ref_bfp_logits, ref_params_np, site_groups,
                             tokens)

FLOAT_TOL = 1e-5
ARCH = "recurrentgemma-9b"
LAYOUTS = (2, 3, 5)
B, S, LW = 2, 12, 64


def _rec0(tree):
    """The first remainder block's RG-LRU params (5-layer tree)."""
    return tree["rem"][0]["rec"]


@pytest.fixture(scope="module")
def ref():
    """Every reference output of this file from one jitted call."""
    rcfg = {n: cfgs(ARCH, n_layers=n)[0] for n in LAYOUTS}
    toks = tokens(B, S, 256, seed=1)
    x, x1 = normal((B, S, LW), seed=1), normal((B, 1, LW), seed=2)
    h0, hist = normal((B, LW), seed=3), normal((B, 3, LW), seed=4)
    c5 = rcfg[5]

    def run(ps):
        rp = _rec0(ps[5])
        u = RG.linear(rp["in_x"], x)
        out = {"conv": RG._causal_conv(rp["conv_w"], rp["conv_b"], u),
               "conv_hist": RG._causal_conv(rp["conv_w"], rp["conv_b"], u,
                                            hist),
               "rglru": RG._rglru(rp, x, h0, None),
               "block": RG.rglru_block(rp, c5, x, (h0, hist)),
               "block_dec": RG.rglru_block_decode(rp, c5, x1, (h0, hist))}
        for n in LAYOUTS:
            cfg, p = rcfg[n], ps[n]
            out[f"logits{n}"] = RM.forward(p, cfg, toks)[0]

            def body(c, i, p=p, cfg=cfg):
                lg, c = RM.decode_step(p, cfg, c, jax.lax.dynamic_slice_in_dim(
                    toks, i, 1, 1), i.astype(jnp.int32))
                return c, lg[:, 0]
            out[f"cache{n}"], out[f"dec{n}"] = jax.lax.scan(
                body, RM.init_cache(cfg, B, 16, jnp.float32), jnp.arange(8))
        return out

    ps = {n: ref_params_np(ARCH, n_layers=n) for n in LAYOUTS}
    out = jax.tree_util.tree_map(np.asarray, jax.jit(run)(ps))
    return out, dict(toks=toks, x=x, x1=x1, h0=h0, hist=hist)


@pytest.mark.parametrize("n", [1, 2, 7, 12, 33])
def test_associative_scan_bit_equal(n):
    """The RG-LRU's scan against ``jax.lax.associative_scan`` of the same
    combine, bit for bit, at odd and even lengths."""
    a = np.random.default_rng(n).uniform(0.5, 1.0, (B, n, 8)).astype(
        np.float32)
    b = normal((B, n, 8), seed=n)
    want = jax.jit(lambda a, b: jax.lax.associative_scan(
        lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]), (a, b),
        axis=1))(a, b)
    got = PG.associative_scan(PG._combine, [t(a), t(b)], dim=1)
    for g, w in zip(got, want):
        assert_bits_equal(g, w)


def test_conv_rglru_and_block_forms(ref):
    """``_causal_conv`` (zero and given history), ``_rglru`` from a state,
    and the block's full-sequence and decode forms."""
    out, inp = ref
    pcfg = cfgs(ARCH, n_layers=5)[1]
    rp = _rec0(port_params(ARCH, n_layers=5))
    x, x1, h0, hist = (t(inp[k]) for k in ("x", "x1", "h0", "hist"))
    u = PG.linear(rp["in_x"], x)
    assert max_rel(PG._causal_conv(rp["conv_w"], rp["conv_b"], u),
                   out["conv"]) <= FLOAT_TOL
    assert max_rel(PG._causal_conv(rp["conv_w"], rp["conv_b"], u, hist),
                   out["conv_hist"]) <= FLOAT_TOL
    y, hl = PG._rglru(rp, x, h0, None)
    assert max_rel(y, out["rglru"][0]) <= FLOAT_TOL
    assert max_rel(hl, out["rglru"][1]) <= FLOAT_TOL
    y, (hl, nh) = PG.rglru_block(rp, pcfg, x, (h0, hist))
    assert max_rel(y, out["block"][0]) <= FLOAT_TOL
    assert max_rel(hl, out["block"][1][0]) <= FLOAT_TOL
    assert max_rel(nh, out["block"][1][1]) <= FLOAT_TOL
    y, (hl, nh) = PG.rglru_block_decode(rp, pcfg, x1, (h0, hist))
    assert max_rel(y, out["block_dec"][0]) <= FLOAT_TOL
    assert max_rel(hl, out["block_dec"][1][0]) <= FLOAT_TOL
    assert max_rel(nh, out["block_dec"][1][1]) <= FLOAT_TOL


def _shapes(tree, ref_side):
    if ref_side:
        return [(jax.tree_util.keystr(p), tuple(v.shape), str(v.dtype))
                for p, v in jax.tree_util.tree_leaves_with_path(tree)]
    return [(_tree.keystr(p), tuple(v.shape), str(v.dtype).split(".")[-1])
            for p, v in _tree.leaves_with_path(tree)]


@pytest.mark.parametrize("n", LAYOUTS)
def test_hybrid_layout_forward_cache_and_decode(ref, n):
    """Each layout: the port's own init and the cache have the
    reference's leaves (paths, shapes, dtypes), then forward logits and 8
    decode steps (f32 caches) against the reference."""
    out, inp = ref
    rcfg, pcfg = cfgs(ARCH, n_layers=n)
    n_periods, rem = PM._hybrid_layout(pcfg)
    assert (n_periods, len(rem)) == {2: (0, 2), 3: (1, 0), 5: (1, 2)}[n]
    own = PM.init_params(pcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    want = jax.eval_shape(lambda k: RM.init_params(rcfg, k),
                          jax.random.PRNGKey(0))
    assert _shapes(own, False) == _shapes(want, True)
    assert isinstance(own["rem"], list) and len(own["rem"]) == len(rem)
    for dt in (jnp.float32, jnp.bfloat16):
        tdt = getattr(torch, jnp.dtype(dt).name)
        assert _shapes(PM.init_cache(pcfg, B, 16, tdt, device="cpu"),
                       False) == \
            _shapes(jax.eval_shape(lambda: RM.init_cache(rcfg, B, 16, dt)),
                    True)
    pp = port_params(ARCH, n_layers=n)
    toks = torch.from_numpy(inp["toks"])
    assert max_rel(PM.forward(pp, pcfg, toks)[0], out[f"logits{n}"]) \
        <= FLOAT_TOL
    cache = PM.init_cache(pcfg, B, 16, torch.float32, device="cpu")
    lgs = []
    for i in range(8):
        lg, cache = PM.decode_step(pp, pcfg, cache, toks[:, i:i + 1], i)
        lgs.append(lg[:, 0])
    assert max_rel(torch.stack(lgs), out[f"dec{n}"]) <= FLOAT_TOL
    got = _tree.leaves_with_path(cache)
    want = jax.tree_util.tree_leaves_with_path(out[f"cache{n}"])
    assert [_tree.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape
        if g.numel():
            assert max_rel(g, w) <= FLOAT_TOL


@pytest.mark.parametrize("n", LAYOUTS)
def test_conv_history_dtype_is_promoted_not_rounded(n):
    """The serving bf16 cache: every conv history that a step writes comes
    back f32 (``jnp.concatenate`` promotes; the port does not round it
    back to bf16), an empty remainder keeps its bf16 history, and the
    attention KV stays bf16: the dtypes of ``repro``'s step."""
    rcfg, pcfg = cfgs(ARCH, n_layers=n)
    rc = jax.eval_shape(lambda: RM.init_cache(rcfg, B, 16))
    rstep = jax.eval_shape(
        lambda p, c: RM.decode_step(p, rcfg, c, jnp.zeros((B, 1), jnp.int32),
                                    jnp.int32(0))[1],
        jax.eval_shape(lambda k: RM.init_params(rcfg, k),
                       jax.random.PRNGKey(0)), rc)
    cache = PM.init_cache(pcfg, B, 16, device="cpu")
    assert {str(v.dtype) for v in _tree.flatten(
        {k: v["hist"] for k, v in cache.items() if k != "attn"})[0]} == \
        {"torch.bfloat16"}
    _, stepped = PM.decode_step(port_params(ARCH, n_layers=n), pcfg, cache,
                                torch.zeros((B, 1), dtype=torch.long), 0)
    assert _shapes(stepped, False) == _shapes(rstep, True)
    assert stepped["rec1"]["hist"].dtype == torch.float32
    assert stepped["rem"]["hist"].dtype == (
        torch.float32 if n != 3 else torch.bfloat16)
    assert stepped["attn"]["k"].dtype == torch.bfloat16


def test_bfp_sites_bit_equal_and_logits():
    """PALLAS_TILED (block 32) on the kernel backend at 3 layers (one
    period): each GEMM of a forward and 4 decode steps (8 a recurrent
    block, 7 the attention block, and the tied ``lm_head`` on the float
    ``embed.T``) bit-equal to
    ``repro.engine.gemm``, the logits within the BFP tolerance.  The rec
    linears pass no path, and the tree's site paths ("rec1/rec/in_x",
    "attn/attn/wq") are not the runtime's ("attn/wq"), so those GEMMs
    resolve the policy per call, as in the reference.  The caches are
    f32: the reference's scan over decode steps cannot carry the bf16
    conv history its first step promotes (R8)."""
    plan, events, flog, dlog = port_bfp_run(ARCH, n_layers=3,
                                            f32_cache=True)
    per_pass = 2 * 8 + 7 + 1
    assert len(events) == 5 * per_pass
    assert all(ev.backend == "pallas" and ev.policy is not None
               for ev in events)
    assert "rec1/rec/in_x" in plan.sites and "attn/attn/wq" in plan.sites
    assert sum(ev.path is None for ev in events) == 5 * 2 * 5
    heads = [ev for ev in events if ev.path == "lm_head"]
    assert len(heads) == 5 and not isinstance(heads[0].w, dict)
    groups = site_groups(events, by_shape=True)
    assert sum(map(len, groups.values())) == per_pass
    assert check_sites_against_repro(groups) == len(groups)
    rf, rd = ref_bfp_logits(ARCH, n_layers=3, f32_cache=True)
    check_bfp_logits(flog, rf)
    check_bfp_logits(dlog, rd)
