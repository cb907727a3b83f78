"""The port's encoder-decoder (seamless: the enc-dec branches of
``models.lm.model``, ``prefill_encoder``, ``serve.engine.prefill``'s
encoder step and ``generate(enc_feats=)``) against ``repro`` on the same
params (exported from a jitted ``repro`` init) and numpy frames.

Float logits agree to ``FLOAT_TOL`` = 1e-5 of the largest |logit|
(RMSNorm, softmax and RoPE differ in the last place, as in
``test_torch_lm_model.py``; decode with f32 caches), the encoder output
to 1e-5 of its largest |value|.  Greedy tokens are equal, in float and
on the BFP datapath, whose GEMM sites are bit-equal on their tapped
(x, w).

Quirks of the reference kept (ROADMAP Queue 3): ``forward`` without
``enc_feats`` encodes a zero stub of ``enc_seq_stub`` frames; a decode
step whose cache has no encoder output runs the cross-attention block on
x itself (self-attention); every decode step projects cross-attention
K/V over all encoder frames (no cross-KV cache).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import model as RM
from repro.serve import engine as RSE
from repro_torch.models.lm import model as PM
from repro_torch.serve import engine as PSE
from torch_lm_common import (check_bfp_logits, check_sites_against_repro,
                             cfgs, enc_frames, max_rel, port_bfp_run,
                             port_params, ref_bfp_logits, ref_params,
                             ref_params_np, serve_policies, site_groups,
                             tokens)

FLOAT_TOL = 1e-5
ARCH = "seamless-m4t-medium"
PROMPT = np.array([[5, 9, 2, 7], [1, 3, 3, 8]], np.int32)


def _decode(forward_step, cache, toks, n):
    lgs = []
    for i in range(n):
        lg, cache = forward_step(cache, toks[:, i:i + 1], i)
        lgs.append(lg[:, 0])
    return lgs, cache


@pytest.fixture(scope="module")
def ref():
    """The reference's float outputs from one jitted call, and its greedy
    tokens (float and BFP) from one more."""
    rcfg = cfgs(ARCH)[0]
    toks = tokens(2, 12, rcfg.vocab_size, seed=1)
    enc = enc_frames(ARCH)

    def run(p):
        out = {"logits": RM.forward(p, rcfg, toks, enc_feats=enc)[0],
               "logits_stub": RM.forward(p, rcfg, toks)[0],
               "enc_out": RM.prefill_encoder(p, rcfg, enc)}
        for tag, enc_out in (("dec", out["enc_out"]), ("dec_self", None)):
            cache = RM.init_cache(rcfg, 2, 16, jnp.float32)
            cache["enc_out"] = enc_out

            def body(c, i):
                lg, c = RM.decode_step(p, rcfg, c, jax.lax
                                       .dynamic_slice_in_dim(toks, i, 1, 1),
                                       i.astype(jnp.int32))
                return c, lg[:, 0]
            out[tag + "_cache"], out[tag] = jax.lax.scan(body, cache,
                                                         jnp.arange(8))
        return out

    out = jax.tree_util.tree_map(np.asarray,
                                 jax.jit(run)(ref_params_np(ARCH)))
    rk = serve_policies()[0]
    gen = jax.jit(lambda p, pr, e: [RSE.generate(
        p, rcfg, pr, 6, policy=pol, enc_feats=e, max_len=16)
        for pol in (None, rk)])
    out["tokens"], out["tokens_bfp"] = (np.asarray(a) for a in gen(
        ref_params(ARCH), PROMPT, enc))
    return out


def test_forward_with_frames_and_with_the_stub(ref):
    pcfg = cfgs(ARCH)[1]
    pp = port_params(ARCH)
    toks = torch.from_numpy(tokens(2, 12, pcfg.vocab_size, seed=1))
    enc = torch.from_numpy(enc_frames(ARCH))
    assert pcfg.enc_seq_stub == enc.shape[1] == 32
    assert max_rel(PM.forward(pp, pcfg, toks, enc_feats=enc)[0],
                   ref["logits"]) <= FLOAT_TOL
    assert max_rel(PM.forward(pp, pcfg, toks)[0], ref["logits_stub"]) \
        <= FLOAT_TOL


def test_prefill_encoder_init_cache_and_decode(ref):
    """The encoder output, the cache's leaves, and 8 decode steps with the
    encoder output and without one (the cross block on x itself)."""
    rcfg, pcfg = cfgs(ARCH)
    pp = port_params(ARCH)
    toks = torch.from_numpy(tokens(2, 12, pcfg.vocab_size, seed=1))
    enc_out = PM.prefill_encoder(pp, pcfg, torch.from_numpy(
        enc_frames(ARCH)))
    assert max_rel(enc_out, ref["enc_out"]) <= FLOAT_TOL
    cache = PM.init_cache(pcfg, 2, 16, device="cpu")
    want = jax.eval_shape(lambda: RM.init_cache(rcfg, 2, 16))
    assert cache["enc_out"] is None and want["enc_out"] is None
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache["self"].items()} \
        == {k: (v.shape, torch.bfloat16) for k, v in want["self"].items()}
    lgs = {}
    for tag, eo in (("dec", enc_out), ("dec_self", None)):
        cache = PM.init_cache(pcfg, 2, 16, torch.float32, device="cpu")
        cache["enc_out"] = eo
        steps, cache = _decode(lambda c, tk, i: PM.decode_step(
            pp, pcfg, c, tk, i), cache, toks, 8)
        lgs[tag] = torch.stack(steps)
        assert max_rel(lgs[tag], ref[tag]) <= FLOAT_TOL
        assert cache["enc_out"] is eo
        for k in ("k", "v"):
            assert max_rel(cache["self"][k], ref[tag + "_cache"]["self"][k]) \
                <= FLOAT_TOL
    assert not torch.allclose(lgs["dec"], lgs["dec_self"])


def test_generate_with_enc_feats_matches_repro(ref):
    """Greedy ``generate(enc_feats=)``: the encoder runs once at prefill,
    and the tokens equal ``repro``'s, float and BFP (prequantized
    weights on the port's kernel backend)."""
    pcfg = cfgs(ARCH)[1]
    pk = serve_policies()[1]
    enc = torch.from_numpy(enc_frames(ARCH))
    prompt = torch.from_numpy(PROMPT)
    for pol, want in ((None, ref["tokens"]), (pk, ref["tokens_bfp"])):
        got = PSE.generate(port_params(ARCH), pcfg, prompt, 6, policy=pol,
                           enc_feats=enc, max_len=16, device="cpu")
        assert got.tolist() == want.tolist(), pol
    # each row alone gives its batched tokens
    for i in range(2):
        one = PSE.generate(port_params(ARCH), pcfg, prompt[i:i + 1], 6,
                           enc_feats=enc[i:i + 1], max_len=16, device="cpu")
        assert one[0].tolist() == ref["tokens"][i].tolist()


def test_bfp_sites_bit_equal_and_cross_kv_recomputed_each_step():
    """PALLAS_TILED (block 32): every GEMM of a forward (7 a encoder
    layer, 11 a decoder layer, ``lm_head``) and 4 decode steps bit-equal
    to ``repro.engine.gemm``, the logits within the BFP tolerance; each
    decode step projects cross-attention K and V over all the encoder
    frames."""
    plan, events, flog, dlog = port_bfp_run(ARCH)
    pcfg = cfgs(ARCH)[1]
    n_enc, n_dec, s_enc = pcfg.encoder_layers, pcfg.n_layers, 32
    assert all(ev.backend == "pallas" for ev in events)
    assert all(s.prequantized for s in plan.sites.values())
    assert {"enc/attn/wq", "enc/ffn/w1", "xattn/wk", "attn/wq",
            "lm_head"} <= set(plan.sites)
    per_step = 11 * n_dec + 1
    # forward, prefill_encoder, 4 decode steps
    assert len(events) == 7 * n_enc * 2 + per_step * 5
    xk = [ev for ev in events if ev.path == "xattn/wk"]
    assert len(xk) == n_dec * (1 + 4)
    assert all(ev.x.shape == (2, s_enc, pcfg.d_model) for ev in xk)
    groups = site_groups(events, by_shape=True)
    assert sum(map(len, groups.values())) == 7 * n_enc + 11 * n_dec + 1
    assert check_sites_against_repro(groups) == len(groups)
    rf, rd = ref_bfp_logits(ARCH)
    check_bfp_logits(flog, rf)
    check_bfp_logits(dlog, rd)


def test_serve_engine_refuses_the_encoder_decoder():
    with pytest.raises(ValueError, match="serve.generate with enc_feats"):
        PSE.ServeEngine(port_params(ARCH), cfgs(ARCH)[1], device="cpu")
