"""Shared fixtures of the LM parity tests (``test_torch_lm_*.py``; no
tests here).

Both packages build the same reduced configs (2 layers, d_model 64,
d_ff 128, vocab 256) of the ten architectures.  The
reference's parameters come from one jitted ``repro`` ``init_params``
per architecture, exported as numpy and loaded into the port with
``convert.params_from_numpy``: the stacked layout is the same, so the
tree crosses unchanged.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from repro.configs import base as RB
from repro.configs import registry as RR
from repro.models.lm import model as RM
from repro_torch import _tree
from repro_torch.configs import base as PB
from repro_torch.configs import registry as PR
from repro_torch.convert import params_from_numpy
from test_torch_util import to_numpy_tree

#: the attention families this slice serves: dense (tinyllama,
#: mistral-nemo, minicpm with tied embeddings and N % 4 != 0 at full
#: width, qwen1.5 with QKV bias), vlm (qwen2-vl, M-RoPE) and moe
#: (mixtral with sliding windows, olmoe)
ARCH7 = ("tinyllama-1.1b", "mistral-nemo-12b", "minicpm-2b", "qwen1.5-4b",
         "qwen2-vl-2b", "mixtral-8x7b", "olmoe-1b-7b")
#: the recurrent families, ssm (rwkv6) and hybrid (recurrentgemma: at 2
#: layers no (rec, rec, attn) period and a remainder of two rec blocks),
#: and the encoder-decoder (seamless: 1 encoder layer at 2 decoder layers)
ARCH3 = ("rwkv6-3b", "recurrentgemma-9b", "seamless-m4t-medium")
ARCH10 = ARCH7 + ARCH3
SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)


def cfgs(arch: str, **over):
    """(reference config, port config) of ``arch`` at the test size."""
    kw = {**SMALL, **over}
    return (RB.reduced(RR.ARCHS[arch], **kw),
            PB.reduced(PR.ARCHS[arch], **kw))


def ref_params_np(arch: str, seed: int = 0, n_layers: int = 2):
    """The reference's seeded params of ``arch`` (one jitted init), as a
    tree of numpy arrays.  The hybrid's 2- and 3-layer trees are cut from
    its 5-layer tree (one (rec, rec, attn) period and a remainder of two
    rec blocks): no period and the remainder, or the period and no
    remainder — the trees the reference builds for those depths, from
    one init compile instead of three."""
    if RR.ARCHS[arch].block_pattern and n_layers in (2, 3):
        p = _ref_params_np(arch, seed, 5)
        if n_layers == 3:
            return {**p, "rem": []}
        return {**p, "periods": jax.tree_util.tree_map(lambda a: a[:0],
                                                       p["periods"])}
    return _ref_params_np(arch, seed, n_layers)


@functools.lru_cache(maxsize=None)
def _ref_params_np(arch: str, seed: int, n_layers: int):
    cfg = cfgs(arch, n_layers=n_layers)[0]
    p = jax.jit(lambda k: RM.init_params(cfg, k))(jax.random.PRNGKey(seed))
    return to_numpy_tree(p)


def port_params(arch: str, seed: int = 0, n_layers: int = 2):
    """The same params as the port's tree of CPU tensors."""
    return params_from_numpy(ref_params_np(arch, seed, n_layers),
                             device="cpu")


def tokens(b: int, s: int, vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def np_leaves(tree):
    """numpy leaves of a port tree in the reference's leaf order."""
    return [v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for v in _tree.flatten(tree)[0]]


def ref_leaves(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


def max_rel(port, ref) -> float:
    """max |port - ref| over max |ref| (the float-reduction tolerance
    the LM parity tests state)."""
    p = (port.detach().cpu().numpy() if isinstance(port, torch.Tensor)
         else np.asarray(port)).astype(np.float64)
    r = np.asarray(ref).astype(np.float64)
    assert p.shape == r.shape, (p.shape, r.shape)
    return float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-30))


# ---------------------------------------------------------------------------
# BFP: every GEMM site bit-equal to repro.engine.gemm, logits to a bound
# ---------------------------------------------------------------------------

#: the slice's serving policy at the test size: TILED, L = 8, block 32
#: (every reduced K, 64 or 128, is a multiple), on the kernel backend
#: ("pallas": the port's CUDA kernels, their plain versions on the CPU;
#: the reference's Pallas kernels in interpret mode)
BLOCK = 32

#: end-to-end BFP logits: both packages run every GEMM site bit for bit
#: alike (checked site by site), but the float ops between the sites
#: differ in the last place (XLA:CPU's RMSNorm reduces in another order
#: and its rsqrt is not correctly rounded: about 1 row in 3 of a
#: normalized activation differs by an ulp).  Where such an element sits
#: on a rounding boundary of the next site's 8-bit blocks, its mantissa
#: moves by one step (2^-6 of its block's scale), and the difference
#: travels down the residual stream.  Measured at the test size: at most
#: 0.0175 of the largest |logit| (tinyllama, qwen2-vl, mixtral; the
#: other four bit-equal), top-1 equal everywhere.  ``BFP_LOGIT_TOL`` =
#: 2^-4 of the largest |logit| bounds it, with top-1 agreement on at
#: least ``BFP_TOP1`` of the positions.
BFP_LOGIT_TOL = 2.0 ** -4
BFP_TOP1 = 0.95


def check_bfp_logits(port, ref) -> None:
    """Port logits against the reference's within the BFP tolerance."""
    assert max_rel(port, ref) <= BFP_LOGIT_TOL
    p = port.detach().cpu().numpy()
    assert (p.argmax(-1) == np.asarray(ref).argmax(-1)).mean() >= BFP_TOP1


def enc_frames(arch: str, n_layers: int = 2):
    """The encoder-decoder's seeded frame embeddings [2, S_enc, D] at the
    test size (None for the other families)."""
    cfg = cfgs(arch, n_layers=n_layers)[1]
    if not cfg.is_encdec:
        return None
    return (np.random.default_rng(5).standard_normal(
        (2, cfg.enc_seq_stub, cfg.d_model)) * 0.5).astype(np.float32)


def port_bfp_run(arch: str, n_decode: int = 4, n_layers: int = 2,
                 f32_cache: bool = False):
    """Bind the port at the test policy (prequantized) and run one
    forward (batch 2, 12 tokens) and ``n_decode`` decode steps from a
    bf16 cache (``f32_cache``: f32), tapping every GEMM (the
    encoder-decoder: over ``enc_frames``, its decode steps after
    ``prefill_encoder``).  Returns (plan, events, forward logits, decode
    logits)."""
    from repro_torch import engine as PEG
    from repro_torch.core.policy import PALLAS_TILED
    from repro_torch.models.lm import model as PM

    pcfg = cfgs(arch, n_layers=n_layers)[1]
    pol = PALLAS_TILED.with_(block_k=BLOCK, straight_through=False)
    plan = PEG.bind(port_params(arch, n_layers=n_layers), pol, tree="lm",
                    device="cpu")
    toks = torch.from_numpy(tokens(2, 12, pcfg.vocab_size, seed=1))
    enc = enc_frames(arch, n_layers)
    enc = None if enc is None else torch.from_numpy(enc)
    events = []
    with torch.inference_mode(), PEG.taps(events.append):
        flog, _ = PM.forward(plan.params, pcfg, toks, enc_feats=enc,
                             policy=plan)
        cache = PM.init_cache(pcfg, 2, 16, torch.float32 if f32_cache
                              else torch.bfloat16, device="cpu")
        if enc is not None:
            cache["enc_out"] = PM.prefill_encoder(plan.params, pcfg, enc,
                                                  plan)
        dlog = []
        for i in range(n_decode):
            lg, cache = PM.decode_step(plan.params, pcfg, cache,
                                       toks[:, i:i + 1], i, plan)
            dlog.append(lg[:, 0])
    return plan, events, flog, torch.stack(dlog)


def _wkey(w):
    m = w["m"] if isinstance(w, dict) else w
    return m.data_ptr(), tuple(m.shape), tuple(m.stride())


def _shape_key(x, w):
    """A group of same-shaped GEMMs (one vmapped reference call, one
    compile): x's rows and w's shapes, whatever their paths."""
    ws = tuple(sorted((k, tuple(v.shape)) for k, v in w.items())) \
        if isinstance(w, dict) else tuple(w.shape)
    return (tuple(x.shape), ws)


def site_groups(events, by_shape: bool = False):
    """BFP events grouped per executed weight (one layer's matrix) and
    then per site path: {path: [(x rows [M, K], w, y rows [M, N]), ...
    one per layer]}, each layer's rows concatenated over every call in
    call order.  Float events (the MoE router, the float backend) are
    left out.  ``by_shape``: group by shapes instead (the recurrent
    families' linears pass no path; fewer reference compiles)."""
    per_w = {}
    for ev in events:
        if ev.policy is None:
            continue
        key = (ev.path, _wkey(ev.w))
        xs, w, ys = per_w.setdefault(key, ([], ev.w, []))
        xs.append(ev.x.reshape(-1, ev.x.shape[-1]))
        ys.append(ev.y.reshape(-1, ev.y.shape[-1]))
    out = {}
    for (path, _), (xs, w, ys) in per_w.items():
        x = torch.cat(xs)
        key = _shape_key(x, w) if by_shape else path
        out.setdefault(key, []).append((x, w, torch.cat(ys)))
    return out


def check_sites_against_repro(groups) -> int:
    """Every site's output against ``repro.engine.gemm`` on the same
    (x, w), bit for bit: one jitted call per arch, each site's layers
    stacked and vmapped (rows are independent in the TILED datapath, so
    the concatenated calls are the calls).  Returns the sites checked."""
    from repro import engine as REG
    from repro.core.policy import PALLAS_TILED as R_TILED
    from test_torch_util import assert_bits_equal

    pol = R_TILED.with_(block_k=BLOCK, straight_through=False)
    paths = sorted(groups, key=str)

    def np_w(w):
        if isinstance(w, dict):
            return {k: v.numpy() for k, v in w.items()}
        return w.contiguous().numpy()

    xs = [np.stack([x.numpy() for x, _, _ in groups[p]]) for p in paths]
    ws = [jax.tree_util.tree_map(lambda *a: np.stack(a),
                                 *[np_w(w) for _, w, _ in groups[p]])
          for p in paths]
    run = jax.jit(lambda xs, ws: [jax.vmap(
        lambda x, w: REG.gemm(x, w, pol))(x, w) for x, w in zip(xs, ws)])
    outs = run(xs, ws)
    for p, got in zip(paths, outs):
        for i, (_, _, y) in enumerate(groups[p]):
            assert_bits_equal(y, np.asarray(got[i]))
    return len(paths)


def ref_bfp_logits(arch: str, n_decode: int = 4, n_layers: int = 2,
                   f32_cache: bool = False):
    """The reference's forward and decode logits under the same policy
    on its emulated backend (the integer datapath its Pallas kernels
    match bit for bit), jitted (``f32_cache`` as in
    :func:`port_bfp_run`)."""
    from repro import engine as REG
    from repro.core.policy import TPU_TILED as R_TILED

    rcfg = cfgs(arch, n_layers=n_layers)[0]
    pol = R_TILED.with_(block_k=BLOCK, straight_through=False)
    toks = tokens(2, 12, rcfg.vocab_size, seed=1)

    def run(p, tk, enc):
        plan = REG.bind(p, pol, tree="lm", prequantize=False)
        flog, _ = RM.forward(p, rcfg, tk, enc_feats=enc, policy=plan)

        def body(c, i):
            lg, c = RM.decode_step(p, rcfg, c, jax.lax.dynamic_slice_in_dim(
                tk, i, 1, 1), i.astype(jax.numpy.int32), plan)
            return c, lg[:, 0]
        cache = RM.init_cache(rcfg, 2, 16, jax.numpy.float32 if f32_cache
                              else jax.numpy.bfloat16)
        if enc is not None:
            cache["enc_out"] = RM.prefill_encoder(p, rcfg, enc, plan)
        _, dlog = jax.lax.scan(body, cache, jax.numpy.arange(n_decode))
        return flog, dlog

    from repro.core.prequant import quantize_param_tree
    q = jax.jit(lambda p: quantize_param_tree(p, pol))(
        ref_params_np(arch, n_layers=n_layers))
    f, d = jax.jit(run)(q, toks, enc_frames(arch, n_layers))
    return np.asarray(f), np.asarray(d)


def check_bfp_arch(arch: str):
    """An architecture's BFP run: every engine site bit-equal to
    ``repro``, the logits within the BFP tolerance.  Returns the port's
    plan and its engine events."""
    plan, events, flog, dlog = port_bfp_run(arch)
    groups = site_groups(events)
    # 7 linears per layer (4 with MoE: the experts are not engine sites)
    # and lm_head (minicpm: tied, a float-weight site)
    n_sites = 5 if cfgs(arch)[1].is_moe else 8
    assert len(groups) == n_sites
    assert all(len(v) == 2 for k, v in groups.items() if k != "lm_head")
    assert all(ev.backend == ("float" if ev.policy is None else "pallas")
               for ev in events)
    assert check_sites_against_repro(groups) == n_sites
    rf, rd = ref_bfp_logits(arch)
    check_bfp_logits(flog, rf)
    check_bfp_logits(dlog, rd)
    return plan, events


# ---------------------------------------------------------------------------
# serving against repro
# ---------------------------------------------------------------------------

#: BFP serving policy of the serving parity tests: the port's kernel
#: backend (the kernels' plain versions on the CPU) against the
#: reference's emulated datapath (the same bits; its Pallas kernels in
#: interpret mode compile for minutes here)
def serve_policies():
    from repro.core.policy import TPU_TILED as R_TILED
    from repro_torch.core.policy import PALLAS_TILED as P_TILED
    return (R_TILED.with_(block_k=BLOCK, straight_through=False),
            P_TILED.with_(block_k=BLOCK, straight_through=False))


def ref_params(arch: str):
    """The reference's params as device arrays (its traced loops index
    them with traced tokens)."""
    return jax.tree_util.tree_map(jax.numpy.asarray, ref_params_np(arch))


def check_generate(arch: str) -> None:
    """Greedy ``generate`` of two prompts, float and BFP: the port's
    tokens equal the reference's (one jitted ``repro.generate`` each)."""
    from repro.serve import engine as RSE
    from repro_torch.serve.engine import generate

    rcfg, pcfg = cfgs(arch)
    prompt = np.array([[5, 9, 2, 7], [1, 3, 3, 8]], np.int32)
    rk, pk = serve_policies()
    for rpol, ppol in ((None, None), (rk, pk)):
        want = jax.jit(lambda p, pr: RSE.generate(
            p, rcfg, pr, 6, policy=rpol, max_len=16))(ref_params(arch),
                                                       prompt)
        got = generate(port_params(arch), pcfg, torch.from_numpy(prompt), 6,
                       policy=ppol, max_len=16, device="cpu")
        assert got.tolist() == np.asarray(want).tolist(), (arch, ppol)

