"""The port's RWKV-6 (``models.lm.rwkv6`` and the ssm branch of
``models.lm.model``) against ``repro`` on the same params (exported from
a jitted ``repro`` init) and numpy inputs.

Float paths agree to ``FLOAT_TOL`` = 1e-5 of the largest |output|, not
bit for bit: the chunked WKV's ``cumsum``, ``exp`` and einsums (XLA:CPU
against PyTorch's CPU kernels) sum in other orders and round ``exp`` /
``log`` differently in the last place (measured: 1e-6 of the largest
|output| at S = 64).  On the BFP datapath every GEMM site of a forward
and four decode steps is bit-equal on its tapped (x, w), and the logits
agree within ``BFP_LOGIT_TOL`` (see ``torch_lm_common``).

R7 (reference behaviour, kept): RWKV-6's decode forms drop the policy,
so under a bound plan every layer GEMM of a decode step runs the float
backend over dequantized prequant weights; only ``lm_head`` runs BFP.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import model as RM
from repro.models.lm import rwkv6 as RR
from repro_torch.models.lm import model as PM
from repro_torch.models.lm import rwkv6 as PR_
from test_torch_util import normal, t
from torch_lm_common import (check_bfp_logits, check_sites_against_repro,
                             cfgs, max_rel, port_bfp_run, port_params,
                             ref_bfp_logits, ref_params_np, site_groups,
                             tokens)

FLOAT_TOL = 1e-5
ARCH = "rwkv6-3b"
B, H, D = 2, 4, 16


def _wkv_inputs(s):
    r, k, v = (normal((B, s, H, D), seed=s + i) for i in range(3))
    w = np.exp(-np.exp(normal((B, s, H, D), seed=s + 3, scale=0.5) - 0.5))
    return r, k, v, w.astype(np.float32), normal((H, D), seed=s + 4,
                                                scale=0.1)


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree["layers"])


@pytest.fixture(scope="module")
def ref():
    """Every reference output of this file from one jitted call."""
    rcfg = cfgs(ARCH)[0]
    x = normal((B, 12, 64), seed=1)
    xp, sp = normal((B, 64), seed=2), normal((B, H, D, D), seed=3, scale=0.1)
    x1 = normal((B, 1, 64), seed=4)
    toks = tokens(2, 12, rcfg.vocab_size, seed=1)

    def run(p, wkv16, wkv64):
        lp = _layer0(p)
        out = {"wkv16": RR._wkv_chunked(*wkv16),
               "wkv64": RR._wkv_chunked(*wkv64),
               "tm": RR.time_mix(lp["tm"], rcfg, x, xp),
               "tm_dec": RR.time_mix_decode(lp["tm"], rcfg, x1, (xp, sp)),
               "cm": RR.channel_mix(lp["cm"], rcfg, x, xp),
               "cm_dec": RR.channel_mix_decode(lp["cm"], rcfg, x1, xp),
               "logits": RM.forward(p, rcfg, toks)[0]}
        cache = RM.init_cache(rcfg, 2, 16)

        def body(c, i):
            lg, c = RM.decode_step(p, rcfg, c, jax.lax.dynamic_slice_in_dim(
                toks, i, 1, 1), i.astype(jnp.int32))
            return c, lg[:, 0]
        out["cache"], out["dec"] = jax.lax.scan(body, cache, jnp.arange(8))
        return out

    out = jax.jit(run)(ref_params_np(ARCH), _wkv_inputs(16),
                       _wkv_inputs(64))
    return (jax.tree_util.tree_map(np.asarray, out),
            dict(x=x, xp=xp, sp=sp, x1=x1, toks=toks))


@pytest.mark.parametrize("s", [16, 64])
def test_wkv_chunked(ref, s):
    """One chunk of 16, and two chunks of 32 carrying the state."""
    got = PR_._wkv_chunked(*(t(a) for a in _wkv_inputs(s)))
    assert got.shape == (B, s, H, D)
    assert max_rel(got, ref[0][f"wkv{s}"]) <= FLOAT_TOL


def test_time_mix_and_channel_mix_blocks(ref):
    """Each block's full-sequence and decode forms from a nonzero
    delay-line state and WKV state."""
    out, inp = ref
    pcfg = cfgs(ARCH)[1]
    lp = PM._layers(port_params(ARCH)["layers"])[1](0)
    x, xp, sp, x1 = (t(inp[k]) for k in ("x", "xp", "sp", "x1"))
    assert max_rel(PR_.time_mix(lp["tm"], pcfg, x, xp), out["tm"]) \
        <= FLOAT_TOL
    y, (xl, s2) = PR_.time_mix_decode(lp["tm"], pcfg, x1, (xp, sp))
    assert max_rel(y, out["tm_dec"][0]) <= FLOAT_TOL
    assert torch.equal(xl, x1[:, -1])
    assert max_rel(s2, out["tm_dec"][1][1]) <= FLOAT_TOL
    assert max_rel(PR_.channel_mix(lp["cm"], pcfg, x, xp), out["cm"]) \
        <= FLOAT_TOL
    y, xl = PR_.channel_mix_decode(lp["cm"], pcfg, x1, xp)
    assert max_rel(y, out["cm_dec"][0]) <= FLOAT_TOL
    assert torch.equal(xl, x1[:, -1])


def test_forward_init_cache_and_decode(ref):
    """The ssm branch: forward logits, the cache's leaves (f32 states
    [L, B, ...]) and 8 decode steps."""
    out, inp = ref
    pcfg = cfgs(ARCH)[1]
    pp = port_params(ARCH)
    toks = torch.from_numpy(inp["toks"])
    assert max_rel(PM.forward(pp, pcfg, toks)[0], out["logits"]) \
        <= FLOAT_TOL
    cache = PM.init_cache(pcfg, 2, 16, device="cpu")
    want = RM.init_cache(cfgs(ARCH)[0], 2, 16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in cache.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    lgs = []
    for i in range(8):
        lg, cache = PM.decode_step(pp, pcfg, cache, toks[:, i:i + 1], i)
        lgs.append(lg[:, 0])
    assert max_rel(torch.stack(lgs), out["dec"]) <= FLOAT_TOL
    for k in ("x_att", "x_ffn", "S"):
        assert cache[k].dtype == torch.float32
        assert max_rel(cache[k], out["cache"][k]) <= FLOAT_TOL


def test_bfp_sites_bit_equal_and_decode_drops_the_policy():
    """PALLAS_TILED (block 32) on the kernel backend: the forward's GEMM
    sites (7 time-mix and 3 channel-mix linears a layer, no path, and
    ``lm_head``) bit-equal to ``repro.engine.gemm``, the logits within
    the BFP tolerance; each decode step runs every layer GEMM on the
    float backend (R7) and only ``lm_head`` on the kernels."""
    plan, events, flog, dlog = port_bfp_run(ARCH)
    n_layers = cfgs(ARCH)[1].n_layers
    assert all(s.prequantized for s in plan.sites.values())
    fwd = [ev for ev in events if ev.x.shape[1] == 12]
    dec = [ev for ev in events if ev.x.shape[1] == 1]
    assert len(fwd) == 10 * n_layers + 1 and len(dec) == 4 * len(fwd)
    assert all(ev.backend == "pallas" for ev in fwd)
    assert [ev.path for ev in dec if ev.backend == "pallas"] == \
        ["lm_head"] * 4
    assert all(ev.backend == "float" and ev.policy is None and
               ev.path is None for ev in dec if ev.path != "lm_head")
    assert {ev.path for ev in fwd} == {None, "lm_head"}
    groups = site_groups(events, by_shape=True)
    assert sum(map(len, groups.values())) == 10 * n_layers + 1
    assert check_sites_against_repro(groups) == len(groups)
    rf, rd = ref_bfp_logits(ARCH)
    check_bfp_logits(flog, rf)
    check_bfp_logits(dlog, rd)
