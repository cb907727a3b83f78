"""Serving the recurrent families (rwkv6, recurrentgemma) and the
encoder-decoder's trees through the port's LM serving slice, against
``repro`` on the same params and requests.

``ServeEngine`` tokens (staggered prompts, chunked prefill, more requests
than slots) equal ``repro``'s ServeEngine's in float and on the BFP
datapath with prequantized weights (the port's kernel backend, the
kernels' plain versions here; the reference's emulated datapath, the
same bits).  Recurrent states are read-modify-write, so a reused slot
must start from the pristine state, and the hybrid's nested cache is
merged leaf by leaf with ``jnp.where``'s dtype promotion.  (The tree
walks over these families' trees: ``test_torch_lm_walkers_recurrent.py``.)

The hybrid serves at 3 layers (a (rec, rec, attn) period and an empty
remainder, whose cache leaves are ``[0, B, ...]``).  ``repro``'s
``generate`` cannot serve it from the default bf16 cache (R8: its scan
cannot carry the conv history that the first step promotes to f32); its
``ServeEngine`` can, and the port's ``generate`` does.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.prequant import quantize_param_tree
from repro.serve import engine as RSE
from repro_torch import _tree
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import serve as serve_cli
from repro_torch.models.lm import model as PM
from repro_torch.serve.engine import Request, ServeEngine, generate
from torch_lm_common import (cfgs, port_params, ref_params_np,
                             serve_policies)

#: (arch, layers) of the served recurrent configs
SERVED = (("rwkv6-3b", 2), ("recurrentgemma-9b", 3))
PROMPTS = [[1, 2, 3], [9, 8, 7, 6, 5, 4, 3], [11, 12], [4] * 5]


def _serve(eng, req_cls, prompts=PROMPTS, max_new=4):
    rs = [req_cls(rid=i, prompt=list(p), max_new=max_new)
          for i, p in enumerate(prompts)]
    for r in rs:
        eng.submit(r)
    eng.run()
    assert all(r.done and r.error is None for r in rs)
    return [r.out for r in rs], eng.ncalls


@pytest.mark.parametrize("bfp", [False, True])
@pytest.mark.parametrize("arch,layers", SERVED)
def test_serve_engine_tokens_match_repro(arch, layers, bfp):
    rcfg, pcfg = cfgs(arch, n_layers=layers)
    rk, pk = serve_policies() if bfp else (None, None)
    rp = jax.tree_util.tree_map(jnp.asarray,
                                ref_params_np(arch, n_layers=layers))
    if bfp:
        rp = jax.jit(lambda p: quantize_param_tree(p, rk))(rp)
    want = _serve(RSE.ServeEngine(rp, rcfg, slots=2, max_len=32, policy=rk,
                                  prefill_chunk=2), RSE.Request)
    got = _serve(ServeEngine(port_params(arch, n_layers=layers), pcfg,
                             slots=2, max_len=32, prequant=pk, policy=pk,
                             prefill_chunk=2, device="cpu"), Request)
    assert got == want


@pytest.mark.parametrize("arch,layers", SERVED)
def test_solo_equals_batched_and_bucket(arch, layers):
    """Each request served alone on a fresh engine gives its continuous
    tokens, and so does bucket batching (row independence of the
    recurrent states)."""
    pcfg = cfgs(arch, n_layers=layers)[1]
    params = port_params(arch, n_layers=layers)
    pk = serve_policies()[1]
    kw = dict(slots=2, max_len=32, policy=pk, prequant=pk, device="cpu")
    outs, _ = _serve(ServeEngine(params, pcfg, prefill_chunk=2, **kw),
                     Request)
    for i, p in enumerate(PROMPTS):
        assert _serve(ServeEngine(params, pcfg, **kw), Request, [p])[0] \
            == [outs[i]]
    assert _serve(ServeEngine(params, pcfg, batching="bucket", **kw),
                  Request)[0] == outs
    # generate, a Python loop over decode_step from the bf16 cache: the
    # engine's ``out`` starts after the prompt's own greedy token (as
    # ``repro``'s engine does), generate's with it.  Generate feeds that
    # first token at position S + 1, as ``repro``'s does, so the tokens
    # agree where positions do not matter (rwkv6)
    for i, p in enumerate(PROMPTS[:2]):
        got = generate(params, pcfg, torch.tensor([p]), 5, policy=pk,
                       max_len=32, device="cpu")
        assert got.shape == (1, 5)
        if pcfg.family == "ssm":
            assert got[0, 1:].tolist() == outs[i]


def test_serve_engine_slot_reuse_resets_recurrent_state():
    """``tests/test_system.py``'s regression on the port: a reused slot
    starts from the pristine state, so the second request's tokens equal
    its tokens served alone."""
    cfg = reduced(ARCHS["rwkv6-3b"], n_layers=2, d_model=64, vocab=256)
    params = PM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")

    def solo(prompt):
        eng = ServeEngine(params, cfg, slots=1, max_len=64, device="cpu")
        r = Request(rid=0, prompt=prompt, max_new=4)
        eng.submit(r)
        eng.run()
        return list(r.out)

    ref2 = solo([5, 6])
    eng = ServeEngine(params, cfg, slots=1, max_len=64, device="cpu")
    r1 = Request(rid=1, prompt=[1, 2, 3], max_new=4)
    r2 = Request(rid=2, prompt=[5, 6], max_new=4)
    eng.submit(r1)
    eng.submit(r2)          # runs in the slot r1 vacates
    eng.run()
    assert r2.out == ref2, (r2.out, ref2)


def test_merge_rows_over_the_nested_cache_promotes():
    """The hybrid's nested cache: a slot reset merges the pristine bf16
    conv history into a stepped f32 one, leaf by leaf; the row comes back
    zero and f32 (``jnp.where``'s promotion), the other row untouched."""
    arch = "recurrentgemma-9b"
    pcfg = cfgs(arch, n_layers=5)[1]
    eng = ServeEngine(port_params(arch, n_layers=5), pcfg, slots=2,
                      max_len=16, device="cpu")
    _, eng.cache = eng._step(eng.cache, torch.tensor([[3], [4]]), 0)
    stepped = eng.cache
    assert stepped["rec1"]["hist"].dtype == torch.float32
    assert eng._cache0["rec1"]["hist"].dtype == torch.bfloat16
    eng._reset_slot(1, Request(rid=0, prompt=[1], max_new=1), False)
    for (path, new), old in zip(_tree.leaves_with_path(eng.cache),
                                _tree.flatten(stepped)[0]):
        assert new.dtype == old.dtype, _tree.keystr(path)
        assert torch.equal(new[:, 0], old[:, 0])
        assert not new[:, 1].any()
    def to_jnp(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)

    r = RSE.ServeEngine.__new__(RSE.ServeEngine)     # the reference's merge
    r.slots = 2
    want = r._merge_rows(jax.tree_util.tree_map(to_jnp, eng._cache0),
                         jax.tree_util.tree_map(to_jnp, stepped), [0])
    assert [str(v.dtype) for v in jax.tree_util.tree_leaves(want)] == \
        [str(v.dtype).split(".")[-1] for v in _tree.flatten(eng.cache)[0]]


def test_serve_cli_recurrent_families_and_encdec():
    """``--arch rwkv6-3b`` and ``--arch recurrentgemma-9b`` serve at smoke
    scale (the hybrid's 4 layers: a period and one rec block);
    seamless fails as the reference's launcher does (ServeEngine refuses
    an encoder-decoder)."""
    for arch in ("rwkv6-3b", "recurrentgemma-9b"):
        serve_cli.main(["--arch", arch, "--requests", "2", "--max-new", "2",
                        "--bfp", "--bfp-weights", "--device", "cpu"])
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve_cli.main(["--arch", "seamless-m4t-medium", "--requests", "1",
                        "--max-new", "1", "--device", "cpu"])
