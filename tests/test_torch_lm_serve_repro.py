"""The port's LM serving against ``repro`` on the same params and
requests: greedy ``generate`` (float and BFP) for qwen1.5 (QKV bias) and
olmoe (MoE), and ``ServeEngine`` tokens and call counts (staggered
prompts, chunked prefill, more requests than slots) for tinyllama and
olmoe on the BFP datapath with prequantized weights."""
import jax
import pytest

from repro.core.prequant import quantize_param_tree
from repro.serve import engine as RSE
from repro_torch.serve.engine import Request, ServeEngine
from torch_lm_common import (cfgs, check_generate, port_params, ref_params,
                             serve_policies)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "olmoe-1b-7b"])
def test_generate_greedy_matches_repro(arch):
    check_generate(arch)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_serve_engine_tokens_match_repro(arch):
    rcfg, pcfg = cfgs(arch)
    rk, pk = serve_policies()
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5, 4, 3], [11, 12], [4] * 5]

    def serve(eng, req_cls):
        rs = [req_cls(rid=i, prompt=list(p), max_new=4)
              for i, p in enumerate(prompts)]
        for r in rs:
            eng.submit(r)
        eng.run()
        assert all(r.done and r.error is None for r in rs)
        return [r.out for r in rs], eng.ncalls

    # the reference's weights prequantized by one jitted walk (its
    # engine's eager prequant= compiles op by op); the port's at admission
    rq = jax.jit(lambda p: quantize_param_tree(p, rk))(ref_params(arch))
    want = serve(RSE.ServeEngine(rq, rcfg, slots=2, max_len=32, policy=rk,
                                 prefill_chunk=2), RSE.Request)
    got = serve(ServeEngine(port_params(arch), pcfg, slots=2, max_len=32,
                            prequant=pk, policy=pk, prefill_chunk=2,
                            device="cpu"), Request)
    assert got == want
