"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and entry points
called without ``device=`` never drift onto the CPU when CUDA is absent.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import engine as EG
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import PALLAS_TILED
from repro_torch.models.cnn import MODELS, googlenet, layers, resnet, small, vgg
from repro_torch.serve.cnn import CnnServeEngine

REPO = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = {(f.relative_to(REPO).as_posix(), root) for f in files
           for root in _imported_roots(f) if root in _FORBIDDEN}
    assert not bad, f"port modules import the reference: {sorted(bad)}"


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for name in MODELS:              # every registered model's init
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MODELS[name].init(gen)
    for init in (resnet.init, googlenet.init, small.lenet_init,
                 small.cifarnet_init):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init(gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vgg.init(gen, input_hw=32, width_mult=0.125, fc_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        layers.conv2d_init(gen, 3, 8, 3, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.ones((2, 2), np.float32)})
    params = {"fc": layers.dense_init(gen, 4, 2, device="cpu")}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EG.bind(params, PALLAS_TILED)
    apply = lambda p, x, pol: layers.dense(p["fc"], x.reshape(len(x), -1),  # noqa: E731
                                           pol, path="fc")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CnnServeEngine(params, apply, None)
    # asked for explicitly, the CPU serves
    eng = CnnServeEngine(params, apply, None, device="cpu")
    req = eng.submit(image=torch.ones(1, 2, 2))
    eng.run()
    assert req.logits.shape == (2,)
    assert eng.plan.params["fc"]["w"].device.type == "cpu"


def test_packed_artifact_entry_points_need_cuda_unless_asked(monkeypatch,
                                                            tmp_path):
    """The modules of the packed-artifact path (checkpoint store, packed
    containers, tenants, faults, the serve CLI) also default to the card
    and raise without it."""
    from repro_torch.checkpoint import store
    from repro_torch.core import packed
    from repro_torch.core.policy import TPU_TILED
    from repro_torch.engine.plan import unpack_packed
    from repro_torch.faults import endurance_campaign, run_point
    from repro_torch.launch import serve_cnn
    from repro_torch.serve.degrade import float_params
    from repro_torch.serve.tenants import cold_start

    assert {"checkpoint", "faults", "launch"} <= {
        f.parent.name for f in _port_files()}
    pol = TPU_TILED.with_(block_k=None)
    params = MODELS["lenet"].init(torch.Generator().manual_seed(0),
                                  device="cpu")
    store.save(str(tmp_path), 0, params, format="bfp_packed", policy=pol)
    pk = packed.pack_param_tree(params, pol)
    leaf = pk["c1"]["w"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: store.restore(str(tmp_path), params),
                 lambda: cold_start("lenet", str(tmp_path)),
                 lambda: packed.unpack_prequant(leaf),
                 lambda: packed.unpack_dequant(leaf),
                 lambda: packed.unpack_block(leaf),
                 lambda: unpack_packed(pk),
                 lambda: float_params(pk),
                 lambda: run_point("lenet", 8, "exponent", 1e-2, 0),
                 lambda: endurance_campaign(),
                 lambda: serve_cnn.main(["--model", "lenet"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # a tree without containers needs no device to pass through
    assert float_params(params)["c1"]["w"] is params["c1"]["w"]
    assert unpack_packed(params) is params


def test_training_entry_points_need_cuda_unless_asked(monkeypatch):
    """The modules of the training slice (grad, optim, dist, data, train)
    import nothing of the reference (the scan above) and their entry
    points default to the card, raising without it."""
    from repro_torch.data.pipeline import image_batch
    from repro_torch.dist import compress
    from repro_torch.train import cnn as TC

    assert {"grad", "optim", "dist", "data", "train"} <= {
        f.parent.name for f in _port_files()}
    cfg = TC.CnnTrainConfig(model="lenet", batch=4, grad_bits=8)
    wire = compress.pack_leaf(torch.ones(3, 5), 8).to_bytes()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TC.init_state(cfg),
                 lambda: TC.data_batch(cfg, 0),
                 lambda: TC.train_cnn(cfg, steps=1),
                 lambda: image_batch(torch.Generator(), 10, 2, 8, 1),
                 lambda: compress.unpack_leaf(wire)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asked for explicitly, the CPU trains
    state = TC.init_state(cfg, device="cpu")
    x, y, _ = TC.data_batch(cfg, 0, device="cpu")
    new, metrics = TC.make_cnn_train_step(cfg)(state, (x, y))
    assert int(new.step) == 1 and np.isfinite(float(metrics["loss"]))
    assert compress.unpack_leaf(wire, "cpu").shape == (3, 5)


def test_tune_entry_points_need_cuda_unless_asked(monkeypatch, tmp_path):
    """The tune slice (tile tuner, precision search, its CLI) and the
    load driver's engine default to the card and raise without it."""
    from repro_torch.core.policy import TPU_TILED
    from repro_torch.tune import (TuneCache, search_precision, time_us,
                                  tune_conv, tune_gemm)
    from repro_torch.tune import __main__ as tune_cli

    assert {"tune"} <= {f.parent.name for f in _port_files()}
    assert any(f.name == "load.py" and f.parent.name == "serve"
               for f in _port_files())
    pol = TPU_TILED.with_(block_k=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: search_precision("lenet", batch=2),
                 lambda: tune_gemm(8, 32, 8, pol, cache=TuneCache()),
                 lambda: tune_conv(1, 4, 4, 2, 3, 4, pol,
                                   cache=TuneCache()),
                 lambda: time_us(lambda: None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    for argv in (["--smoke", "--out", str(tmp_path / "c.json")],
                 ["--precision", "--model", "lenet", "--batch", "2"]):
        monkeypatch.setattr("sys.argv", ["repro_torch.tune", *argv])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tune_cli.main()
    assert not (tmp_path / "c.json").exists()
    # asked for explicitly, the CPU tunes and searches
    cache = TuneCache()
    ent = tune_gemm(8, 32, 8, pol, cache=cache, max_steps=2, iters=1,
                    device="cpu")
    assert ent["bk"] == 16 and len(cache) == 1
    res = search_precision("lenet", batch=2, nsr_budget=1e-2,
                           device="cpu")
    assert res.sites
    monkeypatch.setattr("sys.argv", [
        "repro_torch.tune", "--precision", "--model", "lenet", "--batch",
        "2", "--device", "cpu", "--policy-out", str(tmp_path / "p.json"),
        "--checkpoint-out", str(tmp_path / "ckpt")])
    tune_cli.main()
    assert (tmp_path / "p.json").exists() and (tmp_path / "ckpt").exists()


def test_lm_entry_points_need_cuda_unless_asked(monkeypatch):
    """The LM serving slice (configs, models.lm, serve.engine,
    launch.serve, bind(tree="lm")) defaults to the card and raises
    without it; asked for explicitly, the CPU serves."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.lm import model as lm
    from repro_torch.serve import engine as SE

    assert {"configs", "lm"} <= {f.parent.name for f in _port_files()}
    cfg = reduced(ARCHS["tinyllama-1.1b"], n_layers=1, d_model=32, d_ff=32,
                  vocab=64)
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, gen, device="cpu")
    prompt = torch.tensor([[1, 2]])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: lm.init_params(cfg, gen),
                 lambda: lm.init_cache(cfg, 1, 8),
                 lambda: SE.ServeEngine(params, cfg, slots=1, max_len=8),
                 lambda: SE.generate(params, cfg, prompt, 2),
                 lambda: SE.prefill(params, cfg, prompt,
                                    lm.init_cache(cfg, 1, 8, device="cpu")),
                 lambda: EG.bind(params, PALLAS_TILED, tree="lm"),
                 lambda: EG.bind(params, PALLAS_TILED),
                 lambda: serve_cli.main(["--arch", "tinyllama-1.1b"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asked for explicitly, the CPU serves
    eng = SE.ServeEngine(params, cfg, slots=1, max_len=8,
                         policy=PALLAS_TILED.with_(block_k=16),
                         device="cpu")
    req = SE.Request(rid=0, prompt=[1, 2], max_new=2)
    eng.submit(req)
    eng.run()
    assert req.error is None and len(req.out) == 2
    assert eng.plan.params["layers"]["attn"]["wq"]["w"].device.type == "cpu"
    out = SE.generate(params, cfg, prompt, 2, device="cpu")
    assert out.shape == (1, 2) and out.device.type == "cpu"
    serve_cli.main(["--arch", "olmoe-1b-7b", "--requests", "1",
                    "--max-new", "2", "--bfp", "--bfp-weights",
                    "--device", "cpu"])


def test_recurrent_and_encdec_entry_points_need_cuda_unless_asked(
        monkeypatch):
    """The recurrent families (``models/lm/rwkv6.py``,
    ``models/lm/griffin.py``) and the encoder-decoder default to the card
    like the rest of the LM slice; asked for explicitly, the CPU serves
    them (the encoder-decoder through ``generate(enc_feats=)``)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.lm import model as lm
    from repro_torch.serve import engine as SE

    names = {f.relative_to(REPO).as_posix() for f in _port_files()}
    assert {"src/repro_torch/models/lm/rwkv6.py",
            "src/repro_torch/models/lm/griffin.py"} <= names
    gen = torch.Generator().manual_seed(0)
    cases = []
    for arch, layers in (("rwkv6-3b", 1), ("recurrentgemma-9b", 3),
                         ("seamless-m4t-medium", 2)):
        cfg = reduced(ARCHS[arch], n_layers=layers, d_model=32, d_ff=32,
                      vocab=64)
        enc = (torch.zeros((1, cfg.enc_seq_stub, cfg.d_model))
               if cfg.is_encdec else None)
        cases.append((cfg, lm.init_params(cfg, gen, device="cpu"), enc))
    prompt = torch.tensor([[1, 2]])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg, params, enc in cases:
        for call in (lambda: lm.init_params(cfg, gen),
                     lambda: lm.init_cache(cfg, 1, 8),
                     lambda: SE.generate(params, cfg, prompt, 2,
                                         enc_feats=enc)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        out = SE.generate(params, cfg, prompt, 2, enc_feats=enc,
                          device="cpu")
        assert out.shape == (1, 2) and out.device.type == "cpu"


def test_lm_training_entry_points_need_cuda_unless_asked(monkeypatch,
                                                        tmp_path):
    """The LM training slice (``train.step``, ``train.loop``, the LM data
    stream, ``launch.train``) imports nothing of the reference (the scan
    above), defaults to the card and raises without it; asked for
    explicitly, the CPU trains."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data import pipeline as DP
    from repro_torch.launch import train as train_cli
    from repro_torch.train import loop as TL
    from repro_torch.train import step as TS

    names = {f.relative_to(REPO).as_posix() for f in _port_files()}
    assert {"src/repro_torch/train/step.py", "src/repro_torch/train/loop.py",
            "src/repro_torch/launch/train.py"} <= names
    cfg = reduced(ARCHS["tinyllama-1.1b"], n_layers=1, d_model=32, d_ff=32,
                  vocab=64)
    spec = DP.LMBatchSpec(vocab_size=64, seq_len=8, global_batch=2)
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TS.init_state(cfg, gen),
                 lambda: DP.lm_batch(spec, 0),
                 lambda: train_cli.main(["--arch", "tinyllama-1.1b",
                                         "--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asked for explicitly, the CPU trains (its batches follow the state)
    state = TS.init_state(cfg, gen, device="cpu")
    out = TL.run_training(state, TS.make_train_step(cfg), spec,
                          TL.LoopConfig(total_steps=2,
                                        ckpt_dir=str(tmp_path)))
    assert int(out["state"].step) == 2 and len(out["history"]) == 2
    train_cli.main(["--arch", "rwkv6-3b", "--steps", "1", "--batch", "2",
                    "--seq", "32", "--device", "cpu"])


def test_dist_entry_points_need_cuda_unless_asked(monkeypatch):
    """The sharding slice (``dist.sharding``, ``dist.specs``,
    ``launch.mesh``) imports nothing of the reference (the scan above);
    a mesh defaults to the card and raises without it, before any
    process group starts; asked for, the CPU builds one."""
    import torch.distributed as dist

    from repro_torch.launch import serve_cnn
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    names = {f.relative_to(REPO).as_posix() for f in _port_files()}
    assert {"src/repro_torch/dist/sharding.py",
            "src/repro_torch/dist/specs.py",
            "src/repro_torch/launch/mesh.py"} <= names
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_mesh((1, 1), ("data", "model")),
                 lambda: make_production_mesh(),
                 lambda: make_production_mesh(multi_pod=True)):
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            call()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cnn.main(["--model", "lenet", "--mesh", "1x1"])
    assert not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    try:
        assert mesh.device_type == "cpu" and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
