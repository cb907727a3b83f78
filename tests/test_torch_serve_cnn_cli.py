"""``repro_torch.launch.serve_cnn`` (the CNN serve CLI) on the CPU.

``main`` with ``--device cpu`` at smoke scale: one model (the labels it
prints are those of an engine built by hand from the same seeds) and
``--tenants``; ``--mesh 1x1`` serves the same logits as no mesh, and a
mesh larger than the process group is refused with the mesh's error; an
unknown tenant model and a run with neither ``--model`` nor
``--tenants`` exit with an error.
"""
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.policy import PAPER_DEFAULT
from repro_torch.launch import serve_cnn
from repro_torch.models.cnn import MODELS
from repro_torch.serve.cnn import CnnServeEngine


def _labels(out):
    return [int(m) for m in re.findall(r"label=(\d+)", out)]


@pytest.mark.parametrize("model,prequant", [("resnet18", True),
                                            ("vgg16", False)])
def test_single_model_serves_and_prints_its_rate(capsys, model, prequant):
    argv = ["--model", model, "--requests", "5", "--slots", "4", "--bfp",
            "--strict-backend", "--device", "cpu"]
    serve_cnn.main(argv + (["--prequant"] if prequant else []))
    out = capsys.readouterr().out
    assert "bound plan: Plan(" in out
    assert re.search(rf"5 requests in [0-9.]+s \([0-9.]+ req/s\) "
                     rf"model={model} bfp=True prequant={prequant}", out)
    spec = MODELS[model]
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    eng = CnnServeEngine(params, spec.apply,
                         PAPER_DEFAULT.with_(straight_through=False),
                         slots=4, prequant=prequant, strict_backend=True,
                         device="cpu")
    gen = torch.Generator().manual_seed(1)
    reqs = [eng.submit(image=torch.randn(spec.input_shape(), generator=gen))
            for _ in range(5)]
    eng.run()
    assert _labels(out) == [r.label for r in reqs[:4]]


def test_tenants_serve_round_robin(capsys):
    serve_cnn.main(["--tenants", "lenet,cifarnet", "--requests", "12",
                    "--bfp", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "tenant lenet: {" in out and "tenant cifarnet: {" in out
    assert "'completed': 6" in out
    assert re.search(r"12 requests across 2 tenants in [0-9.]+s "
                     r"\([0-9.]+ req/s\) batching=continuous", out)
    assert len(_labels(out)) == 4


def test_mesh_and_bad_arguments_are_refused(capsys):
    with pytest.raises(SystemExit) as e:
        serve_cnn.main(["--model", "lenet", "--mesh", "2x1",
                        "--device", "cpu"])
    assert e.value.code == 2
    assert "has 2 devices" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="unknown tenant model"):
        serve_cnn.main(["--tenants", "lenet,nope", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve_cnn.main(["--device", "cpu"])
    assert "pass --model" in capsys.readouterr().err


def test_mesh_1x1_serves_the_logits_of_no_mesh(tmp_path, capsys):
    argv = ["--model", "lenet", "--requests", "5", "--slots", "4", "--bfp",
            "--device", "cpu", "--logits-out"]
    serve_cnn.main(argv + [str(tmp_path / "plain.npy")])
    try:
        serve_cnn.main(argv + [str(tmp_path / "mesh.npy"), "--mesh", "1x1"])
    finally:
        dist.destroy_process_group()       # the one-rank group it started
    assert "mesh=1x1" in capsys.readouterr().out
    plain = np.load(tmp_path / "plain.npy")
    assert plain.shape == (5, 10)
    assert np.array_equal(plain, np.load(tmp_path / "mesh.npy"))
