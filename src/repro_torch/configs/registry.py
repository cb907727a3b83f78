"""Architecture registry: --arch <id> -> LMConfig (counterpart of
``repro.configs.registry``)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import LMConfig, SHAPES
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma_9b
from repro_torch.configs.mistral_nemo_12b import CONFIG as _mistral_nemo_12b
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm_2b
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama_1_1b
from repro_torch.configs.qwen1_5_4b import CONFIG as _qwen1_5_4b
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6_3b
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl_2b
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral_8x7b
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe_1b_7b
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless_m4t_medium

ARCHS: Dict[str, LMConfig] = {
    c.name: c for c in [
        _recurrentgemma_9b, _mistral_nemo_12b, _minicpm_2b, _tinyllama_1_1b,
        _qwen1_5_4b, _rwkv6_3b, _qwen2_vl_2b, _mixtral_8x7b, _olmoe_1b_7b,
        _seamless_m4t_medium,
    ]
}


def get(name: str) -> LMConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cells():
    """All (arch, shape) dry-run cells with applicability filtering
    (DESIGN.md §4): long_500k only for sub-quadratic archs."""
    out = []
    for arch, cfg in ARCHS.items():
        for sname, shp in SHAPES.items():
            if sname == "long_500k" and not cfg.sub_quadratic:
                out.append((arch, sname, "skip: full quadratic attention"))
            else:
                out.append((arch, sname, None))
    return out
