"""GoogLeNet (Szegedy et al. 2015) with the three classifier heads the
paper reports (loss1/loss2/loss3 columns of its Table 3); counterpart of
``repro.models.cnn.googlenet``.  Inception branch convs (1x1 / 3x3 / 5x5,
mixed per-branch shapes) all route through ``engine.conv2d``.  The
auxiliary heads' ``fc1_in``/``mid`` entries are Python ints, carried
through conversion and binding unchanged."""
from __future__ import annotations

import torch

from repro_torch._device import DeviceLike
from repro_torch.engine import PolicyLike, join_path
from repro_torch.models.cnn import layers as L

__all__ = ["init", "apply"]

# (name, out_1x1, red_3x3, out_3x3, red_5x5, out_5x5, pool_proj)
_INCEPTION = [
    ("3a", 64, 96, 128, 16, 32, 32),
    ("3b", 128, 128, 192, 32, 96, 64),
    ("pool", 0, 0, 0, 0, 0, 0),
    ("4a", 192, 96, 208, 16, 48, 64),
    ("4b", 160, 112, 224, 24, 64, 64),
    ("4c", 128, 128, 256, 24, 64, 64),
    ("4d", 112, 144, 288, 32, 64, 64),
    ("4e", 256, 160, 320, 32, 128, 128),
    ("pool", 0, 0, 0, 0, 0, 0),
    ("5a", 256, 160, 320, 32, 128, 128),
    ("5b", 384, 192, 384, 48, 128, 128),
]
_AUX_AFTER = {"4a": "loss1", "4d": "loss2"}


def _inception_init(gen, in_ch, cfg, width_mult, device):
    _, o1, r3, o3, r5, o5, pp = cfg

    def scale(c):
        return max(4, int(c * width_mult))

    return {
        "b1": L.conv2d_init(gen, in_ch, scale(o1), 1, 1, device),
        "b3r": L.conv2d_init(gen, in_ch, scale(r3), 1, 1, device),
        "b3": L.conv2d_init(gen, scale(r3), scale(o3), 3, 3, device),
        "b5r": L.conv2d_init(gen, in_ch, scale(r5), 1, 1, device),
        "b5": L.conv2d_init(gen, scale(r5), scale(o5), 5, 5, device),
        "bp": L.conv2d_init(gen, in_ch, scale(pp), 1, 1, device),
    }, scale(o1) + scale(o3) + scale(o5) + scale(pp)


def _inception(p, x, policy, path=None):
    def cv(name, inp):
        return L.relu(L.conv2d(p[name], inp, 1, "SAME", policy,
                               path=join_path(path, name)))

    b1 = cv("b1", x)
    b3 = cv("b3", cv("b3r", x))
    b5 = cv("b5", cv("b5r", x))
    bp = cv("bp", L.max_pool(x, 3, 1, "SAME"))
    return torch.cat([b1, b3, b5, bp], dim=-1)


def _aux_init(gen, in_ch, num_classes, width_mult, device):
    mid = max(16, int(128 * width_mult))
    fc = max(32, int(1024 * width_mult))
    return {"conv": L.conv2d_init(gen, in_ch, mid, 1, 1, device),
            "fc1_in": mid * 16, "mid": mid,
            "fc1": L.dense_init(gen, mid * 16, fc, device),
            "fc2": L.dense_init(gen, fc, num_classes, device)}


def _aux(p, x, policy, path=None):
    h = x.shape[1]                       # adaptive 4x4 average pool
    x = L.avg_pool(x, h // 4, h // 4) if h >= 4 else x
    x = L.relu(L.conv2d(p["conv"], x, 1, "SAME", policy,
                        path=join_path(path, "conv")))
    x = x.reshape(x.shape[0], -1)[:, :p["fc1_in"]]
    x = L.relu(L.dense(p["fc1"], x, policy, path=join_path(path, "fc1")))
    return L.dense(p["fc2"], x, policy, path=join_path(path, "fc2"))


def init(gen: torch.Generator, num_classes: int = 1000, in_ch: int = 3,
         width_mult: float = 1.0, device: DeviceLike = "cuda"):
    """He-initialized GoogLeNet params drawn from ``gen`` on ``device``."""
    def scale(c):
        return max(8, int(c * width_mult))

    params = {"stem1": L.conv2d_init(gen, in_ch, scale(64), 7, 7, device),
              "stem2r": L.conv2d_init(gen, scale(64), scale(64), 1, 1,
                                      device),
              "stem2": L.conv2d_init(gen, scale(64), scale(192), 3, 3,
                                     device)}
    ch = scale(192)
    for cfg in _INCEPTION:
        if cfg[0] == "pool":
            continue
        params[f"inc{cfg[0]}"], ch_out = _inception_init(gen, ch, cfg,
                                                         width_mult, device)
        if cfg[0] in _AUX_AFTER:
            params[_AUX_AFTER[cfg[0]]] = _aux_init(gen, ch_out, num_classes,
                                                   width_mult, device)
        ch = ch_out
    params["fc"] = L.dense_init(gen, ch, num_classes, device)
    return params


def apply(params, x: torch.Tensor, policy: PolicyLike = None,
          with_aux: bool = True):
    """Returns (loss3_logits, loss1_logits, loss2_logits) — the paper's
    three GoogLeNet columns; serving takes head 0 (``head_logits``).
    Layer paths: "stem1|stem2r|stem2", "inc<name>/b1|b3r|b3|b5r|b5|bp",
    "loss1|loss2/conv|fc1|fc2", "fc"."""
    x = L.relu(L.conv2d(params["stem1"], x, 2, "SAME", policy,
                        path="stem1"))
    x = L.max_pool(x, 3, 2, "SAME")
    x = L.relu(L.conv2d(params["stem2r"], x, 1, "SAME", policy,
                        path="stem2r"))
    x = L.relu(L.conv2d(params["stem2"], x, 1, "SAME", policy,
                        path="stem2"))
    x = L.max_pool(x, 3, 2, "SAME")
    aux1 = aux2 = None
    for cfg in _INCEPTION:
        if cfg[0] == "pool":
            x = L.max_pool(x, 3, 2, "SAME")
            continue
        x = _inception(params[f"inc{cfg[0]}"], x, policy,
                       path=f"inc{cfg[0]}")
        if with_aux and cfg[0] in _AUX_AFTER:
            a = _aux(params[_AUX_AFTER[cfg[0]]], x, policy,
                     path=_AUX_AFTER[cfg[0]])
            if cfg[0] == "4a":
                aux1 = a
            else:
                aux2 = a
    x = L.global_avg_pool(x)
    main = L.dense(params["fc"], x, policy, path="fc")
    return (main, aux1, aux2) if with_aux else main
