"""Fault-endurance sweep: accuracy + SNR vs bit-error rate x L x target
(counterpart of ``repro.faults.campaign``).

The paper's Tables 3/4 measured how much DESIGNED error (BFP
quantization at mantissa width L) the networks absorb; this campaign
measures the undesigned kind: seeded bit flips injected into the packed
weight containers (``repro_torch.faults.inject``) or the live activation
datapath, swept over bit-error rate, mantissa width and fault target,
for models of the CNN registry.  The shared-exponent structure orders
the damage:

  * ``exponent`` flips rescale a whole block by up to 2^128;
  * ``mantissa_msb`` flips (bit L-1) move an element by half the block's
    range;
  * ``mantissa_lsb`` flips (bit 0) move it by one quantization step,

so at equal BER the NSR obeys  exponent >> mantissa_msb >> mantissa_lsb.

"Accuracy" is top-1 AGREEMENT between the faulty model and its own
clean-BFP predictions on seeded inputs (1.0 = the faults changed no
decision), beside ``core.nsr`` logit SNR.  ``mode="exact"`` (the
default) flips exactly ``round(ber * n_bits)`` bits.  Weights and images
come from a ``torch.Generator`` seeded ``seed``, so a row is a pure
function of its arguments on the port (card and CPU alike); ``repro``'s
rows come from its own JAX init, and the two agree when fed the same
packed tree and images (``run_point(_ctx=)``).
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch import engine as EG
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import nsr as NSR
from repro_torch.core import packed as PK
from repro_torch.core.policy import TPU_TILED
from repro_torch.faults import inject as INJ
from repro_torch.models.cnn import MODELS, head_logits

__all__ = ["TARGETS", "inject_tree", "run_point", "endurance_campaign",
           "mean_nsr"]

#: Fault targets the campaign understands.  "mantissa" flips anywhere in
#: the L-bit field; the _msb/_lsb variants isolate one bit position.
TARGETS = ("exponent", "mantissa", "mantissa_msb", "mantissa_lsb",
           "activation")


def _policy(l: int):
    """Serving-mode policy at mantissa width ``l`` (whole-K tiles so
    every reduced-model K packs; inference numerics)."""
    return TPU_TILED.with_(block_k=None, straight_through=False,
                           l_w=l, l_i=l)


def inject_tree(tree: Any, target: str, ber: float, seed: int, *,
                mode: str = "exact") -> Tuple[Any, int]:
    """Inject ``target`` faults into every packed leaf of a param tree.

    ``tree`` is a ``pack_param_tree`` output (PackedBFP weight leaves,
    everything else untouched).  Each leaf gets its own sub-generator
    derived from ``(seed, crc32(leaf path))`` — the path string is
    ``repro``'s (``"['blocks'][0]['c1']['conv']['w']"``) — so the flips
    are ``repro``'s, independent of tree iteration order.  Returns
    ``(faulty tree, total flips)``.
    """
    if target not in TARGETS or target == "activation":
        raise ValueError(f"inject_tree target must be one of "
                         f"{[t for t in TARGETS if t != 'activation']}, "
                         f"got {target!r}")
    total = [0]

    def one(path, leaf):
        if not PK.is_packed(leaf):
            return leaf
        pstr = _tree.keystr(path)
        rng = INJ.derive_rng(seed, zlib.crc32(pstr.encode()))
        if target == "exponent":
            leaf2, k = INJ.flip_exponent_bits(leaf, ber, rng, mode=mode)
        else:
            bit = {"mantissa": None, "mantissa_msb": leaf.bits - 1,
                   "mantissa_lsb": 0}[target]
            leaf2, k = INJ.flip_payload_bits(leaf, ber, rng, bit=bit,
                                             mode=mode)
        total[0] += k
        return leaf2

    out = _tree.map_with_path(one, tree, is_leaf=PK.is_packed)
    return out, total[0]


def _logits(spec, tree, policy, imgs, dev) -> np.ndarray:
    """Run a (possibly packed, possibly corrupted) tree through ``apply``
    (eager, so activation faults see every site)."""
    plan = EG.bind(tree, policy, tree="cnn", device=dev)
    with torch.inference_mode():
        out = spec.apply(plan.params, imgs.to(dev), plan)
    return head_logits(out).float().cpu().numpy()


def _model_inputs(model: str, seed: int, n_images: int, reduced: bool,
                  dev: torch.device):
    spec = MODELS[model]
    gen = torch.Generator().manual_seed(seed)
    params = spec.init(gen, reduced=reduced, device=dev)
    imgs = torch.randn((n_images, *spec.input_shape(reduced=reduced)),
                       generator=gen).to(dev)
    return params, imgs


def run_point(model: str, l: int, target: str, ber: float, seed: int, *,
              n_images: int = 4, reduced: bool = True,
              mode: str = "exact", device: DeviceLike = "cuda",
              _ctx: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One campaign point: inject, run, compare against the clean-BFP
    baseline.  Returns a flat record::

        {"model", "l", "target", "ber", "n_flips",
         "top1_agree", "snr_db", "nsr", "finite"}

    ``_ctx`` (``{"imgs", "packed", "clean"}``) lets
    :func:`endurance_campaign` reuse the packed tree and clean logits
    across the BER sweep; standalone calls build them.
    """
    dev = resolve_device(device)
    spec = MODELS[model]
    policy = _policy(l)
    if _ctx is None:
        params, imgs = _model_inputs(model, seed, n_images, reduced, dev)
        packed_tree = PK.pack_param_tree(params, policy, kind="cnn")
        clean = _logits(spec, packed_tree, policy, imgs, dev)
    else:
        imgs, packed_tree, clean = (_ctx["imgs"], _ctx["packed"],
                                    _ctx["clean"])

    if target == "activation":
        with INJ.activation_faults(ber, seed, bits=l, mode=mode) as stats:
            faulty = _logits(spec, packed_tree, policy, imgs, dev)
        n_flips = stats.flips
    else:
        tree_f, n_flips = inject_tree(packed_tree, target, ber, seed,
                                      mode=mode)
        faulty = _logits(spec, tree_f, policy, imgs, dev)

    agree = float(np.mean(np.argmax(faulty, -1) == np.argmax(clean, -1)))
    finite = bool(np.all(np.isfinite(faulty)))
    snr = (float(NSR.snr_db(torch.from_numpy(clean),
                            torch.from_numpy(faulty)))
           if finite else float("-inf"))
    return {"model": model, "l": l, "target": target, "ber": ber,
            "n_flips": int(n_flips), "top1_agree": agree,
            "snr_db": snr, "nsr": 10.0 ** (-snr / 10.0),
            "finite": finite}


def endurance_campaign(models: Iterable[str] = ("lenet",),
                       l_values: Sequence[int] = (8,),
                       bers: Sequence[float] = (1e-3, 1e-2),
                       targets: Sequence[str] = ("exponent",
                                                 "mantissa_msb",
                                                 "mantissa_lsb"),
                       *, seed: int = 0, n_images: int = 4,
                       reduced: bool = True, mode: str = "exact",
                       device: DeviceLike = "cuda") -> List[Dict[str, Any]]:
    """Sweep BER x L x target across ``models`` (registry names).

    For each (model, L) the packed tree and clean-baseline logits are
    built once and shared by every (target, ber) cell.  Returns the flat
    list of :func:`run_point` records, in deterministic sweep order.
    """
    for t in targets:
        if t not in TARGETS:
            raise ValueError(f"unknown fault target {t!r}; "
                             f"choose from {TARGETS}")
    dev = resolve_device(device)
    rows: List[Dict[str, Any]] = []
    for model in models:
        spec = MODELS[model]
        params, imgs = _model_inputs(model, seed, n_images, reduced, dev)
        for l in l_values:
            policy = _policy(l)
            packed_tree = PK.pack_param_tree(params, policy, kind="cnn")
            ctx = {"imgs": imgs, "packed": packed_tree,
                   "clean": _logits(spec, packed_tree, policy, imgs, dev)}
            for target in targets:
                for ber in bers:
                    rows.append(run_point(model, l, target, ber, seed,
                                          n_images=n_images,
                                          reduced=reduced, mode=mode,
                                          device=dev, _ctx=ctx))
    return rows


def mean_nsr(rows: Iterable[Dict[str, Any]], **match: Any) -> float:
    """Mean NSR over the rows whose fields equal ``match`` (non-finite
    rows count as NSR=inf — a crashed network is maximally noisy)."""
    vals = [float("inf") if not r.get("finite", True) else r["nsr"]
            for r in rows
            if all(r.get(k) == v for k, v in match.items())]
    if not vals:
        raise ValueError(f"no campaign rows match {match!r}")
    return float(np.mean(vals))
