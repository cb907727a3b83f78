"""Paper Table 4 — per-layer SNR validation over the REAL datapath
(counterpart of ``repro.models.cnn.analysis``).

:func:`analyze_model` runs any model twice — float reference and BFP —
with ``engine.taps`` observing every GEMM/conv site the engine actually
executes, then compares measured input/weight/output SNRs against the
paper's single-layer (eq. 18) and multi-layer (eq. 19-20) analytical
models.  Because the sites come from taps rather than a hand-rolled
walker, this traverses any topology the engine runs: sequential VGG,
ResNet residual blocks (projection shortcuts included), GoogLeNet
inception branches and aux heads.

Two inheritance modes for the multi-layer model's eta_1 (inherited NSR):

  * ``"analytic"``  — chain predictions site-by-site in execution order
    (eq. 19-20 exactly as the paper applies it to a sequential CNN;
    :func:`analyze_vgg` uses this);
  * ``"measured"``  — measure eta_1 directly at each site's input from
    the dual runs, which generalizes eq. 19-20 to branch/merge
    topologies where "the previous layer" is ill-defined.

Both runs go through the per-call engine on the device the params and
``x`` live on: a kernel-backend policy runs the CUDA kernels on a card
(their plain versions on the CPU), the paper's EQ4 policy the emulated
datapath.  ReLU and pooling are traversed as the model traverses them:
ReLU is SNR-neutral (checked per row), pooling feeds the next site.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch

from repro_torch import engine as EG
from repro_torch.core import nsr
from repro_torch.core.bfp_dot import quantize_activations
from repro_torch.core.conv_utils import conv_weight_matrix, im2col
from repro_torch.core.policy import BFPPolicy
from repro_torch.engine import PolicyMap
from repro_torch.models.cnn import vgg

__all__ = ["LayerRow", "SiteRow", "analyze_model", "analyze_vgg"]


@dataclasses.dataclass
class SiteRow:
    """One engine site's row of the paper's Table 4 (SNRs in dB)."""
    path: str
    kind: str             # "gemm" | "conv"
    input_ex: float       # experimental input SNR
    input_single: float   # single-layer model
    input_multi: float    # multi-layer model
    weight_ex: float
    weight_model: float
    output_ex: float
    output_single: float
    output_multi: float
    relu_ex: float        # SNR after ReLU (paper: ~= output SNR)


@dataclasses.dataclass
class LayerRow:
    """Legacy row shape kept for the VGG analysis' consumers."""
    name: str
    input_ex: float
    input_single: float
    input_multi: float
    weight_ex: float
    weight_model: float
    output_ex: float
    output_single: float
    output_multi: float
    relu_ex: float


def _no_ste(policy):
    """The analysis measures the inference datapath: no STE grads."""
    if isinstance(policy, BFPPolicy):
        return policy.with_(straight_through=False)
    if isinstance(policy, PolicyMap):
        off = lambda p: None if p is None else p.with_(  # noqa: E731
            straight_through=False)
        return PolicyMap(
            rules=tuple((pat, off(p)) for pat, p in policy.rules),
            default=off(policy.default))
    return policy


def _site_matrices(ev: EG.TapEvent):
    """A tapped site in GEMM view: (x2d [rows, K], w [K, N]).

    Conv sites are lowered with the SAME im2col/weight-matrix helpers
    the engine's im2col route uses, so the matrices are bit-identical
    to what the datapath multiplied.
    """
    w = ev.w
    if EG.is_prequant(w):
        raise ValueError(
            "analyze_model needs float weights (the weight-SNR rows "
            "compare quantized vs unquantized); pass the original param "
            "tree, not plan.params / a prequantized tree")
    if ev.kind == "conv":
        kh, kw, _, _ = w.shape
        cols, _ = im2col(ev.x, kh, kw, ev.stride, ev.padding)
        return cols, conv_weight_matrix(w)
    return ev.x.reshape(-1, ev.x.shape[-1]), w


def analyze_model(apply_fn: Callable[[Any, torch.Tensor, Any], Any],
                  params: Any, x: torch.Tensor, policy,
                  *, inheritance: str = "measured",
                  max_sites: Optional[int] = None,
                  bias_fn: Optional[Callable[[str],
                                             Optional[torch.Tensor]]] = None
                  ) -> List[SiteRow]:
    """Dual-run (float / BFP) tap analysis of ``apply_fn``'s datapath.

    ``apply_fn(params, x, policy)`` must execute the model through the
    engine (every in-repo model does); its return value is ignored —
    the engine taps supply the per-site operands.  ``policy`` is a
    BFPPolicy (uniform) or PolicyMap (sites a rule pins to float are
    skipped: there is no quantization to analyze there).  Rows appear
    in execution order.

    ``inheritance`` picks the multi-layer model's eta_1 source:
    "analytic" chains predictions in execution order (sequential
    models, the paper's Table-4 procedure), "measured" reads the
    carried error off the dual runs (any topology).

    Taps fire inside the engine, BEFORE the layer adds its bias, so by
    default output/ReLU SNRs are measured on pre-bias activations.  For
    trained models pass ``bias_fn(path) -> b`` (or None for pre-bias
    sites) and the paper's exact procedure — ``snr(y_f + b, y_q + b)``,
    ReLU on the real activations — is restored; :func:`analyze_vgg` does
    this automatically.  Both runs execute under ``torch.no_grad()``.
    """
    if inheritance not in ("analytic", "measured"):
        raise ValueError(f"inheritance must be 'analytic' or 'measured', "
                         f"got {inheritance!r}")
    policy = _no_ste(policy)
    ev_f: List[EG.TapEvent] = []
    ev_q: List[EG.TapEvent] = []
    with torch.no_grad():
        with EG.taps(ev_f.append):
            apply_fn(params, x, None)
        with EG.taps(ev_q.append):
            apply_fn(params, x, policy)
    if len(ev_f) != len(ev_q):
        raise RuntimeError(
            f"float/BFP runs executed different site counts "
            f"({len(ev_f)} vs {len(ev_q)}) — apply_fn must traverse the "
            f"same sites for both policies")

    rows: List[SiteRow] = []
    eta_multi = 0.0  # analytic mode: inherited NSR chained across sites
    for f, q in zip(ev_f, ev_q):
        if f.path != q.path:
            raise RuntimeError(f"site order diverged: {f.path} vs {q.path}")
        pol = q.policy
        if pol is None:
            continue  # float-pinned site: nothing to analyze
        if max_sites is not None and len(rows) >= max_sites:
            break
        cols_f, wmat = _site_matrices(f)
        cols_q, _ = _site_matrices(q)

        # --- input SNRs: measured + single/multi-layer models -------------
        in_fmt = quantize_activations(cols_q, pol).dequantize()
        input_ex = float(nsr.snr_db(cols_f, in_fmt))
        input_single = float(nsr.predict_matrix_snr(cols_f, pol.l_i, "i",
                                                    pol))
        eta_fresh = float(nsr.nsr_from_snr_db(
            nsr.predict_matrix_snr(cols_q, pol.l_i, "i", pol)))
        eta_inherited = (eta_multi if inheritance == "analytic" else
                         float(nsr.nsr_from_snr_db(
                             nsr.snr_db(cols_f, cols_q))))
        eta_in_multi = float(nsr.chain_input_nsr(eta_inherited, eta_fresh))
        input_multi = float(nsr.snr_db_from_nsr(eta_in_multi))

        # --- weight SNRs ---------------------------------------------------
        weight_ex = float(nsr.measure_matrix_snr(wmat, pol.l_w, "w", pol))
        weight_model = float(nsr.predict_matrix_snr(wmat, pol.l_w, "w",
                                                    pol))
        eta_w = float(nsr.nsr_from_snr_db(weight_model))

        # --- outputs: the datapath's own y vs the float run's ------------
        b = bias_fn(f.path) if bias_fn is not None else None
        y_f = f.y if b is None else f.y + b
        y_q = q.y if b is None else q.y + b
        output_ex = float(nsr.snr_db(y_f, y_q))
        output_single = float(nsr.single_layer_output_snr(input_single,
                                                          weight_model))
        eta_out_multi = eta_in_multi + eta_w
        output_multi = float(nsr.snr_db_from_nsr(eta_out_multi))

        # --- ReLU (paper §4.4: SNR-neutral check) --------------------------
        relu_ex = float(nsr.snr_db(torch.relu(y_f), torch.relu(y_q)))

        rows.append(SiteRow(f.path or "?", f.kind, input_ex, input_single,
                            input_multi, weight_ex, weight_model, output_ex,
                            output_single, output_multi, relu_ex))
        eta_multi = eta_out_multi
    return rows


def analyze_vgg(params, x: torch.Tensor, policy: BFPPolicy,
                max_layers: Optional[int] = None) -> List[LayerRow]:
    """The Table-4 VGG analysis, as a thin wrapper over
    :func:`analyze_model` (analytic inheritance, conv rows only, biases
    restored per site)."""
    # VGG's conv sites strictly precede its fc sites, so max_sites=
    # max_layers truncates the per-site analysis exactly there (the
    # forward itself still runs in full)
    rows = [r for r in analyze_model(
                vgg.apply, params, x, policy, inheritance="analytic",
                max_sites=max_layers,
                bias_fn=lambda p: params[p]["b"] if p in params else None)
            if r.kind == "conv"]
    return [LayerRow(r.path, r.input_ex, r.input_single, r.input_multi,
                     r.weight_ex, r.weight_model, r.output_ex,
                     r.output_single, r.output_multi, r.relu_ex)
            for r in rows]
