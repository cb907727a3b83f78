"""The paper's three-stage NSR/SNR error-analysis model (paper §4;
counterpart of ``repro.core.nsr``).

Stage 1 — quantization (eq. 6-13): block formatting adds zero-mean noise of
variance step²/12 per block; the matrix SNR aggregates block energies.

Stage 2 — single layer (eq. 14-18): for the inner products of a GEMM with
independently quantized operands, noise-to-signal ratios ADD:

    eta_O = eta_I + eta_W            (eq. 16-17)

Stage 3 — multi-layer (eq. 19-20): with inherited NSR eta_1 from the
previous layer and fresh input-quantization NSR eta_2 measured against
(signal + inherited error):

    eta_total_input = eta_1 + eta_2 + eta_1 * eta_2

ReLU is SNR-neutral (errors distribute evenly over sign, paper §4.4);
pooling output SNR is passed through unchanged.

Plain float functions of tensors over the ``core.bfp_dot`` quantizers,
on the tensors' own device, in the mantissa convention of ``core.bfp``.
The reductions are float32 sums, so values agree with ``repro``'s to
float rounding, not bit for bit.  Every log carries the
``finfo(float32).tiny`` guard: a zero signal gives -inf dB (or a zero
noise +inf dB), never NaN.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.bfp import pow2
from repro_torch.core.bfp_dot import quantize_activations, quantize_weights
from repro_torch.core.policy import BFPPolicy

__all__ = [
    "snr_db", "nsr_from_snr_db", "snr_db_from_nsr",
    "quantization_noise_var", "predict_matrix_snr", "measure_matrix_snr",
    "matrix_nsr_upper_bound", "gemm_nsr_upper_bound",
    "grad_dx_nsr_upper_bound", "grad_dw_nsr_upper_bound",
    "single_layer_output_snr", "chain_input_nsr", "LayerSNRReport",
    "analyze_gemm_chain",
]

#: the log guard: float32's smallest normal (a smaller constant would
#: flush to 0 in float32 and a zero signal would give NaN)
_TINY = torch.finfo(torch.float32).tiny


def snr_db(signal: torch.Tensor, noisy: torch.Tensor) -> torch.Tensor:
    """Measured SNR: 10 log10(sum(signal^2) / sum((noisy-signal)^2))."""
    s = torch.sum(torch.square(signal.to(torch.float32)))
    e = torch.sum(torch.square((noisy - signal).to(torch.float32)))
    return 10.0 * torch.log10(s / torch.clamp(e, min=_TINY))


def nsr_from_snr_db(snr) -> torch.Tensor:
    return 10.0 ** (-torch.as_tensor(snr, dtype=torch.float32) / 10.0)


def snr_db_from_nsr(nsr) -> torch.Tensor:
    return -10.0 * torch.log10(
        torch.clamp(torch.as_tensor(nsr, dtype=torch.float32), min=_TINY))


def quantization_noise_var(exponent: torch.Tensor,
                           bits: int) -> torch.Tensor:
    """Per-block noise variance step^2 / 12 (paper eq. 8, our convention)."""
    step = pow2(exponent - (bits - 2))
    return torch.square(step) / 12.0


def _blocks(x2d: torch.Tensor, bits: int, operand: str, policy: BFPPolicy):
    """The operand block-formatted at ``bits``: operand "w" is [K, N]
    weights, "i" [B, K] activations — the NN orientation of
    ``bfp_dot.quantize_weights`` / ``quantize_activations``."""
    if operand == "w":
        return quantize_weights(x2d, policy.with_(l_w=bits))
    return quantize_activations(x2d, policy.with_(l_i=bits))


def _block_sizes_and_exps(x2d: torch.Tensor, bits: int, operand: str,
                          policy: BFPPolicy) -> Tuple[torch.Tensor, int]:
    """Block exponents (flattened) and elements-per-block for an operand."""
    blk = _blocks(x2d, bits, operand, policy)
    return blk.exponent.reshape(-1), x2d.numel() // blk.exponent.numel()


def predict_matrix_snr(x2d: torch.Tensor, bits: int, operand: str,
                       policy: BFPPolicy) -> torch.Tensor:
    """Theoretical SNR of a block-formatted matrix (paper eq. 9-13).

    Aggregates over blocks as eq. (13): total signal energy over total
    predicted noise energy (= sum over blocks of elems * step^2/12).
    """
    exps, elems = _block_sizes_and_exps(x2d, bits, operand, policy)
    noise_energy = torch.sum(quantization_noise_var(exps, bits)) * elems
    signal_energy = torch.sum(torch.square(x2d.to(torch.float32)))
    return 10.0 * torch.log10(signal_energy /
                              torch.clamp(noise_energy, min=_TINY))


def measure_matrix_snr(x2d: torch.Tensor, bits: int, operand: str,
                       policy: BFPPolicy) -> torch.Tensor:
    """Empirical SNR of the same block formatting (for model validation);
    every scheme incl. TILED (``BFPBlock.scale`` expands the per-tile
    exponents)."""
    return snr_db(x2d, _blocks(x2d, bits, operand, policy).dequantize())


# ---------------------------------------------------------------------------
# NSR upper bounds: where eq. 8-13 model the EXPECTED noise (step^2/12 per
# element), these are hard worst-case bounds no measurement can exceed.
# ---------------------------------------------------------------------------

def matrix_nsr_upper_bound(block_elems: int, bits: int) -> float:
    """Hard worst-case NSR of block formatting (never exceeded).

    Per element the format error is < step (round-off contributes at
    most step/2; the clipped block max loses < step), so a block of n
    elements carries noise energy < n*step^2.  Each block's signal
    energy is at least (2^eps)^2 — the defining block max satisfies
    |x_max| >= 2^eps.  With step = 2^(eps - (L-2)):

        eta_block < n * 2^(-2(L-2))

    and the matrix aggregate (total noise / total signal) cannot exceed
    the worst per-block ratio.
    """
    return float(block_elems) * 2.0 ** (-2 * (bits - 2))


def _format_noise_energy_bound(x2d: torch.Tensor, bits: int, operand: str,
                               policy: BFPPolicy) -> torch.Tensor:
    """Worst-case format noise ENERGY: sum over blocks of n * step^2."""
    exps, elems = _block_sizes_and_exps(x2d, bits, operand, policy)
    step = pow2(exps - (bits - 2))
    return torch.sum(torch.square(step)) * elems


def gemm_nsr_upper_bound(x2d: torch.Tensor, w2d: torch.Tensor,
                         policy: BFPPolicy) -> torch.Tensor:
    """Analytic upper bound on the measured output NSR of one BFP GEMM.

    The fixed-point datapath is exact on the formatted operands, so the
    output error is exactly ``E = e_x (W + e_w) + X e_w`` with
    per-operand error energies bounded from the block geometry alone
    (the :func:`matrix_nsr_upper_bound` derivation).  Frobenius
    submultiplicativity then gives

        ||E||_F <= ||e_x|| (||W|| + ||e_w||) + ||X|| ||e_w||
        eta_O   <= (that)^2 / ||X W||_F^2

    ``x2d`` is [B, K] activations, ``w2d`` [K, N] weights.
    """
    x = x2d.to(torch.float32)
    w = w2d.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    ex = torch.sqrt(_format_noise_energy_bound(x, policy.l_i, "i", policy)) \
        if policy.quantize_inputs else zero
    ew = torch.sqrt(_format_noise_energy_bound(w, policy.l_w, "w", policy)) \
        if policy.quantize_weights else zero
    nx, nw = torch.linalg.norm(x), torch.linalg.norm(w)
    e_out = ex * (nw + ew) + nx * ew
    sig = torch.sum(torch.square(x @ w))
    return torch.square(e_out) / torch.clamp(sig, min=_TINY)


def grad_dx_nsr_upper_bound(g2d: torch.Tensor, w2d: torch.Tensor,
                            policy: BFPPolicy) -> torch.Tensor:
    """Upper bound on the measured NSR of the data-gradient GEMM
    ``dL/dx = g[M, N] @ W^T[N, K]``: :func:`gemm_nsr_upper_bound` on the
    grad-side geometry.  ``g2d`` is the [M, N] incoming gradient, ``w2d``
    the FORWARD-orientation [K, N] weight, ``policy`` the policy the
    backward GEMM executes."""
    return gemm_nsr_upper_bound(g2d, w2d.transpose(-1, -2), policy)


def grad_dw_nsr_upper_bound(x2d: torch.Tensor, g2d: torch.Tensor,
                            policy: BFPPolicy) -> torch.Tensor:
    """Upper bound on the measured NSR of the weight-gradient GEMM
    ``dL/dw = x^T[K, M] @ g[M, N]``: ``x2d`` is the [M, K] forward
    activation matrix, ``g2d`` the [M, N] incoming gradient."""
    return gemm_nsr_upper_bound(x2d.transpose(-1, -2), g2d, policy)


def single_layer_output_snr(snr_i_db, snr_w_db) -> torch.Tensor:
    """Paper eq. (18): eta_O = eta_I + eta_W in SNR-dB form."""
    eta = nsr_from_snr_db(snr_i_db) + nsr_from_snr_db(snr_w_db)
    return snr_db_from_nsr(eta)


def chain_input_nsr(eta_inherited, eta_quant):
    """Paper eq. (19-20): total input NSR given inherited + fresh NSR.

    eta_quant here is measured against the CLEAN signal (our convention);
    the paper's eta_2 is against signal+inherited — the two agree to first
    order and we keep the full cross term: eta = eta_1 + eta_2 + eta_1*eta_2.
    """
    return eta_inherited + eta_quant + eta_inherited * eta_quant


@dataclasses.dataclass
class LayerSNRReport:
    """One row of the paper's Table 4."""
    name: str
    snr_input_measured: float
    snr_input_single: float      # single-layer model (fresh quantization only)
    snr_input_multi: float       # multi-layer model (with inherited error)
    snr_weight_measured: float
    snr_weight_predicted: float
    snr_output_measured: float
    snr_output_single: float
    snr_output_multi: float


def analyze_gemm_chain(
    inputs: torch.Tensor,
    weights: Sequence[torch.Tensor],
    policy: BFPPolicy,
    names: Optional[Sequence[str]] = None,
    nonlinearity=torch.relu,
) -> List[LayerSNRReport]:
    """Run a chain of GEMM+ReLU layers in float and in BFP, and compare the
    measured SNRs against the single-layer and multi-layer models.

    ``inputs`` is [B, K0]; ``weights[l]`` is [K_l, K_{l+1}].  This is the
    paper's Table-4 experiment in matrix form.
    """
    from repro_torch.core.bfp_dot import bfp_matmul_2d

    names = names or [f"gemm{l}" for l in range(len(weights))]
    x_f = inputs.to(torch.float32)   # float reference path
    x_q = inputs.to(torch.float32)   # BFP path (carries accumulated error)
    eta_multi = torch.zeros((), dtype=torch.float32,
                            device=x_f.device)  # inherited NSR (model state)
    reports: List[LayerSNRReport] = []
    for name, w in zip(names, weights):
        # --- input formatting: measured + predicted -----------------------
        x_q_fmt = quantize_activations(x_q, policy).dequantize()
        snr_in_meas = snr_db(x_f, x_q_fmt)               # vs clean signal
        snr_in_single = predict_matrix_snr(x_f, policy.l_i, "i", policy)
        eta_fresh = nsr_from_snr_db(
            predict_matrix_snr(x_q, policy.l_i, "i", policy))
        eta_in_multi = chain_input_nsr(eta_multi, eta_fresh)
        snr_in_multi = snr_db_from_nsr(eta_in_multi)

        # --- weight formatting --------------------------------------------
        snr_w_meas = measure_matrix_snr(w, policy.l_w, "w", policy)
        snr_w_pred = predict_matrix_snr(w, policy.l_w, "w", policy)

        # --- GEMM ----------------------------------------------------------
        y_f = x_f @ w
        y_q = bfp_matmul_2d(x_q, w, policy.with_(straight_through=False))
        snr_out_meas = snr_db(y_f, y_q)
        snr_out_single = single_layer_output_snr(snr_in_single, snr_w_pred)
        snr_out_multi = snr_db_from_nsr(
            eta_in_multi + nsr_from_snr_db(snr_w_pred))

        reports.append(LayerSNRReport(
            name=name,
            snr_input_measured=float(snr_in_meas),
            snr_input_single=float(snr_in_single),
            snr_input_multi=float(snr_in_multi),
            snr_weight_measured=float(snr_w_meas),
            snr_weight_predicted=float(snr_w_pred),
            snr_output_measured=float(snr_out_meas),
            snr_output_single=float(snr_out_single),
            snr_output_multi=float(snr_out_multi),
        ))

        # --- advance both paths through the nonlinearity -------------------
        x_f = nonlinearity(y_f)
        x_q = nonlinearity(y_q)
        # ReLU is SNR-neutral (paper §4.4) -> inherited NSR for next layer
        # is this layer's modeled output NSR.
        eta_multi = eta_in_multi + nsr_from_snr_db(snr_w_pred)
    return reports
