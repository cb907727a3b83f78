"""Fault injection and endurance campaigns for the BFP datapath
(counterpart of ``repro.faults``).

``repro_torch.faults.inject`` holds the seeded injectors (packed-container
mantissa/exponent bit flips, serialized-byte corruption, taps-driven
activation perturbation); ``repro_torch.faults.campaign`` sweeps them
over bit-error rate x mantissa width x target and reads out top-1
agreement and logit SNR.
"""
from repro_torch.faults.campaign import (TARGETS, endurance_campaign,
                                         inject_tree, mean_nsr, run_point)
from repro_torch.faults.inject import (FaultStats, activation_faults,
                                       corrupt_container_bytes, derive_rng,
                                       flip_exponent_bits, flip_payload_bits,
                                       perturb_activations)

__all__ = [
    "FaultStats", "activation_faults", "corrupt_container_bytes",
    "derive_rng", "flip_exponent_bits", "flip_payload_bits",
    "perturb_activations",
    "TARGETS", "endurance_campaign", "inject_tree", "mean_nsr",
    "run_point",
]
