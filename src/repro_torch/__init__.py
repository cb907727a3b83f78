"""PyTorch/CUDA port of the BFP CNN accelerator datapath.

Mirrors :mod:`repro` module for module (``repro_torch.engine.plan`` is
the counterpart of ``repro.engine.plan``); the JAX package stays the
reference every ported function is tested against.  Activations are
NHWC, conv weights HWIO, prequantized weights ``{"m", "s"}`` dicts — the
same layouts as ``repro``, so the two packages compare like with like.

Entry points that create or place tensors take ``device=`` and default
to ``"cuda"``; the CPU is used only when a caller asks for it.  Every
BFP conv and GEMM on a CUDA tensor runs a hand-written Hopper kernel
(``repro_torch.kernels``); on a CPU tensor it runs the kernel's plain
PyTorch version.
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
